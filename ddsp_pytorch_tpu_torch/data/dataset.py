"""Cached feature dataset and loaders.

Port of ddsp_pytorch_tpu/data/dataset.py:20-112 and :239-299: the Dataset
over memory-mapped `.npy` arrays (signals, pitchs, loudness; the mfccs the
autoencoder reads wait with it), a dict collate, a DataLoader whose per-epoch shuffle is a function
of (seed, epoch) — the same numpy generator as the JAX loader, so the two
give the same order — and the train/validation Datamodule.  Batches are
numpy; the Trainer moves them to its device.  The device-resident loader
and the multi-host shards wait (ROADMAP.md).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np


class Dataset:
    """Feature cache written by the JAX package's preprocessing
    (`<out_dir>/{signals,pitchs,loudness[,mfccs]}.npy`)."""

    def __init__(self, out_dir):
        out_dir = Path(out_dir)
        self.signals = np.load(out_dir / "signals.npy", mmap_mode="r")
        self.pitchs = np.load(out_dir / "pitchs.npy", mmap_mode="r")
        self.loudness = np.load(out_dir / "loudness.npy", mmap_mode="r")

    def __len__(self) -> int:
        return self.signals.shape[0]

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        return {
            "sig": np.asarray(self.signals[idx], np.float32),
            "pitch": np.asarray(self.pitchs[idx], np.float32)[:, None],
            "loudness": np.asarray(self.loudness[idx], np.float32)[:, None],
        }


def dict_collate(records) -> Dict[str, np.ndarray]:
    """Stack a list of feature dicts into a dict of batched arrays."""
    return {k: np.stack([r[k] for r in records]) for k in records[0]}


class DataLoader:
    """Deterministic batch loader: the shuffle order is a function of
    (seed, epoch).  Call `set_epoch(e)` before iterating epoch e (the
    Trainer does), which makes resume exact."""

    def __init__(
        self,
        dataset: Dataset,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = False,
        seed: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _order(self) -> np.ndarray:
        """This epoch's item order."""
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((self.seed, self.epoch)).shuffle(order)
        return order

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = self._order()
        n = len(order)
        end = (n // self.batch_size) * self.batch_size if self.drop_last else n
        for start in range(0, end, self.batch_size):
            idx = order[start : start + self.batch_size]
            yield dict_collate([self.dataset[int(i)] for i in idx])


class Datamodule:
    """Train/validation loader pair from a Config: `<out_dir>/train` and
    `<out_dir>/validation` (dataset.py:239-299, one device)."""

    def __init__(self, config):
        self.config = config
        self.train_data: Optional[Dataset] = None
        self.val_data: Optional[Dataset] = None

    def setup(self) -> None:
        out_dir = Path(self.config.preprocess.out_dir)
        self.train_data = Dataset(out_dir / "train")
        self.val_data = Dataset(out_dir / "validation")

    def train_dataloader(self) -> DataLoader:
        return DataLoader(
            self.train_data,
            batch_size=self.config.train.batch,
            shuffle=True,
            drop_last=True,
            seed=self.config.train.seed,
        )

    def val_dataloader(self) -> DataLoader:
        return DataLoader(self.val_data, batch_size=self.config.train.batch, shuffle=False)
