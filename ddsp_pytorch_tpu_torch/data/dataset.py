"""Cached feature dataset and loaders.

Port of ddsp_pytorch_tpu/data/dataset.py:20-299 on one host: the Dataset
over memory-mapped `.npy` arrays (signals, pitchs, loudness, and the mfccs
the autoencoder reads where the cache has them), a dict collate, a
DataLoader whose per-epoch shuffle is a function of (seed, epoch) — the
same numpy generator as the JAX loader, so the two give the same order —
the DeviceDataLoader, which uploads the whole cache once and gathers
batches on the device in that same order, and the train/validation
Datamodule.  The DataLoader's batches are numpy, which
the Trainer moves to its device; the DeviceDataLoader's are tensors on its
device.  Under a mesh across processes each loader yields its process's
interleaved shard of every global batch (`num_shards`, `shard_index`,
dataset.py:257-298).

A model that trains on raw crops (RAVE v1, whose `needs_features` is
False) reads the signals alone: its Dataset (`features=False`) holds no
pitch, loudness or MFCCs, its items and device cache are {sig}, and it has
no loudness statistics.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ddsp_pytorch_tpu_torch import resolve_device
from ddsp_pytorch_tpu_torch.ops.core import batch_loudness_stats, running_mean_stats


class Dataset:
    """Feature cache written by preprocessing or the synthetic corpus, of
    this package or the JAX package
    (`<out_dir>/{signals,pitchs,loudness[,mfccs]}.npy`).  Items carry
    `mfcc` where the cache has mfccs.npy (dataset.py:28-45).  With
    `features=False` only signals.npy is read, and items are {sig}."""

    def __init__(self, out_dir, features: bool = True):
        out_dir = Path(out_dir)
        self.signals = np.load(out_dir / "signals.npy", mmap_mode="r")
        self.pitchs = self.loudness = self.mfccs = None
        if features:
            self.pitchs = np.load(out_dir / "pitchs.npy", mmap_mode="r")
            self.loudness = np.load(out_dir / "loudness.npy", mmap_mode="r")
            mfcc_path = out_dir / "mfccs.npy"
            self.mfccs = np.load(mfcc_path, mmap_mode="r") if mfcc_path.exists() else None

    def __len__(self) -> int:
        return self.signals.shape[0]

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        item = {"sig": np.asarray(self.signals[idx], np.float32)}
        if self.pitchs is not None:
            item["pitch"] = np.asarray(self.pitchs[idx], np.float32)[:, None]
            item["loudness"] = np.asarray(self.loudness[idx], np.float32)[:, None]
        if self.mfccs is not None:
            # the cache holds F + 1 frames (a centered STFT); the model takes F
            item["mfcc"] = np.asarray(self.mfccs[idx], np.float32)[:-1]
        return item


def dict_collate(records) -> Dict[str, np.ndarray]:
    """Stack a list of feature dicts into a dict of batched arrays."""
    return {k: np.stack([r[k] for r in records]) for k in records[0]}


class DataLoader:
    """Deterministic batch loader: the shuffle order is a function of
    (seed, epoch).  Call `set_epoch(e)` before iterating epoch e (the
    Trainer does), which makes resume exact.

    `batch_size` is the per-shard batch.  With num_shards > 1 (one shard a
    process along the mesh's data axis) every shard derives the same global
    order and takes its interleaved slice, cut to the shards' common length
    so that they stay in step (dataset.py:60-108)."""

    def __init__(
        self,
        dataset: Dataset,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = False,
        seed: int = 0,
        num_shards: int = 1,
        shard_index: int = 0,
    ):
        if not 0 <= shard_index < num_shards:
            raise ValueError(f"shard_index {shard_index} not in [0, {num_shards})")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _shard_order(self) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((self.seed, self.epoch)).shuffle(order)
        if self.num_shards > 1:
            per = len(order) // self.num_shards
            order = order[self.shard_index :: self.num_shards][:per]
        return order

    def index_batches(self) -> Iterator[np.ndarray]:
        """This epoch's per-batch item indices, in iteration order."""
        order = self._shard_order()
        n = len(order)
        end = (n // self.batch_size) * self.batch_size if self.drop_last else n
        for start in range(0, end, self.batch_size):
            yield order[start : start + self.batch_size]

    def __len__(self) -> int:
        n = len(self._shard_order())
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for idx in self.index_batches():
            yield dict_collate([self.dataset[int(i)] for i in idx])


class DeviceDataLoader(DataLoader):
    """The whole feature cache on `device`, uploaded once; batches are
    gathered there by index (dataset.py:115-236).

    Same (seed, epoch) order as the DataLoader.  `index_batches()` gives
    each batch's indices (numpy), `take(idx)` the (B, ...) batch and
    `take_stacked(idx2d)` an (n, B, ...) super-batch, each one gather per
    array; `device_data` is the cache itself ({sig (N, T), pitch (N, F, 1),
    loudness (N, F, 1)}, and mfcc (N, F, n_mfcc) where the cache has it,
    its last frame dropped once, at upload; {sig} alone for a Dataset of
    crops), which the captured multi-step gathers from inside its graph.
    Iterating yields `take` of each batch."""

    def __init__(self, dataset: Dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0, device="cuda", num_shards: int = 1,
                 shard_index: int = 0):
        super().__init__(dataset, batch_size, shuffle, drop_last, seed, num_shards, shard_index)
        self.device = resolve_device(device)
        # one upload per array; trailing feature axes added like __getitem__
        self._data = {"sig": torch.from_numpy(np.array(dataset.signals, np.float32)).to(self.device)}
        if dataset.pitchs is not None:
            self._data["pitch"] = torch.from_numpy(np.array(dataset.pitchs, np.float32))[..., None].to(self.device)
            self._data["loudness"] = torch.from_numpy(np.array(dataset.loudness, np.float32))[..., None].to(
                self.device)
        if dataset.mfccs is not None:
            self._data["mfcc"] = torch.from_numpy(np.array(dataset.mfccs[:, :-1], np.float32)).to(self.device)

    @property
    def device_data(self) -> Dict[str, torch.Tensor]:
        return self._data

    def _index(self, idx) -> torch.Tensor:
        return torch.as_tensor(np.asarray(idx, np.int64)).to(self.device)

    def take(self, idx) -> Dict[str, torch.Tensor]:
        """The batch of items `idx` (B,)."""
        idx = self._index(idx)
        return {k: v.index_select(0, idx) for k, v in self._data.items()}

    def take_stacked(self, idx2d) -> Dict[str, torch.Tensor]:
        """The (n, B, ...) super-batch of items `idx2d` (n, B)."""
        idx = self._index(idx2d)
        return {k: v[idx] for k, v in self._data.items()}

    def loudness_stats(self) -> tuple:
        """(mean, std) equal bit for bit to ops.mean_std_loudness over this
        loader's batches, as the host DataLoader gives them: the loudness
        (N·F floats) comes to the host once, and each batch's float32 stats
        are taken there, as for a host batch (a device's reductions round
        differently), then the same host-float running mean."""
        loud = self._data["loudness"].cpu()
        return running_mean_stats(
            batch_loudness_stats(loud[torch.as_tensor(idx)]).tolist() for idx in self.index_batches()
        )

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        for idx in self.index_batches():
            yield self.take(idx)


class Datamodule:
    """Train/validation loader pair from a Config: `<out_dir>/train` and
    `<out_dir>/validation` (dataset.py:239-299).  `device_cache=True` makes
    the train loader a DeviceDataLoader on `device`; validation stays on
    the host loader, as in the JAX package.  Under a mesh across processes
    (parallel/mesh.py) config.train.batch is the global batch and each
    loader yields this process's interleaved shard of it, sharded along the
    data axis (the time ranks of one data shard load the same rows).
    `features=False` reads the crops alone (the model's `needs_features`)."""

    def __init__(self, config, device_cache: bool = False, device="cuda", mesh=None, features: bool = True):
        self.config = config
        self.features = features
        self.device_cache = device_cache
        self.device = device
        self.train_data: Optional[Dataset] = None
        self.val_data: Optional[Dataset] = None
        if mesh is None or mesh.in_process:
            self._shards = {"num_shards": 1, "shard_index": 0}
        else:
            self._shards = {"num_shards": mesh.data, "shard_index": mesh.data_index}
        self._batch = max(1, config.train.batch // self._shards["num_shards"])

    def setup(self) -> None:
        out_dir = Path(self.config.preprocess.out_dir)
        self.train_data = Dataset(out_dir / "train", self.features)
        self.val_data = Dataset(out_dir / "validation", self.features)

    def train_dataloader(self) -> DataLoader:
        if self.device_cache:
            return DeviceDataLoader(
                self.train_data,
                batch_size=self._batch,
                shuffle=True,
                drop_last=True,
                seed=self.config.train.seed,
                device=self.device,
                **self._shards,
            )
        return DataLoader(
            self.train_data,
            batch_size=self._batch,
            shuffle=True,
            drop_last=True,
            seed=self.config.train.seed,
            **self._shards,
        )

    def val_dataloader(self) -> DataLoader:
        return DataLoader(self.val_data, batch_size=self._batch, shuffle=False, **self._shards)
