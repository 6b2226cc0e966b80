"""Metrics sink of a run directory (port of
ddsp_pytorch_tpu/training/metrics.py:19-86): an append-only
`metrics.jsonl`, one {"tag", "value", "step", "time"} record per scalar;
audio as 16-bit wavs under `audio/` and figures as PNGs under `figures/`,
named <tag>_<step> with "/" in the tag as "_".

With use_tensorboard (the default, as in the JAX writer) every scalar,
wav and figure is mirrored to a `torch.utils.tensorboard.SummaryWriter`
in the run directory where that imports; where it does not (no
`tensorboard` package), the sink is off and the files above are all the
run writes.  It is an optional logging sink only: nothing else depends
on it."""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch

from ddsp_pytorch_tpu_torch.utils.audio_io import save_wav


def _file_stem(tag: str, step: int) -> str:
    return f"{tag.replace('/', '_')}_{int(step)}"


class MetricsWriter:
    def __init__(self, run_dir: str, use_tensorboard: bool = True, enabled: bool = True):
        """enabled=False makes every write a no-op: the ranks of a process
        mesh other than rank 0 share its run directory (metrics.py:19-40)."""
        self.run_dir = run_dir
        self.enabled = enabled
        self._summary_writer = self._tb = None
        os.makedirs(run_dir, exist_ok=True)
        self._jsonl = open(os.path.join(run_dir, "metrics.jsonl"), "a") if enabled else None
        if enabled and use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:  # no tensorboard package: the sink is off
                SummaryWriter = None
            self._summary_writer = SummaryWriter
            self._board()

    @property
    def tensorboard(self) -> bool:
        """Whether scalars, audio and figures are mirrored to TensorBoard."""
        return self._summary_writer is not None

    def _board(self):
        """The open SummaryWriter (a new event file after `end_tensorboard`),
        or None with the sink off."""
        if self._tb is None and self._summary_writer is not None:
            self._tb = self._summary_writer(self.run_dir, flush_secs=20)
        return self._tb

    def end_tensorboard(self) -> None:
        """Flush and close the SummaryWriter, ending its writer thread; a
        later write opens a new event file in the run directory."""
        if self._tb is not None:
            self._tb.close()
            self._tb = None

    def add_scalar(self, tag: str, value, step: int) -> None:
        if not self.enabled:
            return
        value = float(value)
        record = {"tag": tag, "value": value, "step": int(step), "time": time.time()}
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()
        if self.tensorboard:
            self._board().add_scalar(tag, value, int(step))

    def add_audio(self, tag: str, audio, step: int, sample_rate: int) -> Optional[str]:
        """Write mono audio (an array or a tensor on any device) as
        audio/<tag>_<step>.wav; returns its path (None when disabled)."""
        if not self.enabled:
            return None
        if isinstance(audio, torch.Tensor):
            audio = audio.detach().to("cpu", torch.float32).numpy()
        wav_dir = os.path.join(self.run_dir, "audio")
        os.makedirs(wav_dir, exist_ok=True)
        path = os.path.join(wav_dir, _file_stem(tag, step) + ".wav")
        audio = np.asarray(audio, np.float32).reshape(-1)
        save_wav(path, audio, sample_rate)
        if self.tensorboard:
            self._board().add_audio(tag, audio[None, :], int(step), sample_rate=sample_rate)
        return path

    def add_figure(self, tag: str, fig, step: int) -> Optional[str]:
        """Save a matplotlib figure as figures/<tag>_<step>.png; returns its
        path (None when disabled)."""
        if not self.enabled:
            return None
        fig_dir = os.path.join(self.run_dir, "figures")
        os.makedirs(fig_dir, exist_ok=True)
        path = os.path.join(fig_dir, _file_stem(tag, step) + ".png")
        fig.savefig(path, dpi=100)
        if self.tensorboard:
            self._board().add_figure(tag, fig, int(step))
        return path

    def close(self) -> None:
        """Close metrics.jsonl and the TensorBoard writer (its flush thread
        ends); idempotent."""
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
        self.end_tensorboard()


def read_metrics(run_dir: str, tag: str):
    """[(step, value)] of every `tag` record in run_dir/metrics.jsonl."""
    out = []
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if rec["tag"] == tag:
                out.append((rec["step"], rec["value"]))
    return out
