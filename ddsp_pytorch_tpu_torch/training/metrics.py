"""Metrics sink of a run directory (port of
ddsp_pytorch_tpu/training/metrics.py:19-86 without its TensorBoard sink):
an append-only `metrics.jsonl`, one {"tag", "value", "step", "time"}
record per scalar; audio as 16-bit wavs under `audio/` and figures as
PNGs under `figures/`, named <tag>_<step> with "/" in the tag as "_"."""

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
    def __init__(self, run_dir: str, enabled: bool = True):
        """enabled=False makes every write a no-op: the ranks of a process
        mesh other than rank 0 share its run directory (metrics.py:19-40)."""
        self.run_dir = run_dir
        self.enabled = enabled
        os.makedirs(run_dir, exist_ok=True)
        self._jsonl = open(os.path.join(run_dir, "metrics.jsonl"), "a") if enabled else None

    def add_scalar(self, tag: str, value, step: int) -> None:
        if not self.enabled:
            return
        record = {"tag": tag, "value": float(value), "step": int(step), "time": time.time()}
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()

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
        save_wav(path, np.asarray(audio, np.float32).reshape(-1), sample_rate)
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
        return path

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()


def read_metrics(run_dir: str, tag: str):
    """[(step, value)] of every `tag` record in run_dir/metrics.jsonl."""
    out = []
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if rec["tag"] == tag:
                out.append((rec["step"], rec["value"]))
    return out
