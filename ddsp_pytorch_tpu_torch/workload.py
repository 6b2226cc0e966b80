"""The reference training workload as a config dict (port of
scripts/_workload.py): batch 16, 48 kHz, 192 000-sample chunks, hidden 512,
64 harmonics, 65 bands, reverb, the 6-scale 0.75-overlap loss, lr 1e-3,
with metrics flushed and a checkpoint saved only at the end of a run and no
validation, so a segmented run (train.py --segment-steps) does that work
once a segment.  train_sigmund.py trains it."""

from __future__ import annotations


def reference_workload_config(data_location: str, out_dir: str, preprocess: dict | None = None,
                              train: dict | None = None) -> dict:
    """The config dict for Config.from_dict (or config.dump_yaml);
    `preprocess` and `train` entries override the section they name."""
    cfg = {
        "data": {"data_location": data_location},
        "preprocess": {
            "sample_rate": 48000,
            "signal_length": 192000,
            "block_size": 512,
            "out_dir": out_dir,
        },
        "model": {
            "name": "single-inst-decoder",
            "kwargs": {
                "hidden_size": 512,
                "n_harmonic": 64,
                "n_bands": 65,
                "sample_rate": 48000,
                "block_size": 512,
                "has_reverb": True,
            },
        },
        "train": {
            "scales": [4096, 2048, 1024, 512, 256, 128],
            "overlap": 0.75,
            "batch": 16,
            "lr": 1.0e-3,
            "steps": 10**9,
            "metrics_flush_steps": 1000000000,
            "checkpoint_every_steps": 0,
            "val_interval_epochs": 0,
            "log_interval_epochs": 0,
            "keep_checkpoints": 2,
        },
    }
    cfg["preprocess"].update(preprocess or {})
    cfg["train"].update(train or {})
    return cfg
