"""The headline benchmark: prints ONE JSON line, `x_realtime_48k_100harm`.

Port of the repository's bench.py:21-70.  The metric is the ×-realtime
synthesis factor at 48 kHz of a 100-harmonic voice (hidden 512, 65 noise
bands, block 512, batch 1, fresh weights), measured with the
performance.py protocol (`performance.run_benchmark`) through the whole
streaming synth (GRU decoder, the oscillator kernel at the runtime-K
variant with K = 100 on 128 rows, filtered noise).

    python -m ddsp_pytorch_tpu_torch.bench [--device cuda]

The statistic is the best of 8 protocol runs of 20 synchronized calls
after one discarded run; beside it the value-pull figure (each call ending
in the output's copy to the host; 2 protocol runs of 6 calls).  The line
names the card and its power limit (nvidia-smi) instead of the JAX
script's `vs_baseline`, whose 100× target was set for a TPU chip.
"""

from __future__ import annotations

import argparse
import json

from ddsp_pytorch_tpu_torch import resolve_device
from ddsp_pytorch_tpu_torch.config import Config
from ddsp_pytorch_tpu_torch.performance import run_benchmark

SAMPLE_RATE, BLOCK_SIZE = 48000, 512
HEADLINE_KWARGS = dict(hidden_size=512, n_harmonic=100, n_bands=65, sample_rate=SAMPLE_RATE,
                       block_size=BLOCK_SIZE)
# run_benchmark's arguments for the dispatch statistic and the value-pull one
DISPATCH = dict(n_run=20, batch=1, protocol_runs=8, discard_first=True)
VALUE_PULL = dict(n_run=6, batch=1, protocol_runs=2, value_pull=True)


def headline_config() -> Config:
    """The default Config at 48 kHz, block 512, with the headline voice."""
    config = Config()
    config.preprocess.sample_rate = SAMPLE_RATE
    config.preprocess.block_size = BLOCK_SIZE
    config.model.kwargs.update(HEADLINE_KWARGS)
    return config


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    config = headline_config()
    dispatch = run_benchmark(config=config, device=device, **DISPATCH)
    pulled = run_benchmark(config=config, device=device, **VALUE_PULL)
    card = None
    if device.type == "cuda":
        from ddsp_pytorch_tpu_torch.kernel_bench import card_line

        card = card_line()
    line = {
        "metric": "x_realtime_48k_100harm",
        "value": dispatch["x_realtime"],
        "unit": "x_realtime",
        "mean_ms_per_call": dispatch["mean_ms"],
        "value_pull_x_realtime": pulled["x_realtime"],
        "value_pull_ms_per_call": pulled["mean_ms"],
        "audio_ms_per_call": dispatch["audio_ms"],
        "device": dispatch["device_name"],
        "card": card,
        "calls": dispatch["calls"] + pulled["calls"],
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
