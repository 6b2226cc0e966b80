"""The port's benchmark: one cell, one run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs from the checkout's root on a machine with the card(s) the cell asks
for.  Prints each number `correct` compares, with its limit, and the run's
counts on stderr, and as the last line of stdout one JSON object: correct,
attempted, failed, metrics (the cell's end-to-end metrics, or with
--trace 1 its per-layer ones), device, breakdown (traced runs) and checks.
Exits non-zero, printing no result, without CUDA or enough cards, or when
JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _process_start_monotonic() -> float:
    """When this process started, on the monotonic clock (Linux: its start
    in clock ticks since boot); the time of this call elsewhere."""
    now = time.monotonic()
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return now - (time.clock_gettime(time.CLOCK_BOOTTIME) - started)
    except (OSError, ValueError, IndexError, AttributeError):
        return now


MONO_START = _process_start_monotonic()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark import harness

    spec = harness.benchmark_spec(ROOT)
    entry = harness.cell_entry(spec, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"benchmark: needs {entry['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    run = harness.run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace), device,
                           MONO_START)
    bad = harness.forbidden_loaded(sys.modules)
    if bad:
        print(f"benchmark: modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 4
    line = harness.result_line(spec, args.workload, run, bool(args.trace),
                               torch.cuda.get_device_name(0))
    for k, v in run.info.items():
        print(f"{k}: {v}", file=sys.stderr)
    for k, (v, lim) in run.checks.items():
        print(f"check {k} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
