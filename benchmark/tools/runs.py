"""Run cells of the benchmark one process a run, as the checker does, and
summarise them.

    python3 benchmark/tools/runs.py --out chiprun_out/NAME.jsonl \\
        CELL:SEED:SECONDS:TRACE [CELL:SEED:SECONDS:TRACE ...]

Each run is `python3 benchmark/run.py ...` from the checkout's root.  One
JSON line a run goes to --out (the result line, the exit code, the wall
time and the end of stderr); a table of the end-to-end metrics and checks
goes to stdout, and at the end each end-to-end metric's spread over the
untraced runs (IQR over median, as the bounds are set).  Prints the card's
name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.lib.stats import spread  # noqa: E402


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--timeout", type=float, default=1200)
    p.add_argument("runs", nargs="+")
    args = p.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print("card:", card, flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    values = {}
    with open(args.out, "a") as out:
        for spec in args.runs:
            cell, seed, seconds, trace = spec.split(":")
            cmd = [sys.executable, "benchmark/run.py", "--workload", cell, "--seed", seed,
                   "--seconds", seconds, "--trace", trace]
            t = time.monotonic()
            try:
                r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=args.timeout)
                rc, stdout, stderr = r.returncode, r.stdout, r.stderr
            except subprocess.TimeoutExpired as e:
                rc, stdout, stderr = 124, e.stdout or "", e.stderr or ""
                stdout = stdout if isinstance(stdout, str) else stdout.decode()
                stderr = stderr if isinstance(stderr, str) else stderr.decode()
            wall = time.monotonic() - t
            lines = stdout.strip().splitlines()
            try:
                result = json.loads(lines[-1]) if lines else None
            except json.JSONDecodeError:
                result = None
            rec = {"cell": cell, "seed": int(seed), "seconds": float(seconds), "trace": int(trace),
                   "rc": rc, "wall_s": wall, "card": card, "result": result,
                   "stderr_tail": stderr[-3000:]}
            out.write(json.dumps(rec) + "\n")
            out.flush()
            if result is None:
                print(f"{cell} seed {seed}: rc {rc}, no result; stderr:\n{stderr[-2500:]}", flush=True)
                continue
            mets = " ".join(f"{k}={v['value']:.6g}" for k, v in result["metrics"].items())
            if trace == "0":
                for k, v in result["metrics"].items():
                    values.setdefault((cell, k), []).append(v["value"])
            chk = " ".join(f"{k}={v['value']:.3g}/{v['limit']:.3g}" for k, v in result["checks"].items())
            info = [l for l in stderr.splitlines() if l.startswith(("samples", "window", "sm_clock", "set-up", "generator", "reference"))]
            print(f"{cell} s={seed} t={trace} rc={rc} wall={wall:.1f}s correct={result['correct']} "
                  f"att={result['attempted']} fail={result['failed']} mem={result['device']['memory_peak_bytes']} "
                  f"| {mets} | {chk}", flush=True)
            for l in info:
                print("    " + l, flush=True)
    for (cell, k), v in values.items():
        if len(v) >= 3:
            print(f"{cell} {k}: {len(v)} runs, spread {spread(v):.4f}", flush=True)


if __name__ == "__main__":
    main()
