"""Steps/s against (steps_per_call, scan_unroll) at the reference training
workload, each setting in fresh processes (port of scripts/ceiling_probe.py):

    python -m ddsp_pytorch_tpu_torch.ceiling_probe [--configs 50:1,1:1,50:5,200:1,200:8] \\
        [--probe-steps 400] [--repeats 1] [--child-timeout 900] [--root DIR] \\
        [--out reports/ceiling_h100.json] [--set key.path=value ...] [--device cuda]

  * steps_per_call=N: N optimizer steps a call of the Trainer;
  * scan_unroll=U: a CUDA graph of U whole steps, replayed N/U times a call
    (training/train.py MultiStep); steps_per_call=1 runs eager steps.

The protocol is the JAX script's: one prep (trainrun.prep: the fixture
corpus of 24 + 4 notes and its cache, both kept under --root and reused
if there), a stats-priming child, then for each config a warm
child of max(spc, 8) steps and a measured child of --probe-steps steps,
each a fresh `python -m ddsp_pytorch_tpu_torch.train` process resuming
the same run (so the sweep is also a training run); --repeats runs that
pair again for each config, each pair in fresh processes.

On the card the warm child fills no cache: every child captures its own
graph of `unroll` steps, so the measured child pays its warm-up and
capture too.  Each row therefore has two rates: steps over the child's
wall clock (start-up included), and steps over the Trainer's train window
(its synchronized device time, warm-up and capture included), with the
window's ms a step both whole and without the graph's warm-up and capture
(`steady_ms_per_step`), the capture's seconds, the peak device memory the
child allocated, the kernels' launches, the SM clock polled during the
measured child, and the mode of the graphed step (`MODE_SPLIT_MS`).  A
child that fails (out of device memory, say) is a row's status, not the
end of the sweep.  The device defaults to the GPU and there is no
fallback: --device cpu runs the plain PyTorch path.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from typing import Optional

from ddsp_pytorch_tpu_torch import resolve_device
from ddsp_pytorch_tpu_torch.trainrun import REPO, child_env, prep_child, probe_child, workload_config

DEFAULT_OUT = os.path.join(REPO, "reports", "ceiling_h100.json")  # git-ignored
RUN_NAME = "ceiling"
N_TRAIN, N_VALIDATION = 24, 4  # the fixture corpus's notes (scripts/ceiling_probe.py:60-61)
# the graphed reference step at batch 16 runs in one of two modes on an
# H100 (about 39.3 or 44.4 ms a step, PERF.md); a row below this is "fast"
MODE_SPLIT_MS = 41.85
SM_POLL_S = 1.0

PROTOCOL = (
    "per config and repeat: a fresh warm child of max(spc, 8) steps, then a fresh measured child "
    "of probe_steps steps, both resuming the same run.  On the card the warm child fills no cache: "
    "each child warms up and captures its own CUDA graph of `unroll` steps, and the measured child "
    "pays its own (graph_warmup_s, graph_capture_s).  steps_per_s_wall = probe_steps / the measured "
    "child's wall clock (torch import, device cache upload, restore, warm-up, capture, steps, flush, "
    "save); steps_per_s_train_window = probe_steps / the Trainer's synchronized train window "
    "(warm-up and capture included); steady_ms_per_step leaves out the warm-up and capture.  The "
    "prime child's wall clock is the fixed cost of a child that trains no step."
)


def parse_configs(text: str) -> list:
    """"spc:unroll,..." → [(spc, unroll)]; a missing unroll is 1."""
    configs = []
    for tok in text.split(","):
        spc, _, unroll = tok.partition(":")
        configs.append((int(spc), int(unroll or 1)))
    return configs


def _sm_clock() -> Optional[int]:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=30)
    return int(out.stdout.split()[0]) if out.returncode == 0 else None


class ClockPoller:
    """The card's SM clock (MHz), polled every SM_POLL_S on a thread while
    a child runs."""

    def __init__(self, enabled: bool):
        self.enabled, self.samples = enabled, []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            mhz = _sm_clock()
            if mhz is not None:
                self.samples.append(mhz)
            self._stop.wait(SM_POLL_S)

    def __enter__(self):
        if self.enabled:
            self._thread.start()
        return self

    def __exit__(self, *exc):
        if self.enabled:
            self._stop.set()
            self._thread.join()

    def summary(self) -> dict:
        s = self.samples
        if not s:
            return {"sm_clock_mhz_start": None, "sm_clock_mhz_end": None, "sm_clock_mhz_min": None,
                    "sm_clock_mhz_max": None}
        return {"sm_clock_mhz_start": s[0], "sm_clock_mhz_end": s[-1], "sm_clock_mhz_min": min(s),
                "sm_clock_mhz_max": max(s)}


def run_train_child(cfg_path: str, root: str, boundary: int, spc: int, unroll: int, device: str,
                    timeout_s: float, log: str, poll_clock: bool = False) -> dict:
    """One fresh train child to step `boundary` at (spc, unroll); its output
    goes to `log`.  Returns {wall_s, status, pid[, clocks]}: status "ok",
    "rc=N", "oom" (torch's out-of-memory error in the log) or "timeout"
    (wall_s None)."""
    cmd = [sys.executable, "-m", "ddsp_pytorch_tpu_torch.train", "--config", cfg_path,
           "--root", os.path.join(root, "runs"), "--name", RUN_NAME, "--device-cache", "--device", device,
           "--steps", str(boundary), "--set", f"train.steps_per_call={spc}",
           "--set", f"train.scan_unroll={unroll}", "--no-tensorboard"]
    t0 = time.time()
    with open(log, "w") as f, ClockPoller(poll_clock) as clocks:
        proc = subprocess.Popen(cmd, env=child_env(), stdout=f, stderr=subprocess.STDOUT)
        try:
            rc = proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = None
    wall = time.time() - t0
    out = {"wall_s": wall if rc is not None else None, "pid": proc.pid}
    if rc is None:
        out["status"] = "timeout"
    elif rc == 0:
        out["status"] = "ok"
    else:
        with open(log) as f:
            text = f.read()
        out["status"] = "oom" if "OutOfMemoryError" in text or "out of memory" in text else f"rc={rc}"
        print(f"[ceiling] child to step {boundary} failed ({out['status']}); its log's end:\n"
              + "\n".join(text.strip().splitlines()[-15:]), flush=True)
    if poll_clock:
        out.update(clocks.summary())
    return out


def window_fields(run_dir: str, step: int, steps: int) -> dict:
    """The Trainer's window metrics of the child that ended at `step`."""
    found = {}
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        for line in f:
            r = json.loads(line)
            if r["step"] == step:
                found[r["tag"]] = r["value"]  # the last child to end there
    window = found.get("train_window_s")
    warm, capture = found.get("graph_warmup_s"), found.get("graph_capture_s")
    steady = None
    if window is not None:
        steady = (window - (warm or 0.0) - (capture or 0.0)) * 1e3 / steps
    return {
        "steps_per_s_train_window": found.get("train_window_steps_per_s"),
        "train_window_ms_per_step": None if window is None else window * 1e3 / steps,
        "steady_ms_per_step": steady,
        "graph_warmup_s": warm,
        "graph_capture_s": capture,
        "max_memory_allocated_bytes": found.get("max_memory_allocated_bytes"),
        "kernel_launches": {t.split("/", 1)[1]: int(v) for t, v in found.items()
                            if t.startswith("kernel_launches/")},
        "kernel_replayed": {t.split("/", 1)[1]: int(v) for t, v in found.items()
                            if t.startswith("kernel_replayed/")},
    }


def _mode(spc: int, steady: Optional[float]) -> Optional[str]:
    """The graphed step's mode ("fast" or "slow"); None for eager steps."""
    if steady is None or spc == 1:
        return None
    return "fast" if steady < MODE_SPLIT_MS else "slow"


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=None, help="corpus, cache and run (default: a new temporary directory)")
    p.add_argument("--probe-steps", type=int, default=400)
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--configs", default="50:1,1:1,50:5,200:1,200:8", help="comma list of steps_per_call:unroll")
    p.add_argument("--repeats", type=int, default=1, help="warm + measured pairs a config, each a fresh process")
    p.add_argument("--child-timeout", type=int, default=900)
    p.add_argument("--set", action="append", default=[], metavar="KEY.PATH=VALUE", dest="overrides",
                   help="override a workload config field before anything is made (repeatable)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)  # no child is started for a device that is missing
    on_card = dev.type == "cuda"
    root = args.root or tempfile.mkdtemp(prefix="ddsp_ceiling_")
    logs = os.path.join(root, "logs")
    os.makedirs(logs, exist_ok=True)
    cfg = workload_config(root, steps=10**9, steps_per_call=1, overrides=args.overrides)
    cfg_path = os.path.join(root, "ceiling.yaml")
    cfg.to_yaml(cfg_path)
    run_dir = os.path.join(root, "runs", RUN_NAME)
    configs = parse_configs(args.configs)

    print(f"[ceiling] prep ({args.device} child) under {root} ...", flush=True)
    prep_child(cfg_path, N_TRAIN, N_VALIDATION, args.device)
    probe = probe_child(args.device)
    print(f"[ceiling] platform: {probe}", flush=True)

    t0 = time.time()
    prime = run_train_child(cfg_path, root, 0, 1, 1, args.device, args.child_timeout,
                            os.path.join(logs, "prime.log"))
    print(f"[ceiling] prime: {prime['wall_s']} s {prime['status']}", flush=True)
    if prime["status"] != "ok":
        raise RuntimeError(f"the stats-priming child failed: {prime['status']}")

    boundary, rows = 0, []
    for repeat in range(args.repeats):
        for spc, unroll in configs:
            warm = max(spc, 8)
            tag = f"spc{spc}_u{unroll}_r{repeat}"
            w = run_train_child(cfg_path, root, boundary + warm, spc, unroll, args.device, args.child_timeout,
                                os.path.join(logs, f"{tag}_warm.log"))
            if w["status"] != "ok":
                rows.append({"steps_per_call": spc, "unroll": unroll, "repeat": repeat,
                             "status": f"warm {w['status']}"})
                continue
            boundary += warm
            m = run_train_child(cfg_path, root, boundary + args.probe_steps, spc, unroll, args.device,
                                args.child_timeout, os.path.join(logs, f"{tag}_measured.log"), poll_clock=on_card)
            row = {
                "steps_per_call": spc, "unroll": unroll, "repeat": repeat,
                "warm_steps": warm, "warm_wall_s": w["wall_s"],
                "measured_steps": args.probe_steps, "measured_wall_s": m["wall_s"],
                "status": m["status"],
                "steps_per_s_wall": args.probe_steps / m["wall_s"] if m["status"] == "ok" else None,
                "s_per_step": m["wall_s"] / args.probe_steps if m["status"] == "ok" else None,
                "warm_pid": w["pid"], "measured_pid": m["pid"],
            }
            if m["status"] == "ok":  # else the next child resumes from the warm child's checkpoint
                boundary += args.probe_steps
                row.update(window_fields(run_dir, boundary, args.probe_steps))
                row["mode"] = _mode(spc, row["steady_ms_per_step"]) if on_card else None
            row.update({k: v for k, v in m.items() if k.startswith("sm_clock")})
            rows.append(row)
            print(f"[ceiling] spc={spc} u={unroll} r={repeat}: warm {w['wall_s']:.1f} s, measured "
                  f"{m['wall_s']} s -> {row['steps_per_s_wall']} steps/s wall, "
                  f"{row.get('steps_per_s_train_window')} steps/s train window, steady "
                  f"{row.get('steady_ms_per_step')} ms/step, capture {row.get('graph_capture_s')} s, "
                  f"peak {row.get('max_memory_allocated_bytes')} B, SM {row.get('sm_clock_mhz_start')}-"
                  f"{row.get('sm_clock_mhz_end')} MHz ({m['status']}); card {probe['card']}", flush=True)

    report = {
        "what": "steps/s against dispatch structure at the reference training workload (batch 16, "
                "48 kHz, 192000-sample chunks, hidden 512, 64 harmonics, reverb, 6-scale loss) on "
                f"{probe['device_kind']}",
        "protocol": PROTOCOL,
        "probe_steps": args.probe_steps,
        "repeats": args.repeats,
        "platform": probe,
        "card": probe["card"],
        "prime_wall_s": prime["wall_s"],
        "mode_split_ms": MODE_SPLIT_MS,
        "rows": rows,
        "total_wall_s": time.time() - t0,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(f"[ceiling] wrote {args.out}", flush=True)
    return report


if __name__ == "__main__":
    main()
