"""One-command verification of the port (port of scripts/ci.sh):

    python -m ddsp_pytorch_tpu_torch.ci [--fast] [--device cpu|cuda]

Steps, in order; the first that fails ends the run with an error:
  1. pytest: on the CPU the port's tests (tests/test_torch_*.py; they run
     the JAX package as the reference), on the card the card-only tests
     (CARD_TEST_FILES with -m cuda and DDSP_TEST_PLATFORM=cuda, which need
     no JAX);
  2. runtime: build_runtime(), then stream_test and pd_mock_test without a
     model and with the violin bundle (the model host on --device);
  3. sanitizers (not with --fast): stream_test built under ThreadSanitizer
     and under AddressSanitizer + UBSan, every test passing and no report;
  4. selftest: `python -m ddsp_pytorch_tpu_torch.runtime.selftest`;
  5. multiprocess: two gloo processes of the train CLI with --multihost
     (data mesh 2) on a tiny synthetic cache, as tests/test_torch_multiproc.py
     runs them (the JAX script's multi-device dry run);
  6. e2e (not with --fast): the CLI journey of e2e_smoke.py.

The device defaults to the GPU and there is no fallback: --device cpu
runs the plain PyTorch path.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import tempfile
import time

from ddsp_pytorch_tpu_torch import resolve_device
from ddsp_pytorch_tpu_torch.trainrun import REPO, child_env

STEPS = ("pytest", "runtime", "sanitizers", "selftest", "multiprocess", "e2e")
FAST_SKIPS = ("sanitizers", "e2e")
# the port's test files whose `cuda` tests run on a card without JAX
CARD_TEST_FILES = ("test_torch_device.py", "test_torch_bench_headline.py", "test_torch_step_breakdown.py",
                   "test_torch_scaling.py")
BUNDLE = os.path.join(REPO, "pretrained", "ddsp_violin_bundle")
BINARY_TIMEOUT_S = 300
PROCESS_TIMEOUT_S = 300


def step_pytest(device: str) -> None:
    tests = os.path.join(REPO, "tests")
    env = dict(os.environ)
    if device == "cpu":
        files = sorted(os.path.join(tests, f) for f in os.listdir(tests)
                       if f.startswith("test_torch_") and f.endswith(".py"))
        extra = []
    else:
        files = [os.path.join(tests, f) for f in CARD_TEST_FILES]
        extra = ["-m", "cuda"]
        env["DDSP_TEST_PLATFORM"] = "cuda"
    subprocess.run([sys.executable, "-m", "pytest", *files, "-x", "-q", *extra], cwd=REPO, env=env, check=True)


def _binary(name: str, *args: str, expect: str, env=None) -> str:
    from ddsp_pytorch_tpu_torch import runtime

    rc, out, secs = runtime.run_binary(name, *args, timeout=BINARY_TIMEOUT_S, env=env)
    print(out.rstrip(), flush=True)
    if rc != 0 or expect not in out:
        raise RuntimeError(f"{name} exited {rc} without {expect!r}")
    print(f"{name}: ok in {secs:.1f} s", flush=True)
    return out


def step_runtime(device: str) -> None:
    from ddsp_pytorch_tpu_torch import runtime

    print(f"built in {runtime.build_runtime()}", flush=True)
    _binary("stream_test", expect="stream_test: PASS")
    env = dict(os.environ, DDSP_DEVICE=device)
    external = runtime.runtime_path("ddsp~.pd_linux")
    _binary("pd_mock_test", external, expect="pd_mock_test ok (no model", env=env)
    _binary("pd_mock_test", external, BUNDLE, expect="pd_mock_test ok (bundle", env=env)


def step_sanitizers() -> None:
    from ddsp_pytorch_tpu_torch import runtime

    for sanitize, (_, name, _) in sorted(runtime.SANITIZERS.items()):
        out = _binary(name, expect="stream_test: PASS")
        reports = [r for r in runtime.SANITIZER_REPORTS if r in out]
        if reports:
            raise RuntimeError(f"{name}: sanitizer reports {reports}")


def step_selftest(device: str) -> None:
    subprocess.run([sys.executable, "-m", "ddsp_pytorch_tpu_torch.runtime.selftest", "--device", device],
                   env=dict(child_env(), DDSP_DEVICE=device), check=True, timeout=PROCESS_TIMEOUT_S)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def step_multiprocess(device: str, world: int = 2, steps: int = 2) -> None:
    """`world` gloo ranks of the train CLI (--multihost, data mesh `world`)
    on a tiny synthetic cache; each must exit 0, and rank 0 logs every
    step's loss, finite."""
    import math

    from ddsp_pytorch_tpu_torch.config import Config
    from ddsp_pytorch_tpu_torch.data import make_synthetic_dataset
    from ddsp_pytorch_tpu_torch.training.metrics import read_metrics

    with tempfile.TemporaryDirectory(prefix="ddsp_ci_mp_") as tmp:
        cache = os.path.join(tmp, "cache")
        make_synthetic_dataset(cache, n_items=8, sample_rate=16000, signal_length=2048, block_size=64,
                               n_harmonic=4, device=device)
        cfg = Config.from_dict({
            "preprocess": {"sample_rate": 16000, "signal_length": 2048, "block_size": 64, "out_dir": cache},
            "model": {"name": "single-inst-decoder", "kwargs": {
                "hidden_size": 16, "n_harmonic": 4, "n_bands": 5, "sample_rate": 16000, "block_size": 64,
                "has_reverb": True}},
            "train": {"scales": [256, 128], "batch": 4, "steps": steps, "val_interval_epochs": 1,
                      "checkpoint_every_steps": 0},
        })
        config = os.path.join(tmp, "mp.yaml")
        cfg.to_yaml(config)
        env = dict(child_env(), OMP_NUM_THREADS="1", MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
                   WORLD_SIZE=str(world))
        cmd = [sys.executable, "-m", "ddsp_pytorch_tpu_torch.train", "--config", config, "--name", "mp", "--root",
               tmp, "--device", device, "--multihost", "--backend", "gloo", "--dist-timeout", "120", "--no-tensorboard"]
        procs = [subprocess.Popen(cmd, env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for r in range(world)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=PROCESS_TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for r, (p, log) in enumerate(zip(procs, logs)):
            print(f"rank {r} (exit {p.returncode}): " + " | ".join(log.strip().splitlines()[-2:]), flush=True)
        if any(p.returncode != 0 for p in procs):
            raise RuntimeError("a rank failed:\n" + "\n=====\n".join(logs))
        losses = [v for _, v in read_metrics(os.path.join(tmp, "mp"), "loss")]
        if len(losses) != steps or not all(math.isfinite(v) for v in losses):
            raise RuntimeError(f"rank 0 logged losses {losses}, not {steps} finite ones")


def step_e2e(device: str) -> None:
    from ddsp_pytorch_tpu_torch import e2e_smoke

    e2e_smoke.main(["--device", device])


def step_functions(args) -> dict:
    """{step name: a function of no arguments that runs it}."""
    return {
        "pytest": lambda: step_pytest(args.device),
        "runtime": lambda: step_runtime(args.device),
        "sanitizers": step_sanitizers,
        "selftest": lambda: step_selftest(args.device),
        "multiprocess": lambda: step_multiprocess(args.device),
        "e2e": lambda: step_e2e(args.device),
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--fast", action="store_true", help="skip the sanitizer builds and the CLI journey")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    resolve_device(args.device)
    steps = [s for s in STEPS if not (args.fast and s in FAST_SKIPS)]
    functions, secs = step_functions(args), {}
    for i, name in enumerate(steps):
        print(f"== {i + 1}/{len(steps)} {name} ({args.device})", flush=True)
        t0 = time.perf_counter()
        functions[name]()
        secs[name] = time.perf_counter() - t0
    print("CI: all green " + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items())
          + (" (--fast: no sanitizers, no e2e)" if args.fast else ""), flush=True)
    return secs


if __name__ == "__main__":
    main()
