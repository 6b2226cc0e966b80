"""Hand-written CUDA kernels: build at first use, bind with ctypes.

Each `*.cu` here is one kernel with a plain `extern "C"` launcher.  It is
compiled with nvcc into `_build/lib<name>-<source hash>.so` (listed in
.gitignore) the first time it is needed, never at import, and loaded with
ctypes.  The source hash in the file name rebuilds a kernel whose source
changed.  Several kernels build in parallel: one nvcc process per source,
all started together.

Wrappers that validate tensors, allocate outputs and count launches live
beside each kernel's plain PyTorch version (ops/oscillator.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_DIR, "_build")

# kernel name → (source file, C launcher symbol, ctypes argtypes)
_P, _I = ctypes.c_void_p, ctypes.c_int
KERNELS = {
    "oscillator_fwd": (
        "oscillator_fwd.cu",
        "ddsp_oscillator_fwd",
        # phi, omega, amp, out, rows, n_harmonic, block_size, stream
        [_P, _P, _P, _P, _I, _I, _I, _P],
    ),
    "oscillator_bwd": (
        "oscillator_bwd.cu",
        "ddsp_oscillator_bwd",
        # phi, omega, amp, grad, dphi, domega, damp, rows, n_harmonic,
        # block_size, stream
        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    ),
}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]  # no --use_fast_math: the oscillator needs the accurate sincosf

_lock = threading.Lock()
_loaded = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin)")


def library_path(name: str) -> str:
    """Where kernel `name`'s shared library is (or will be) built."""
    src = os.path.join(_DIR, KERNELS[name][0])
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(names=None) -> dict:
    """Compile the named kernels (default: all) that are not built yet.

    Returns {name: (seconds, ptxas report)}; seconds is 0.0 for a kernel
    already built.  Raises with nvcc's output if a build fails.
    """
    names = list(KERNELS) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    report = {}
    procs = {}
    for name in names:
        target = library_path(name)
        if os.path.exists(target):
            report[name] = (0.0, "")
            continue
        tmp = f"{target}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(_DIR, KERNELS[name][0])]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True),
            tmp,
            target,
            time.perf_counter(),
        )
    for name, (proc, tmp, target, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} ({proc.returncode}):\n{log}")
        os.replace(tmp, target)  # atomic: a concurrent loader never sees half a file
        report[name] = (time.perf_counter() - t0, log)
    return report


def launcher(name: str):
    """The ctypes function launching kernel `name`, building it if needed."""
    with _lock:
        fn = _loaded.get(name)
        if fn is None:
            build([name])
            _, symbol, argtypes = KERNELS[name]
            fn = getattr(ctypes.CDLL(library_path(name)), symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _loaded[name] = fn
    return fn
