"""Hand-written CUDA kernels: build at first use, bind with ctypes.

Each `*.cu` here is one kernel with a plain `extern "C"` launcher (a
source may hold a second, such as gru_fwd.cu's barrier probe).  It is
compiled with nvcc into `_build/lib<source>-<source hash>.so` (listed in
.gitignore) the first time it is needed, never at import, and loaded with
ctypes.  The source hash in the file name rebuilds a kernel whose source
changed.  Several kernels build in parallel: one nvcc process per source,
all started together; the first launch of any of the models' kernels
(`MODEL_KERNELS`) builds all of them so, rather than one after another.

Wrappers that validate tensors, allocate outputs and count launches
(`count_launch`) live beside each kernel's plain PyTorch version
(ops/oscillator.py, ops/gru.py, ops/stft_loss.py, ops/roofline.py).
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
_P, _I, _IP = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
_F, _D = ctypes.c_float, ctypes.c_double
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
    "roofline_probe": (
        "roofline_probe.cu",
        "ddsp_roofline_probe",
        # x, out, n, kind (0 fma, 1 sin), threads a block, stream
        [_P, _P, _I, _I, _I, _P],
    ),
    "gru_fwd": (
        "gru_fwd.cu",
        "ddsp_gru_fwd",
        # x_proj, w_hh, b_hh, h0, out, h_final, saved, batch, frames, hidden,
        # plan (rows a cluster, clusters), stream
        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _IP, _P],
    ),
    "gru_bwd": (
        "gru_bwd.cu",
        "ddsp_gru_bwd",
        # dout, dh_final, saved, w_hh, dxp, dhp, dh0, batch, frames, hidden,
        # plan (rows a cluster, clusters), stream
        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _IP, _P],
    ),
    "gru_barrier_probe": (
        "gru_fwd.cu",
        "ddsp_gru_barrier_probe",
        # sink, frames, hidden, rows, stream
        [_P, _I, _I, _I, _P],
    ),
    "stft_frame": (
        "stft_loss.cu",
        "ddsp_stft_frame",
        # x, y, c, frames, rows of x, T, n, hop, frames a row, stream
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    ),
    "stft_loss_grad": (
        "stft_loss.cu",
        "ddsp_stft_loss_grad",
        # spec, grad, partials, bins of one signal, bins a frame, Nyquist
        # bin (−1: none), 1/M as float and as double, blocks, stream
        [_P, _P, _P, _I, _I, _I, _F, _D, _I, _P],
    ),
    "stft_loss_sum": (
        "stft_loss.cu",
        "ddsp_stft_loss_sum",
        # partials, their count, loss, stream
        [_P, _I, _P, _P],
    ),
    "stft_overlap_add": (
        "stft_loss.cu",
        "ddsp_stft_overlap_add",
        # frames' gradients, c, upstream gradient, out, rows, T, n, hop,
        # frames a row, accumulate, stream
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    ),
}
# the kernels the models launch: the first launch of one builds them all
MODEL_KERNELS = ("oscillator_fwd", "oscillator_bwd", "gru_fwd", "gru_bwd", "stft_frame", "stft_loss_grad",
                 "stft_loss_sum", "stft_overlap_add")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]  # no --use_fast_math: the oscillator needs the accurate sincosf (and the
#    sin probe measures that accurate routine's rate)

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
    """Where kernel `name`'s shared library (its source's) is, or will be,
    built."""
    source = KERNELS[name][0]
    with open(os.path.join(_DIR, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{os.path.splitext(source)[0]}-{digest.hexdigest()[:16]}.so")


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
        if os.path.exists(target) or any(p[2] == target for p in procs.values()):
            report[name] = (0.0, "")  # built, or building under another name
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


def sass(name: str) -> dict:
    """{kernel function: its SASS} of kernel `name`'s built library, from
    `cuobjdump -sass` (in the CUDA toolkit beside nvcc)."""
    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", library_path(name)], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    functions, current = {}, None
    for line in out.splitlines():
        if "Function : " in line:
            current = line.split("Function : ", 1)[1].strip()
            functions[current] = []
        elif current is not None:
            functions[current].append(line)
    return {fn: "\n".join(lines) for fn, lines in functions.items()}


def launcher(name: str):
    """The ctypes function launching kernel `name`, building it if needed."""
    with _lock:
        fn = _loaded.get(name)
        if fn is None:
            build(MODEL_KERNELS if name in MODEL_KERNELS else [name])
            _, symbol, argtypes = KERNELS[name]
            fn = getattr(ctypes.CDLL(library_path(name)), symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _loaded[name] = fn
    return fn


def count_launch(wrapper) -> None:
    """Count a kernel launch on its wrapper: `launches` when it ran now;
    `captured` when the stream is capturing a CUDA graph, where the kernel
    is recorded and runs only when the graph is replayed (the replaying
    code adds the graph's captured launches to `replayed`)."""
    import torch  # here: this module is imported by code that needs no torch

    if torch.cuda.is_current_stream_capturing():
        wrapper.captured += 1
    else:
        wrapper.launches += 1
