"""Hand-written CUDA kernels: build at first use, bind with ctypes.

Each `*.cu` here is one kernel with a plain `extern "C"` launcher (a
source may hold a second, such as gru_fwd.cu's barrier probe, and one
launcher may stand under two names, as the roofline probes' does, to be
counted apart).  It is
compiled with nvcc into `_build/lib<source>-<source hash>.so` (listed in
.gitignore) the first time it is needed, never at import, and loaded with
ctypes.  The source hash in the file name rebuilds a kernel whose source
changed.  Several kernels build in parallel: one nvcc process per source,
all started together; the first launch of any of the models' kernels
(`MODEL_KERNELS`) but the optimizer's builds all of them so, rather than
one after another.

This module is also the one seam between the op modules and the kernels:
`launch(name, *args)` is the only caller of a C launcher, and counts each
launch in one table (`counts`, `reset_counts`, `count_replayed`);
`check_operands` is the rule every wrapper holds its tensors to.  Each op
module (ops/oscillator.py, ops/gru.py, ops/stft_loss.py, ops/adam.py,
ops/roofline.py)
keeps its shape checks, its plain PyTorch versions, the allocation of its
outputs and one `launch` a kernel.  Adding a kernel adds its `KERNELS`
entry here and touches nothing else outside its own op module.
"""

from __future__ import annotations

import atexit
import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import sys
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
    # the two roofline probes: one source and symbol, counted apart
    "roofline_fma": (
        "roofline_probe.cu",
        "ddsp_roofline_probe",
        # x, out, n, kind (0 fma, 1 sin), threads a block, stream
        [_P, _P, _I, _I, _I, _P],
    ),
    "roofline_sin": (
        "roofline_probe.cu",
        "ddsp_roofline_probe",
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
    "stft_rave_norms": (
        "stft_loss.cu",
        "ddsp_stft_rave_norms",
        # spec, norms (2 × blocks), bins of one signal, blocks, stream
        [_P, _P, _I, _I, _P],
    ),
    "stft_rave_loss_grad": (
        "stft_loss.cu",
        "ddsp_stft_rave_loss_grad",
        # spec, grad, partials, norms, bins of one signal, bins a frame,
        # Nyquist bin (−1: none), 1/M as float and as double, blocks, stream
        [_P, _P, _P, _P, _I, _I, _I, _F, _D, _I, _P],
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
    "adam_norm": (
        "adam.cu",
        "ddsp_adam_norm",
        # leaf table (host), partials, blocks, chunk, stream
        [_P, _P, _I, _I, _P],
    ),
    "adam_update": (
        "adam.cu",
        "ddsp_adam_update",
        # leaf table (host), partials, their count, norm out, done counter,
        # loss, count, schedule count, lr, lr end, 1/steps, steps, clips,
        # clip, b1, b2, 1 − b1, 1 − b2, blocks, chunk, finalize, stream
        [_P, _P, _I, _P, _P, _P, _P, _P, _F, _F, _F, _I, _I, _F, _F, _F, _F, _F, _I, _I, _I, _P],
    ),
}
# the optimizer's kernels (ops/adam.py), which also train a model that
# launches no other (CREPE): the first launch of one builds adam.cu alone
OPTIMIZER_KERNELS = ("adam_norm", "adam_update")
# the kernels a train step launches: the first launch of one of the others
# builds them all
MODEL_KERNELS = ("oscillator_fwd", "oscillator_bwd", "gru_fwd", "gru_bwd", "stft_frame", "stft_loss_grad",
                 "stft_rave_norms", "stft_rave_loss_grad", "stft_loss_sum", "stft_overlap_add",
                 *OPTIMIZER_KERNELS)

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
            build(MODEL_KERNELS if name in MODEL_KERNELS and name not in OPTIMIZER_KERNELS else [name])
            _, symbol, argtypes = KERNELS[name]
            fn = getattr(ctypes.CDLL(library_path(name)), symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _loaded[name] = fn
    return fn


def check_operands(operands: dict, spectra: bool = False) -> None:
    """The rule every kernel wrapper holds its tensors to, for `operands`
    ({name: tensor or None}, the first a tensor; None is skipped): one
    device, `cpu` or `cuda`; one real type, float32 on a card and float32
    or float64 on the CPU (the plain versions' reference), complex of it
    too where the op takes `spectra`; contiguous.  Raises TypeError for a
    type, ValueError for a device or a layout."""
    import torch  # here: this module is imported by code that needs no torch

    (first, t0), *_ = operands.items()
    device = t0.device
    real = t0.dtype.to_real() if spectra else t0.dtype
    allowed = (torch.float32, torch.float64) if device.type == "cpu" else (torch.float32,)
    if real not in allowed:
        raise TypeError(f"{first} must be one of {allowed}{' (or complex)' if spectra else ''} on "
                        f"{device}, got {t0.dtype}")
    for name, t in operands.items():
        if t is None:
            continue
        if (t.dtype.to_real() if spectra else t.dtype) != real:
            raise TypeError(f"{name} must be {'of ' if spectra else ''}{real} like {first}, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, {first} on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")


# kernel → its launches: `launches` ran when launched, `captured` were
# recorded into a CUDA graph under stream capture, `replayed` ran in the
# replays of such graphs (which the replaying code adds, `count_replayed`)
_counts = {name: {"launches": 0, "captured": 0, "replayed": 0} for name in KERNELS}


def launch(name: str, *args) -> None:
    """Launch kernel `name` on the current stream of the first tensor
    argument's device: tensors pass as their data pointers, None as a null
    pointer, ints, floats and ctypes objects as they are, and the stream
    last.  Raises on a non-zero cudaError; counts the launch in `captured`
    while the current stream is capturing a CUDA graph, else in
    `launches`."""
    import torch

    fn = launcher(name)
    device = next(a.device for a in args if isinstance(a, torch.Tensor))
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        err = fn(*ptrs, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    _counts[name]["captured" if torch.cuda.is_current_stream_capturing() else "launches"] += 1


def count_replayed(captured: dict) -> None:
    """Add one replay of a graph that captured {kernel: launches} to
    `replayed`."""
    for name, n in captured.items():
        _counts[name]["replayed"] += n


def counts() -> dict:
    """A snapshot of the count table: {kernel: {launches, captured,
    replayed}} of every kernel in `KERNELS`, since the process started or
    the last `reset_counts`."""
    return {name: dict(c) for name, c in _counts.items()}


def reset_counts() -> None:
    for c in _counts.values():
        c.update(launches=0, captured=0, replayed=0)


# where a process appends its models' kernel counts when it exits, one JSON
# line, if this variable names a file: a parent that drives the port
# through child processes (the CLIs, segmented runs) sums them
COUNTS_FILE_ENV = "DDSP_KERNEL_COUNTS_FILE"


def _append_counts_at_exit() -> None:
    path = os.environ.get(COUNTS_FILE_ENV)
    if path:
        with open(path, "a") as f:
            f.write(json.dumps({"pid": os.getpid(), "argv": sys.argv,
                                "counts": {name: _counts[name] for name in MODEL_KERNELS}}) + "\n")


atexit.register(_append_counts_at_exit)
