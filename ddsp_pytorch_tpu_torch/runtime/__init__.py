"""The native realtime path: the double-buffered stream engine, the
CPython-embedded model host, the standalone host and the Pd external `ddsp~`.

Port of ddsp_pytorch_tpu/runtime/ (`__init__.py:1-249` and its C++
sources).  The framework-neutral sources are this package's own copies:
`ddsp_stream.{h,cpp}` (the engine), `stream_test.cpp`, `pd_mock_test.cpp`
and the vendored Pd header `pd/m_pd.h`.  The model host
(`ddsp_model.{h,cpp}`) embeds CPython and drives
`ddsp_pytorch_tpu_torch.export.make_stream_session` on DDSP_DEVICE (default
"cuda"); `ddsp_host.cpp` and `pd_ddsp_tilde.cpp` sit on the two.

`build_runtime()` compiles them with g++ (C++17, -O3, -pthread) and the
running interpreter's embedding flags, at first use, into
`_build/<hash of the sources and flags>/` (git-ignored):

  libddsp_stream.so   the engine (no Python)
  libddsp_model.so    the model host (links libpython)
  ddsp_host           bundle → pitch/loudness ticks → wav + timing report
  stream_test         the engine's unit tests
  ddsp~.pd_linux      the Pd external
  pd_mock_test        loads ddsp~.pd_linux the way Pd does and drives it

`build_runtime(sanitize="thread")` and `build_runtime(sanitize="address")`
build, into `_build/<hash>-tsan/` and `_build/<hash>-asan/` beside the
release build, the engine's unit tests under ThreadSanitizer
(`stream_test_tsan`) and under AddressSanitizer with UBSan
(`stream_test_asan`), as runtime/CMakeLists.txt:58-77 of the JAX package
does; `run_binary("stream_test_tsan")` builds and runs one.

`StreamEngine` binds the engine with a Python render callback;
`ModelHost` binds the model host in this process (the model then runs in
this interpreter, so its kernel launch counters are visible here).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import sysconfig
import time
import uuid
from typing import Callable, Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_ROOT = os.path.join(_DIR, "_build")
CXX_FLAGS = ["-std=c++17", "-O3", "-pthread", "-Wall"]
SOURCES = ("ddsp_stream.h", "ddsp_stream.cpp", "ddsp_model.h", "ddsp_model.cpp", "ddsp_host.cpp",
           "stream_test.cpp", "pd_ddsp_tilde.cpp", "pd_mock_test.cpp", "pd/m_pd.h")
COMPILE_TIMEOUT_S = 300
# sanitize= → (suffix of its build directory, executable, compile and link flags)
SANITIZERS = {
    "thread": ("tsan", "stream_test_tsan", ["-fsanitize=thread", "-g", "-O1"]),
    "address": ("asan", "stream_test_asan",
                ["-fsanitize=address,undefined", "-g", "-O1", "-fno-omit-frame-pointer"]),
}
# what a sanitizer prints when it finds a fault (the exit code is nonzero too)
SANITIZER_REPORTS = ("WARNING: ThreadSanitizer", "ERROR: AddressSanitizer", "runtime error:",
                     "ERROR: LeakSanitizer")

_FP = ctypes.POINTER(ctypes.c_float)
_RENDER_CB = ctypes.CFUNCTYPE(None, _FP, _FP, _FP, ctypes.c_int, ctypes.c_void_p)
# pitch, loudness, input audio, out, n, ctx
_RENDER_AUDIO_CB = ctypes.CFUNCTYPE(None, _FP, _FP, _FP, _FP, ctypes.c_int, ctypes.c_void_p)


def _python_flags() -> tuple:
    """(compile flags, link flags) embedding the running interpreter."""
    cfg = sysconfig.get_config_vars()
    if not cfg.get("Py_ENABLE_SHARED"):
        raise RuntimeError(
            f"{sys.executable} has no shared libpython (Py_ENABLE_SHARED is 0): the model "
            "host must link the libpython this interpreter runs on")
    include, libdir = sysconfig.get_paths()["include"], cfg["LIBDIR"]
    if not os.path.exists(os.path.join(include, "Python.h")):
        raise RuntimeError(f"Python.h not found in {include}: the model host needs the "
                           "interpreter's development headers")
    version = f"python{cfg['LDVERSION']}"
    return ([f"-I{include}", f'-DDDSP_PYTHON_EXECUTABLE="{sys.executable}"'],
            [f"-L{libdir}", f"-Wl,-rpath,{libdir}", f"-l{version}", "-ldl"])


def _targets(cflags: list, ldflags: list) -> list:
    """[(output, sources, extra flags)] in two stages: the two libraries,
    then what links them (by -l from the same directory, found at run time
    through $ORIGIN)."""
    shared = ["-shared", "-fPIC"]
    local = ["-L{out}", "-Wl,-rpath,$ORIGIN"]
    return [
        [("libddsp_stream.so", ["ddsp_stream.cpp"], shared),
         ("libddsp_model.so", ["ddsp_model.cpp"], shared + cflags + ldflags)],
        [("ddsp_host", ["ddsp_host.cpp"], local + ["-lddsp_stream", "-lddsp_model"] + ldflags),
         ("stream_test", ["stream_test.cpp"], local + ["-lddsp_stream"]),
         ("ddsp~.pd_linux", ["pd_ddsp_tilde.cpp"],
          shared + [f"-I{os.path.join(_DIR, 'pd')}"] + local + ["-lddsp_stream", "-lddsp_model"] + ldflags),
         ("pd_mock_test", ["pd_mock_test.cpp"], ["-rdynamic", "-ldl"])],
    ]


def _sanitizer_targets(sanitize: str) -> list:
    """The one stage of a sanitizer build: the engine's unit tests linked
    with the engine's source, both compiled with the sanitizer's flags."""
    _, out, flags = SANITIZERS[sanitize]
    return [[(out, ["stream_test.cpp", "ddsp_stream.cpp"], flags)]]


def build_dir(sanitize: Optional[str] = None) -> str:
    """Where this checkout's runtime is (or will be) built: a directory named
    by a hash of the sources, the flags, the compiler and the interpreter;
    a sanitizer build's name ends in its suffix."""
    cflags, ldflags = _python_flags()
    digest = hashlib.sha256()
    for name in SOURCES:
        with open(os.path.join(_DIR, name), "rb") as f:
            digest.update(name.encode() + f.read())
    digest.update(" ".join(CXX_FLAGS + cflags + ldflags + [_cxx()]).encode())
    name = digest.hexdigest()[:16]
    if sanitize is not None:
        if sanitize not in SANITIZERS:
            raise ValueError(f"sanitize={sanitize!r} is not one of {sorted(SANITIZERS)}")
        name += "-" + SANITIZERS[sanitize][0]
    return os.path.join(BUILD_ROOT, name)


def _cxx() -> str:
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found on PATH: the native runtime builds with g++")
    return found


def build_runtime(sanitize: Optional[str] = None) -> str:
    """Build the native runtime from this checkout's sources if it is not
    built yet; returns its directory.  sanitize="thread" or "address"
    builds only the engine's unit tests under that sanitizer
    (`SANITIZERS`), in a directory of its own.

    Safe when several processes build at once: each compiles into a
    directory of its own and renames it into place (an atomic rename of a
    directory); the first to finish wins and the others use its build.
    Raises RuntimeError with the compiler's output when a build fails."""
    final = build_dir(sanitize)
    if os.path.isdir(final):
        return final
    cflags, ldflags = _python_flags()
    tmp = f"{final}.tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}"
    os.makedirs(tmp)
    stages = _targets(cflags, ldflags) if sanitize is None else _sanitizer_targets(sanitize)
    try:
        for stage in stages:
            procs = []
            for out, srcs, extra in stage:
                cmd = [_cxx(), *CXX_FLAGS, "-o", os.path.join(tmp, out),
                       *(os.path.join(_DIR, s) for s in srcs),
                       *(f.format(out=tmp) for f in extra)]
                procs.append((out, cmd, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
            for out, cmd, proc in procs:
                log, _ = proc.communicate(timeout=COMPILE_TIMEOUT_S)
                if proc.returncode != 0:
                    raise RuntimeError(f"g++ failed for {out} ({proc.returncode}):\n"
                                       f"{' '.join(cmd)}\n{log}")
        try:
            os.rename(tmp, final)
        except OSError:  # another process renamed its build into place first
            if not os.path.isdir(final):
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return final


def runtime_path(name: str) -> str:
    """The built file `name` (e.g. "ddsp_host", "ddsp~.pd_linux",
    "stream_test_tsan"), building the runtime, or the sanitizer build that
    makes it, if needed."""
    for sanitize, (_, out, _) in SANITIZERS.items():
        if name == out:
            return os.path.join(build_runtime(sanitize), name)
    return os.path.join(build_runtime(), name)


class StreamEngine:
    """Python handle on the C++ double-buffered engine.

    render: callable invoked on the engine's worker thread —
      with_audio=False: (pitch (n,), loudness (n,)) -> audio (n,)
      with_audio=True:  (pitch (n,), loudness (n,), audio_in (n,)) ->
                        audio (n,)  (the mfcc-autoencoder timbre-transfer
                        channel; ddsp_stream_create_audio)
    The result must hold n float32-convertible samples (numpy, or a CPU
    tensor); a render on the card returns its audio with `.cpu()`.
    """

    def __init__(self, block_size: int, render: Callable[..., np.ndarray], with_audio: bool = False):
        self._lib = lib = ctypes.CDLL(runtime_path("libddsp_stream.so"))
        lib.ddsp_stream_create.restype = ctypes.c_void_p
        lib.ddsp_stream_create.argtypes = [ctypes.c_int, _RENDER_CB, ctypes.c_void_p]
        lib.ddsp_stream_create_audio.restype = ctypes.c_void_p
        lib.ddsp_stream_create_audio.argtypes = [ctypes.c_int, _RENDER_AUDIO_CB, ctypes.c_void_p]
        lib.ddsp_stream_process.restype = ctypes.c_int
        lib.ddsp_stream_process.argtypes = [ctypes.c_void_p, _FP, _FP, _FP, ctypes.c_int]
        lib.ddsp_stream_process_audio.restype = ctypes.c_int
        lib.ddsp_stream_process_audio.argtypes = [ctypes.c_void_p, _FP, _FP, _FP, _FP, ctypes.c_int]
        for name in ("ddsp_stream_latency", "ddsp_stream_block"):
            getattr(lib, name).restype = ctypes.c_int
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        for name in ("ddsp_stream_blocks_rendered", "ddsp_stream_underruns"):
            getattr(lib, name).restype = ctypes.c_int64
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        lib.ddsp_stream_destroy.argtypes = [ctypes.c_void_p]

        self._render_py = render
        self.block_size = int(block_size)
        self.with_audio = with_audio
        self._size_warned = False

        def _emit(out_p, audio, n):
            # memmove reads raw bytes: the render result must be C-contiguous
            # float32 of exactly n samples, or we'd copy stride garbage /
            # read out of bounds on the realtime worker thread
            audio = np.ascontiguousarray(audio, np.float32).ravel()
            if audio.size != n:
                if not self._size_warned:
                    self._size_warned = True
                    print(f"[runtime] render returned {audio.size} samples, expected {n}; "
                          "emitting silence", flush=True)
                audio = np.zeros(n, np.float32)
            ctypes.memmove(out_p, audio.ctypes.data, n * ctypes.sizeof(ctypes.c_float))

        if with_audio:
            def _cb(pitch_p, loud_p, audio_p, out_p, n, _ctx):
                pitch = np.ctypeslib.as_array(pitch_p, (n,)).copy()
                loud = np.ctypeslib.as_array(loud_p, (n,)).copy()
                audio_in = np.ctypeslib.as_array(audio_p, (n,)).copy()
                _emit(out_p, self._render_py(pitch, loud, audio_in), n)

            self._cb = _RENDER_AUDIO_CB(_cb)  # keep a reference (GC safety)
            self._engine = lib.ddsp_stream_create_audio(self.block_size, self._cb, None)
        else:
            def _cb(pitch_p, loud_p, out_p, n, _ctx):
                pitch = np.ctypeslib.as_array(pitch_p, (n,)).copy()
                loud = np.ctypeslib.as_array(loud_p, (n,)).copy()
                _emit(out_p, self._render_py(pitch, loud), n)

            self._cb = _RENDER_CB(_cb)  # keep a reference (GC safety)
            self._engine = lib.ddsp_stream_create(self.block_size, self._cb, None)
        if not self._engine:
            raise RuntimeError("ddsp_stream_create failed")

    def process(self, pitch: np.ndarray, loudness: np.ndarray,
                audio: Optional[np.ndarray] = None) -> np.ndarray:
        """One audio tick: (n,) control in → (n,) audio out.  `audio` feeds
        the input-audio ring of a with_audio engine (None → silence)."""
        pitch = np.ascontiguousarray(pitch, np.float32)
        loudness = np.ascontiguousarray(loudness, np.float32)
        if loudness.shape != pitch.shape or pitch.ndim != 1:
            raise ValueError(f"need equal (n,) controls, got {pitch.shape} and {loudness.shape}")
        out = np.zeros_like(pitch)
        if audio is not None and not self.with_audio:
            # The plain engine would copy this into a ring the renderer
            # never reads — a silent no-op masking a caller mistake.
            raise ValueError("audio passed to a StreamEngine created with with_audio=False; "
                             "construct with with_audio=True to feed an input-audio ring")
        if audio is not None:
            audio = np.ascontiguousarray(audio, np.float32)
            if audio.shape != pitch.shape:
                raise ValueError(f"need (n,) audio like the controls, got {audio.shape}")
            rc = self._lib.ddsp_stream_process_audio(
                self._engine, pitch.ctypes.data_as(_FP), loudness.ctypes.data_as(_FP),
                audio.ctypes.data_as(_FP), out.ctypes.data_as(_FP), len(pitch))
        else:
            rc = self._lib.ddsp_stream_process(
                self._engine, pitch.ctypes.data_as(_FP), loudness.ctypes.data_as(_FP),
                out.ctypes.data_as(_FP), len(pitch))
        if rc != 0:
            raise ValueError(f"tick size {len(pitch)} must divide block size {self.block_size}")
        return out

    @property
    def latency(self) -> int:
        return self._lib.ddsp_stream_latency(self._engine)

    @property
    def blocks_rendered(self) -> int:
        return self._lib.ddsp_stream_blocks_rendered(self._engine)

    @property
    def underruns(self) -> int:
        return self._lib.ddsp_stream_underruns(self._engine)

    def close(self) -> None:
        if getattr(self, "_engine", None):
            self._lib.ddsp_stream_destroy(self._engine)  # joins the worker
            self._engine = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()


class ModelHost:
    """The model host (libddsp_model.so) driven through ctypes in this
    process: `ddsp_model_load` builds `make_stream_session(bundle,
    device=DDSP_DEVICE or "cuda")` in this interpreter, and `perform`
    renders through it exactly as the engine's worker, ddsp_host and
    `ddsp~` do.  The calls release the GIL; the host takes it back."""

    def __init__(self, bundle_dir: str):
        self._lib = lib = ctypes.CDLL(runtime_path("libddsp_model.so"))
        lib.ddsp_runtime_init.restype = ctypes.c_int
        lib.ddsp_runtime_init.argtypes = [ctypes.c_char_p]
        lib.ddsp_model_load.restype = ctypes.c_void_p
        lib.ddsp_model_load.argtypes = [ctypes.c_char_p]
        lib.ddsp_model_free.argtypes = [ctypes.c_void_p]
        lib.ddsp_model_perform.restype = ctypes.c_int
        lib.ddsp_model_perform.argtypes = [ctypes.c_void_p, _FP, _FP, _FP, ctypes.c_int]
        lib.ddsp_model_perform_audio.restype = ctypes.c_int
        lib.ddsp_model_perform_audio.argtypes = [ctypes.c_void_p, _FP, _FP, _FP, _FP, ctypes.c_int]
        for name in ("ddsp_model_needs_audio", "ddsp_model_block_size", "ddsp_model_sample_rate"):
            getattr(lib, name).restype = ctypes.c_int
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        if lib.ddsp_runtime_init(None) != 0:
            raise RuntimeError("ddsp_runtime_init failed")
        self._model = lib.ddsp_model_load(os.fsencode(bundle_dir))
        if not self._model:
            raise RuntimeError(f"ddsp_model_load failed for {bundle_dir} (the Python error is on stderr)")
        self.needs_audio = lib.ddsp_model_needs_audio(self._model) == 1
        self.block_size = lib.ddsp_model_block_size(self._model)
        self.sample_rate = lib.ddsp_model_sample_rate(self._model)

    def perform(self, pitch, loudness, audio=None) -> np.ndarray:
        """(n,) pitch and loudness (and input audio) → (n,) audio, through
        ddsp_model_perform_audio when `audio` is given, else
        ddsp_model_perform.  Raises RuntimeError when the host refuses."""
        pitch = np.ascontiguousarray(pitch, np.float32)
        loudness = np.ascontiguousarray(loudness, np.float32)
        out = np.zeros_like(pitch)
        n = len(pitch)
        if audio is None:
            rc = self._lib.ddsp_model_perform(self._model, pitch.ctypes.data_as(_FP),
                                              loudness.ctypes.data_as(_FP), out.ctypes.data_as(_FP), n)
        else:
            audio = np.ascontiguousarray(audio, np.float32)
            rc = self._lib.ddsp_model_perform_audio(
                self._model, pitch.ctypes.data_as(_FP), loudness.ctypes.data_as(_FP),
                audio.ctypes.data_as(_FP), out.ctypes.data_as(_FP), n)
        if rc != 0:
            raise RuntimeError(f"ddsp_model_perform{'_audio' if audio is not None else ''} "
                               f"refused {n} samples (rc {rc})")
        return out

    def close(self) -> None:
        if getattr(self, "_model", None):
            self._lib.ddsp_model_free(self._model)
            self._model = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()


def run_binary(name: str, *args: str, timeout: float, env: Optional[dict] = None,
               cwd: Optional[str] = None) -> tuple:
    """Run the built executable `name` with `args` (in `cwd`, with `env`);
    returns (returncode, stdout + stderr, seconds).  Raises
    subprocess.TimeoutExpired past `timeout` (the process is killed)."""
    t0 = time.perf_counter()
    r = subprocess.run([runtime_path(name), *args], capture_output=True, text=True, timeout=timeout,
                       env=env, cwd=cwd)
    return r.returncode, r.stdout + r.stderr, time.perf_counter() - t0
