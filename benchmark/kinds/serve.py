"""Served cells: realtime streaming sessions against the program's
StreamServer over loopback TCP.

Set-up writes the seed's weights as a bundle under TMPDIR, starts
`StreamServer(bundle)` in this process as serve.py does by default (one
voice a connection, dry, float32), warms it with a throwaway session, and
starts the load generator (benchmark/lib/loadgen.py) in a process of its
own on a CPU of its own, as a client on another machine would be; the
server keeps the others.  The window opens when every session is
connected: each sends one block every block period, from a start offset
drawn in the first period, one request outstanding.

`block_p50_ms` and `block_p99_ms` are taken over every block due in the
window, each timed from its due time to its reply's last byte; a block not
answered by the window's close is missing and sorts above every answered
one (lib/stats.py).

`correct`: once the window has closed and its replies have come, the plain
reference renders, in float64, every compared session from its start —
the sessions drawn from the seed, and the one that started first — from
the same controls and the same noise, and the served audio is held to it
(lib/judge.py).  The noise is drawn again from a copy of the generator the
program documents: a session's is seeded with the connection's number and
draws each step's frames.
"""

from __future__ import annotations

import gc
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from benchmark.harness import ROOT, Run
from benchmark.lib import judge, stats, traffic, wire
from benchmark.lib.card import sm_clock
from benchmark.lib.trace import Trace
from benchmark.lib.weights import make_weights, write_bundle
from benchmark.reference import ddsp

def _split_cpus():
    """(the server's CPUs, the load generator's CPU): the last CPU this
    process may use goes to the generator, where there are two or more."""
    cpus = sorted(os.sched_getaffinity(0))
    if len(cpus) < 2:
        return None, None
    return set(cpus[:-1]), cpus[-1]


def _pin_process(cpus) -> None:
    """Every thread of this process onto `cpus` (threads started later
    inherit it)."""
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), cpus)
        except OSError:  # a thread that has ended
            pass


def _warm_session(address, params, cfg, needs_audio) -> None:
    """A throwaway session of `warm_blocks` blocks (a server of one voice a
    connection has no warm-up of its own)."""
    m = cfg["model"]
    s = traffic.Session(index=-1, offset_s=0.0, f_a=220.0, f_b=440.0, level_db=-30.0,
                        swell_db=6.0, swell_s=2.0, swell_phase=0.0)
    sock, _ = wire.connect(*address)
    try:
        for i in range(int(params["warm_blocks"])):
            sock.sendall(wire.request(*traffic.block(s, i, m["block_size"], m["sample_rate"],
                                                     params["glide_s"], needs_audio)))
            wire.parse_response(wire.recv_exact(sock, wire.response_bytes(m["block_size"])),
                                m["block_size"])
    finally:
        wire.close(sock)


def _start_client(address, sessions, keep, params, cfg, needs_audio, seconds, cpu):
    m = cfg["model"]
    conf = {"host": address[0], "port": address[1], "sessions": [traffic.to_dict(s) for s in sessions],
            "period_s": m["block_size"] / m["sample_rate"], "block_size": m["block_size"],
            "sample_rate": m["sample_rate"], "needs_audio": needs_audio,
            "glide_s": params["glide_s"], "seconds": seconds, "drain_s": params["drain_s"],
            "keep_audio": sorted(keep)}
    p = subprocess.Popen([sys.executable, "-m", "benchmark.lib.loadgen"], cwd=ROOT,
                         stdin=subprocess.PIPE, stdout=subprocess.PIPE)
    if cpu is not None:
        os.sched_setaffinity(p.pid, {cpu})
    p.stdin.write((json.dumps(conf) + "\n").encode())
    p.stdin.flush()
    if p.stdout.readline().strip() != b"ready":
        p.kill()
        p.wait()
        raise RuntimeError("the load generator did not connect its sessions")
    return p


def _collect(p, timeout) -> dict:
    data, _ = p.communicate(timeout=timeout)
    if p.returncode != 0:
        raise RuntimeError(f"the load generator exited with {p.returncode}")
    with np.load(io.BytesIO(data)) as z:
        return {k: z[k] for k in z.files}


def _sleep_until(t: float) -> None:
    while True:
        left = t - time.monotonic()
        if left <= 0:
            return
        time.sleep(min(left, 0.5))


def _reference_audio(cfg, weights, sessions, n_blocks, noise, mean, std, params, device, dtype,
                     needs_audio):
    """The reference's render of each compared session, (n, block) numpy
    per session, the first block silent for an autoencoder session."""
    m, pre = cfg["model"], cfg["preprocess"]
    block, sr = m["block_size"], m["sample_rate"]
    p = {k: v.to(dtype) for k, v in weights.items()}
    lag = 1 if needs_audio else 0
    order = list(sessions)
    frames = max(n_blocks[s] - lag for s in order)
    f0 = torch.zeros((len(order), frames, 1), dtype=dtype, device=device)
    loud = torch.zeros_like(f0)
    nz = torch.zeros((len(order), frames, block), dtype=dtype, device=device)
    mfcc = None
    for r, s in enumerate(order):
        n = n_blocks[s] - lag
        blocks = [traffic.block(sessions[s], i, block, sr, params["glide_s"], needs_audio)
                  for i in range(n_blocks[s])]
        f0[r, :n, 0] = torch.as_tensor(np.array([b[0][0] for b in blocks[:n]], np.float64))
        loud[r, :n, 0] = torch.as_tensor(np.array([b[1][0] for b in blocks[:n]], np.float64))
        nz[r, :n] = noise[s][:n].to(dtype)
        if needs_audio:
            audio = torch.as_tensor(np.concatenate([b[2] for b in blocks]).astype(np.float64),
                                    device=device)[None].to(dtype)
            frames_s = ddsp.mfcc_frames(audio, pre, n)
            if mfcc is None:
                mfcc = torch.zeros((len(order), frames, frames_s.shape[-1]), dtype=dtype, device=device)
            mfcc[r, :n] = frames_s[0]
    steps = ddsp.stream_steps(frames, pre, needs_audio)
    with torch.no_grad():
        out = ddsp.stream_render(p, cfg, f0, (loud - mean) / std, nz, steps, mfcc)
    out = out.reshape(len(order), frames, block).cpu().numpy()
    result = {}
    for r, s in enumerate(order):
        rendered = out[r, : n_blocks[s] - lag]
        if lag:
            rendered = np.concatenate([np.zeros((1, block)), rendered])
        result[s] = rendered
    return result


def _session_noise(seed: int, n_frames: int, pre: dict, block: int, device, needs_audio: bool):
    """A session's noise: its generator (seeded with the
    session's number) draws each call's frames, in order."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.cat([torch.rand((1, n, block), generator=gen, device=device)[0] * 2.0 - 1.0
                      for n in ddsp.stream_steps(n_frames, pre, needs_audio)])


def run(cfg, params, limits, seed, seconds, trace, device, mono_start) -> Run:
    from ddsp_pytorch_tpu_torch.serve import StreamServer

    m, pre = cfg["model"], cfg["preprocess"]
    block, sr = m["block_size"], m["sample_rate"]
    period = block / sr
    n_sessions = int(params["sessions"])
    needs_audio = m["name"] == "mfcc-autoencoder"
    mean, std = float(params["mean_loudness"]), float(params["std_loudness"])
    server_cpus, client_cpu = _split_cpus()
    if server_cpus is not None:
        _pin_process(server_cpus)
    weights = make_weights(cfg, seed, device)
    tmp = tempfile.mkdtemp(prefix="ddsp_bench_")
    proc, server = None, None
    try:
        bundle = write_bundle(cfg, weights, mean, std, os.path.join(tmp, "bundle"))
        tracer = None
        if trace:
            tracer = Trace(device)
            tracer.start()  # the profiler's first start initialises it: not in the window
            tracer.stop()
        server = StreamServer(bundle, device=device)
        server.start()
        _warm_session(server.address, params, cfg, needs_audio)
        warm = 1  # connections the warm-up made
        sessions = traffic.sessions(seed, n_sessions, period)
        rng = np.random.default_rng([seed % 2**64, 11])
        n_keep = min(int(params["compared_sessions"]), n_sessions)
        keep = set(rng.choice(n_sessions, size=n_keep, replace=False).tolist())
        keep.add(min(sessions, key=lambda s: s.offset_s).index)
        proc = _start_client(server.address, sessions, keep, params, cfg, needs_audio, seconds,
                             client_cpu)
        t0 = time.monotonic() + 0.05
        proc.stdin.write(f"go {t0!r}\n".encode())
        proc.stdin.flush()
        t_close = t0 + seconds
        if tracer is not None:  # the window's last trace_s seconds
            _sleep_until(t_close - min(float(params["trace_s"]), seconds / 2))
            tracer.start()
        _sleep_until(t_close)
        if tracer is not None:
            tracer.stop()
        clock = sm_clock()
        results = _collect(proc, timeout=params["drain_s"] + 120)
        proc = None
        memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        server.stop()
    finally:
        if proc is not None:
            proc.kill()
            proc.wait()

    # ------------------------------------------------------ latencies
    lat, lateness = [], []
    unanswered = n_missing = 0
    answered = {}
    for s in sessions:
        n_due = max(0, math.ceil((t_close - t0 - s.offset_s) / period))
        due = t0 + s.offset_s + period * np.arange(n_due)
        got = results[f"arrived_{s.index}"]
        arrived = np.full(n_due, np.nan)
        arrived[: min(len(got), n_due)] = got[:n_due]
        lat.append(stats.block_latencies(due, arrived, t_close))
        n_missing += n_due - int(np.sum(np.isfinite(arrived) & (arrived <= t_close)))
        lateness.append(results[f"sent_{s.index}"] - results[f"due_{s.index}"])
        unanswered += int(np.sum(~np.isfinite(got)))
        answered[s.index] = int(np.sum(np.isfinite(got)))
    lat = np.concatenate(lat)
    lateness = np.concatenate(lateness)

    # ---------------------------------------------------- correctness
    del server
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    compared = sorted(keep)
    n_blocks = {s: answered[s] for s in compared if answered[s] > (1 if needs_audio else 0)}
    noise = {s: _session_noise(warm + s, n_blocks[s] - (1 if needs_audio else 0), pre, block,
                               device, needs_audio) for s in n_blocks}
    served = {s: results[f"audio_{s}"][: n_blocks[s]] for s in n_blocks}
    ref = _reference_audio(cfg, weights, {s: sessions[s] for s in n_blocks}, n_blocks, noise, mean,
                           std, params, device, torch.float64, needs_audio)
    pairs = ([served[s] for s in n_blocks], [ref[s] for s in n_blocks])
    rms = judge.audio_rms_gap(*pairs) if n_blocks else float("inf")
    widest = judge.audio_gap(*pairs) if n_blocks else float("inf")
    ref_s = time.perf_counter() - t_ref
    shutil.rmtree(tmp, ignore_errors=True)
    checks = {"audio_rms_gap": [rms, float(limits["audio_rms_gap"])],
              "unanswered": [float(unanswered), 0.0]}

    info = {
        "samples": f"{lat.size} blocks due in the window, {n_missing} missing; "
                   f"p90 {1e3 * stats.nearest_rank(lat, 0.90):.4f} ms, p95 {1e3 * stats.nearest_rank(lat, 0.95):.4f} ms, mean {1e3 * float(np.mean(lat)):.4f} ms",
        "generator": f"late by p50 {1e3 * np.median(lateness):.4f} ms, "
                     f"p99 {1e3 * stats.nearest_rank(lateness, 0.99):.4f} ms, "
                     f"max {1e3 * np.max(lateness):.4f} ms",
        "set-up": f"{t0 - mono_start:.4f} s",
        "cpus": f"server {sorted(server_cpus) if server_cpus else 'all'}, load generator {client_cpu}",
        "sm_clock": clock,
        "reference": f"{len(n_blocks)} sessions, {sum(n_blocks.values())} blocks in {ref_s:.3f} s",
        "audio_gap, the widest over the peak (not compared)": widest,
    }
    if tracer is not None:
        info["trace"] = (f"{len(tracer.device_ops)} device operations, {len(tracer.kernels())} kernels, "
                         f"{len(tracer.host_ops)} host operations over {tracer.window_s:.4f} s "
                         f"(the profiler took {tracer.start_s:.4f} s to start)")
    return Run(
        e2e={"block_p50_ms": 1e3 * stats.nearest_rank(lat, 0.50),
             "block_p99_ms": 1e3 * stats.nearest_rank(lat, 0.99),
             "setup_s": t0 - mono_start},
        attempted=int(lat.size), failed=n_missing, checks=checks, memory_peak_bytes=memory_peak,
        info=info, trace=tracer,
    )
