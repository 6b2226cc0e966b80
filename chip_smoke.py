#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving, training, pitch-tracking, timbre-transfer,
benchmark, drift-soak and native realtime paths and check them.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases (any failure raises, so the exit code is nonzero and no result line
is printed):
  1. card: name and power limit, torch version, build of every hand-written
     kernel from the sources in this checkout (one nvcc per source, all
     started together); each kernel function's registers and spill bytes
     from `-Xptxas -v`, no spill in the K = 64 variants nor in the probes,
     and the fma probe's FFMA count in its SASS (the chain not folded);
  2. kernels: every variant of each kernel (K = 64 template or runtime K,
     few- or many-row configuration) against its plain PyTorch version on
     the card at the serving shape and at larger shapes (the forward also
     against a float64 numpy oracle), with its time, the plain version's
     time, the bound and the share of the bound, at the pool's shapes too
     (R = 2, 256, 1024, 2048), timbre transfer's (R = 281), the headline's
     (R = 128, K = 100), the realtime soak's (R = 2, K = 100) and the drift
     soak's (R = 16 and 64, K = 8); both
     roofline probes against their plain versions in float32 and float64;
     OscillatorBank's gradients
     (both kernels) against autograd through the plain forward at the
     training shape;
  3. streaming: make_streaming_synth on the full-width violin bundle streams
     64 blocks of a glide on the card and on the CPU (plain versions); the
     two agree, the kernel's launch counter rose by one per block, and the
     per-block render time is reported against the realtime budget; then
     64 blocks with noise on (the noise generator's state carried by value),
     its render times and the host cost of that state's round trip, and a
     replayed StreamState giving identical audio on the card;
  4. server: StreamServer on the card answers two clients' block-sized
     requests (phase continues across requests, sessions are independent,
     deterministic sessions repeat);
  5. training at configs/config.yaml's full width: one train step on the
     card against the same step on the CPU (loss and every gradient), and
     each of the two against the same step on the CPU in float64 (every
     leaf's error printed); then
     Trainer.fit on a fresh model for a few tens of steps (batch 16 × 375
     frames, six scales, Adam 1e-3, reverb on) on a 16-item cache of glides
     whose targets the violin bundle renders on the card: every loss finite,
     no skipped update, the loss falls, one launch of each kernel per step;
  6. the train step as a CUDA graph at configs/config.yaml's full width:
     from one state and the same 10 batches of the device-resident cache,
     10 eager steps against one call of steps_per_call 10 replaying a graph
     of U = 1 and of U = 2 steps (per-step losses and every parameter leaf
     within 1e-6 relative; whether bitwise equal is printed), then ms per
     step synced for both, the capture time, the graph pool and the peak
     memory of each;
  7. a run at a committed config: Trainer.fit at
     pretrained/ddsp_violin_config.yaml (steps_per_call 25, batch 8, six
     scales) with the device-resident loader for 100 steps, only its cache,
     steps, validation and checkpoint intervals overridden: the loss falls,
     both kernels ran inside the graph on every step; a second run,
     preempted by SIGTERM after its second call, resumes to 100 steps and
     ends equal to the first (1e-6 relative, the same generator state);
  8. export and serve: export_run on that run, the exported bundle streamed
     for 64 blocks on the card against the CPU plain stream, a StreamServer
     answering two requests, the impulse read back with `wave` (first tap
     within 2e-2 of 1);
  9. roofline: bench_roofline.run, the counterpart of the TPU script's
     measure_vpu_rates_pallas + add_vpu_model: the fma and sin probe
     kernels at each block size, their rates (FMA/s, FP32 TFLOP/s against
     67, sinf/s) at the fastest, the SM clock and power polled during 2 s
     of the fma probe, and each oscillator kernel's share of its
     instruction-mix bound at R = 1, 2, 1024, 2048, 3000 and 6000 from
     phase 2's times;
 10. pool: a VoicePool of 3 violin voices on the card (deterministic
     noise) against three independent batch-1 streams and against the same
     pool on the CPU; a released slot streams like a fresh one; the
     in-stream reverb against the offline fft_convolve of the same dry
     stream; a StreamServer(voices=4) answering 4 concurrent clients; then
     the voice ramp (V = 1 … 2048, profile_serving.RAMP_VOICES; dry, and
     with the reverb): per-block p50/p99 of VoicePool.step and voices per
     card, the largest V below the first that misses the budget;
 11. autoencoder: pretrained/ddsp_violin_ae_bundle through
     make_stream_session on the card against the CPU, on a 220–440 Hz
     harmonic input (audible, and its render p50/p99), then through
     StreamServer at voices = 1 and voices = 4 with 4 concurrent clients
     (pooled equals unpooled with deterministic noise);
 12. autoencoder training (the path that made pretrained/ddsp_violin_ae_bundle):
     train_pretrained.render_corpus renders the synthetic violin corpus on
     the card (2 × 24 notes of 4 s at 48 kHz, MFCCs at the 0 dB
     reference; one forward-kernel launch a partition), its first note
     checked against the CPU plain render (audio 1e-4 of the peak, pitch
     bitwise, loudness and MFCCs); Trainer.fit at
     pretrained/ddsp_violin_ae_config.yaml (steps_per_call 25, batch 8,
     device cache) for 100 steps, only its cache, steps and intervals
     overridden: losses finite and falling, both kernels replayed inside
     the graph on every step, the loss at steps 0 and 100 printed beside
     pretrained/violin_ae_loss.json's; 10 AE steps graphed against 10
     eager at configs/autoencoder.yaml's batch 16 (1e-6 relative), ms per
     step, graph pool and peak memory of each; export_run on the 100-step
     run (parameters bit for bit), the bundle streamed through
     make_stream_session on the card against the CPU and served by a
     StreamServer; the train_pretrained CLI for 25 steps into a temporary
     --out; preprocess_folder (YIN) on two wav files written from the
     corpus, one at 44.1 kHz, on the card against the CPU;
 13. pitch trackers and timbre transfer: the shipped CREPE (tiny,
     pretrained/crepe_tiny.msgpack) on 2048 frames on the card against
     the CPU (salience 1e-5), again with TF32 allowed globally, and its
     frames/s; extract_pitch_crepe and extract_pitch_hybrid on a 4 s 48 kHz
     glide with a -20 dB pink-noise floor on the card against the CPU
     (Viterbi paths equal on every frame, f0 within 1 cent, RPA@50c = 1 on
     the voiced frames against the known f0), seconds a call, one hybrid
     call by stage and traced (device idle share, kernels); preprocess_folder
     at configs/config.yaml (hybrid) on two wavs, one at 44.1 kHz, card vs
     CPU; timbre_transfer through pretrained/ddsp_sigmund_bundle (hybrid,
     decoder) and pretrained/ddsp_violin_ae_bundle (autoencoder) on a 3 s
     220 Hz input at octave shifts 0 and +1 (length F·512, finite, the
     harmonic-only render's YIN median within 3 % of 220 / 440 Hz (the
     sigmund model's noise branch dominates its full output at this
     input's loudness); harmonic-only, the CPU's controls rendered on the
     card within 1e-3 of the CPU render's peak and the whole path within
     1e-2 (the f0 controls within 1e-5 relative); one forward launch a
     call, seconds a call and the realtime factor), and the transfer CLI
     into a temporary file;
 14. headline: the port's bench.py (×-realtime at 48 kHz, 100 harmonics,
     hidden 512, batch 1: the best of 8 protocol runs of 20 synchronized
     calls, and the value-pull figure), one forward launch a call, then
     performance.py on the violin bundle at batch 1;
 15. drift soak: soak.py's phase drift over 1e7 samples on the card (the
     float32 phase carry within 1e-3 rad of the float64 oracle at every
     checkpoint, finite audio, the GRU carry within ±1) and on the CPU (the
     card's phase within 1e-3 rad of the CPU's), and its pool churn over
     2e6 samples (a long-lived slot within 1e-5 of its independent stream);
 16. realtime path: build_runtime() (g++) from this checkout and
     stream_test; the CPython-embedded model host through ctypes in this
     process on the violin and violin-AE bundles, equal to the Python
     session on the card (1e-5) and, noise off, to the CPU plain session
     (1e-4 and 1e-3 of the peak), one forward launch a rendered block, its
     perform ms beside the session's; ddsp_host for 10 s of audio (its
     timing report); pd_mock_test rendering the violin bundle through
     ddsp~; selftest --soak 30 at realtime pacing: no underrun, render
     p50/p99 against the 21.3 ms engine-block budget;
 17. report: one JSON line {"kernels": [...]} (all four kernels; launches by
     path: serving, training, training_graphed (host launches plus graph
     replays), serving_exported, serving_pool, serving_autoencoder,
     synthetic, training_autoencoder, timbre_transfer, headline, drift_soak,
     runtime_host and, for the probes, roofline; the forward's `launches`
     is the headline's, its times at the headline's shape), the card's
     name and power limit, and last {"ok": true, "device": {...}}.

Imports torch, numpy, the standard library and ddsp_pytorch_tpu_torch only.
Exits nonzero when torch.cuda.is_available() is false.
"""

from __future__ import annotations

import copy
import functools
import json
import os
import re
import shutil
import signal
import sys
import tempfile
import threading
import time
import wave

import numpy as np
import torch

from ddsp_pytorch_tpu_torch import bench, bench_roofline, export, performance, runtime, serve, soak, train_pretrained, transfer
from ddsp_pytorch_tpu_torch.bundle import read_meta
from ddsp_pytorch_tpu_torch.config import Config
from ddsp_pytorch_tpu_torch.data import Datamodule, Dataset, DeviceDataLoader, make_synthetic_dataset
from ddsp_pytorch_tpu_torch.data.preprocess import preprocess_folder
from ddsp_pytorch_tpu_torch.export import (
    export_run,
    load_bundle,
    make_stream_session,
    make_streaming_synth,
    run_params,
)
from ddsp_pytorch_tpu_torch.kernel_bench import (
    card_line,
    oscillator_bound,
    oscillator_bwd_bound,
    oscillator_inputs,
    sleep_cycles_per_ms,
    time_ms,
)
from ddsp_pytorch_tpu_torch.inference import render, timbre_transfer, transfer_controls
from ddsp_pytorch_tpu_torch.models import DDSPAutoencoder, DDSPDecoder, crepe, init_params
from ddsp_pytorch_tpu_torch.ops import fft_convolve, kernels, multiscale_fft, roofline
from ddsp_pytorch_tpu_torch.ops import oscillator as osc
from ddsp_pytorch_tpu_torch.ops.pitch import extract_pitch, switch_cost, yin_emission
from ddsp_pytorch_tpu_torch.profile_serving import (
    PROFILER_ACTIVITIES,
    RAMP_VOICES,
    device_kernels,
    glide,
    voice_ramp,
    voices_per_card_text,
)
from ddsp_pytorch_tpu_torch.profile_training import glide_controls
from ddsp_pytorch_tpu_torch.runtime import ModelHost, selftest
from ddsp_pytorch_tpu_torch.streaming.pool import VoicePool
from ddsp_pytorch_tpu_torch.training import Trainer, make_optimizer
from ddsp_pytorch_tpu_torch.training.loss import multiscale_spec_loss
from ddsp_pytorch_tpu_torch.training.metrics import read_metrics
from ddsp_pytorch_tpu_torch.training.state import TrainState
from ddsp_pytorch_tpu_torch.training.train import (
    loss_and_grads,
    make_train_multi_step_indexed,
    make_train_step,
    metrics_row,
    to_device,
)
from ddsp_pytorch_tpu_torch.utils import resample_poly, save_wav

BUNDLE = "pretrained/ddsp_violin_bundle"
SEED = 0
# Pallas-vs-XLA bound of the JAX suite (tests/test_oscillator.py:156) and the
# 64-harmonic recurrence-vs-f64 bound (tests/test_oscillator.py:165).
KERNEL_VS_PLAIN_ATOL = 5e-4
KERNEL_VS_F64_ATOL = 1e-3
# GPU vs CPU streaming: the same arithmetic, summed in other orders by
# cuBLAS and the CPU BLAS, over 64 carried GRU steps.
STREAM_GPU_VS_CPU_ATOL = 1e-4
# Backward kernel vs its plain version, each output relative to its largest
# magnitude: f32 sums over S = 64–512 samples in other orders (domega's
# terms carry the factor i+1 and reach 10^4–10^5).
BWD_VS_PLAIN_REL = 1e-4
# GPU vs CPU train step at full width, from fresh init_params weights.
# Loss: a sum of means over every STFT bin, two FFT libraries: 1e-4
# relative.  Gradients: the whole gradient within STEP_GRAD_REL relative L2
# error; every leaf's error within STEP_LEAF_OF_WHOLE of the whole
# gradient's norm; harmonic_proj.weight, which the two kernels feed, within
# STEP_HARMONIC_REL of its own norm.  A tighter rule per leaf would test
# f32 conditioning, not the port: the loss's log term differentiates to
# 1/(S + 1e-7) on near-silent bins, where the reconstruction is the noise
# branch (~1e-5 at its -5 bias) plus the bank's rounding residue.  Measured
# on the card's host at this step's input: a 1e-7 relative change of the
# injected noise or of the loudness moves noise_proj's gradient by 17-29 %;
# loudness_mlp.Dense_0.bias is carried by one frame whose normalized
# loudness is 0.0019, where LayerNorm_0's 1/sigma is ~460; and rounding the
# bank's recurrence once (the kernel's FMA) instead of twice moves the
# whole gradient by 1.1e-2 on the CPU.
STEP_LOSS_REL = 1e-4
STEP_GRAD_REL = 2e-2
STEP_LEAF_OF_WHOLE = 1e-2
STEP_HARMONIC_REL = 0.1
CONFIG = "configs/config.yaml"
VIOLIN_CONFIG = "pretrained/ddsp_violin_config.yaml"
N_TRAIN_STEPS = 40
# graphed against eager steps from one state on the same batches: each
# step's loss and every parameter leaf, max |Δ| over the leaf's largest
# magnitude (the same kernels on the same inputs)
GRAPHED_REL = 1e-6
N_GRAPH_STEPS = 10
N_TIMED_CALLS = 3  # graphed calls of N_GRAPH_STEPS steps timed
N_TIMED_EAGER = 20
# the violin-config run: its own steps_per_call (25), batch 8 and scales;
# 4 calls, validation twice, a checkpoint after the second call
N_VIOLIN_STEPS = 100
VIOLIN_VAL_EPOCHS = 25
VIOLIN_CHECKPOINT_STEPS = 50
# The mean of the first 5 losses over that of the last 5 in the 40-step
# fresh-init run: 1.66 on the first full run (NVIDIA H100 80GB HBM3,
# 700.00 W); the check asks for 1.3.
LOSS_FALL_FACTOR = 1.3
N_TRAIN_ITEMS, N_VAL_ITEMS = 16, 4
N_BLOCKS = 64
N_REQUESTS = 8
# Phase 2's shapes (rows, harmonics, samples): the serving row, the training
# rows of configs/config.yaml (16 × 375 frames) and of the violin run config
# (8 × 375, the graphed path of phase 7), a ragged count with a K that takes
# the runtime-K variants, the same K at the training rows, a one-harmonic
# edge case, and the pool's rows (phases 10-11: 2 voices, and the voice
# ramp's 256, 1024 and 2048, the last two past the forward's many-row
# switch).  Phase 9 reads its oscillator times from here.
# Together they launch every variant and configuration of both kernels at
# the main paths' shapes.
GRAPHED_SHAPE = (3000, 64, 512)
# phase 13d's shape: timbre transfer renders a 3 s 48 kHz clip (281 frames)
# in one launch
TRANSFER_SHAPE = (281, 64, 512)
# phase 14's shape: the headline renders 128 frames of a 100-harmonic voice
# a call (the runtime-K variant); the forward's JSON entry is taken here.
# Phases 15-16: the realtime soak's engine block (2 frames, 100 harmonics),
# the drift soak's call (16 frames, 8 harmonics) and its 4-voice pool's
HEADLINE_SHAPE = (128, 100, 512)
KERNEL_SHAPES = ((1, 64, 512), (6000, 64, 512), GRAPHED_SHAPE, (37, 100, 512), (6000, 100, 512),
                 (5, 1, 64), (2, 64, 512), (256, 64, 512), (1024, 64, 512), (2048, 64, 512), TRANSFER_SHAPE,
                 HEADLINE_SHAPE, (2, 100, 512), (16, 8, 512), (64, 8, 512))
# The exported 100-step model's stream: GPU vs CPU within this share of the
# stream's peak as well as STREAM_GPU_VS_CPU_ATOL (the model plays near
# silence, where that absolute bound alone could not fail a wrong kernel).
EXPORT_STREAM_REL_OF_PEAK = 1e-3
AE_BUNDLE = "pretrained/ddsp_violin_ae_bundle"
# Probes against their plain versions: the fma chain bit for bit (c rounds
# to 1 on the script's input, so one rounding of c·s − p equals two); the
# sin chain within 1e-6 (torch's sin kernel against the kernel's sinf, 4
# nested calls); both within 1e-6 of the same chains in float64.
PROBE_SIN_ATOL = 1e-6
PROBE_VS_F64_ATOL = 1e-6
# The fma probe's SASS keeps its chain: 2·256 FFMAs, less the last
# iteration's update of s, which nothing reads.
PROBE_MIN_FFMA = 2 * roofline.FMA_DEPTH - 1
N_POOL_VOICES, N_POOL_BLOCKS = 3, 32
# a released slot against a fresh one: the same kernels on the same inputs
RELEASED_SLOT_ATOL = 1e-6
# the in-stream reverb (1 s IR, 94 partitions) against the offline FFT
# convolution of the same dry stream: the JAX suite's bound
# (tests/test_partitioned_conv.py:35), and 1e-3 of the wet stream's peak
REVERB_VS_OFFLINE_ATOL = 2e-4
RAMP_BLOCKS, RAMP_REVERB_BLOCKS = 200, 100
N_SERVER_VOICES = 4
# pooled (batch 4) against unpooled (batch 1) sessions on the card: cuBLAS
# may take other GEMM kernels at the two batch sizes
POOLED_VS_UNPOOLED_ATOL = 1e-4
AE_CONFIG = "configs/autoencoder.yaml"
AE_VIOLIN_CONFIG = "pretrained/ddsp_violin_ae_config.yaml"
JAX_AE_LOSS = "pretrained/violin_ae_loss.json"  # the JAX run that made the AE bundle
AE_ITEMS = 24  # notes a partition, as scripts/train_pretrained.py renders
N_AE_STEPS = 100
AE_INTERVAL_EPOCHS = 10  # validation and best-params epochs of the 100-step run (3 steps an epoch)
AE_CHECKPOINT_STEPS = 50
N_CLI_STEPS = 25  # one graphed call of the train_pretrained CLI
# the card's corpus against the CPU plain render of its first note: audio
# within 1e-4 of the peak (the forward kernel against its plain version,
# K = 48); loudness 1e-3 and MFCCs 1e-3 of their peak (cuFFT against
# pocketfft on the same audio, tests/test_torch_synthetic.py)
CORPUS_REL_OF_PEAK = 1e-4
LOUDNESS_ATOL = 1e-3
MFCC_REL_OF_PEAK = 1e-3
# YIN on the card against the CPU: f0 within 1e-3 relative on all but 1 % of
# the frames (a path may take another bin where costs tie within the two
# FFT libraries' rounding, in near-silent frames)
PITCH_RTOL, PITCH_FRAMES_AGREE = 1e-3, 0.99
CREPE_PARAMS = "pretrained/crepe_tiny.msgpack"
SIGMUND_BUNDLE = "pretrained/ddsp_sigmund_bundle"  # hybrid-tracked, single-inst-decoder
N_CREPE_FRAMES = 2048
# CREPE on the card against the CPU, TF32 allowed globally or not: the
# salience within 1e-5 (the tests' bound against the JAX package)
CREPE_SALIENCE_ATOL = 1e-5
# the trackers on the card against the CPU: f0 within 1 cent on every
# frame (with equal Viterbi paths); against the known f0, every voiced
# frame within 50 cents (RPA@50c = 1)
TRACK_CENTS, RPA_CENTS = 1.0, 50.0
# timbre transfer: the harmonic-only output's YIN median within 3 % of
# the input's (shifted) 220 Hz.  Card against CPU, harmonic-only: the f0
# controls within 1e-5 relative (the tests' bound against JAX); the CPU's
# controls rendered on the card within 1e-3 of the CPU render's peak; the
# whole path within 1e-2 of it: the f0 tracks differ by ~1e-7-1e-6
# relative (two FFT libraries' rounding under the trackers), which the
# oscillator integrates into a phase drift of 2π·f0·t·δ, 8e-3 rad at
# 440 Hz after 3 s at δ = 1e-6 (measured: 1.9e-3 of the peak, the violin AE
# at +1 octave, NVIDIA H100 80GB HBM3, 700.00 W)
TRANSFER_F0_REL, TRANSFER_CONTROL_F0_REL = 0.03, 1e-5
TRANSFER_REL_OF_PEAK, TRANSFER_WHOLE_REL_OF_PEAK = 1e-3, 1e-2
# the drift soak (phase 15): 1e7 samples of phase drift (1220 calls of 16
# frames), 2e6 of pool churn; the phase carry within 1e-3 rad of the float64
# oracle (the port's error walks one float32 rounding a call, at most
# 2.4e-7 rad: ~1e-5 expected), the card's phase within 1e-3 rad of the
# CPU's, a pooled slot within 1e-5 of its independent stream
SOAK_SAMPLES, SOAK_POOL_SAMPLES = int(1e7), int(2e6)
DRIFT_MAX_RAD, POOL_ISOLATION_ATOL = 1e-3, 1e-5
# the model host against the Python session on the card (the same session,
# driven through the embedded interpreter)
HOST_VS_SESSION_ATOL = 1e-5
N_HOST_BLOCKS = 64
DDSP_HOST_SECONDS = 10
REALTIME_SOAK_SECONDS = 30


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def ptxas_report(log: str) -> dict:
    """{kernel function: (spill store bytes, spill load bytes, registers)}
    from nvcc's `-Xptxas -v` output."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn:
            out[fn] = [int(m.group(1)), int(m.group(2)), None]
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn in out:
            out[fn][2] = int(m.group(1))
            fn = None
    return out


def check_spills(name: str, log: str) -> None:
    """Print each kernel function's ptxas line; the K = 64 instantiations
    (the main path's, template argument 64) and the probes must not spill.
    For the probes, also each function's FFMA count in its SASS: the fma
    probe's chain must not be folded."""
    report = ptxas_report(log)
    probes = name == "roofline_probe"
    if probes:
        checked = list(report)
        ffma = {fn: len(re.findall(r"\bFFMA\b", text)) for fn, text in kernels.sass(name).items()}
    else:
        checked = [f for f in report if f"ILi{osc.KERNEL_FIXED_K}E" in f]
        ffma = {}
    check(bool(checked), f"no checked variant of {name} in the ptxas report")
    for fn, (stores, loads, regs) in sorted(report.items()):
        m = re.search(r"\d((?:oscillator|roofline)_\w+?_kernel(?:I\w*?E)?)", fn)
        extra = f" sass_ffma={ffma[fn]}" if fn in ffma else ""
        print(f"ptxas {name} {m.group(1) if m else fn}: registers={regs} "
              f"spill_stores={stores} B spill_loads={loads} B{extra}", flush=True)
    for fn in checked:
        check(report[fn][0] == 0 and report[fn][1] == 0, f"{fn} spills: {report[fn]}")
    if probes:
        fma_fn = [fn for fn in ffma if "roofline_fma_kernel" in fn]
        check(len(fma_fn) == 1, f"fma probe not found in the SASS: {sorted(ffma)}")
        check(ffma[fma_fn[0]] >= PROBE_MIN_FFMA,
              f"fma probe has {ffma[fma_fn[0]]} FFMA in its SASS, fewer than {PROBE_MIN_FFMA}: folded")
        sin = bench_roofline.sin_probe_sass(torch.device("cuda", 0))
        print(f"sass roofline_sin_kernel fast path: {sin['fp32_per_element']} FP32 instructions an element, "
              f"{sin['fp32_per_sinf']:.3f} a sinf (less the chain's {roofline.SIN_OTHER_PER_ELEMENT} adds and "
              f"folds); opcodes {sin['fast_path_opcodes']}", flush=True)
        check(sin["fp32_per_sinf"] > 1, f"sin probe fast path {sin}")


def rel_err(got, want) -> float:
    """max |got − want| over max |want|."""
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def oscillator_f64(phi, omega, amp, s: int) -> np.ndarray:
    """Literal y = Σ_k A_k sin(k θ), θ = φ + (i+1) ω, in float64."""
    theta = phi.astype(np.float64)[:, None] + omega.astype(np.float64)[:, None] * np.arange(1, s + 1)
    out = np.zeros_like(theta)
    for j in range(amp.shape[1]):
        out += amp[:, j : j + 1].astype(np.float64) * np.sin((j + 1) * theta)
    return out


def phase_kernels(device, kernel_ms: dict) -> dict:
    """Phase 2: the oscillator kernel against its plain version and the
    float64 oracle; times at every shape, also put in `kernel_ms` (keyed
    as bench_roofline keys them).  Returns the entry at the headline's
    shape."""
    rng = np.random.default_rng(SEED)
    cycles_per_ms = sleep_cycles_per_ms()
    entry = None
    for rows, k, s in KERNEL_SHAPES:
        phi, omega, amp = oscillator_inputs(rng, rows, k)
        args = [torch.tensor(x, device=device) for x in (phi, omega, amp)]
        got = osc.oscillator_bank(*args, s)
        plain = osc.oscillator_bank_plain(*args, s)
        torch.cuda.synchronize()
        check(got.shape == (rows, s) and bool(torch.isfinite(got).all()), "kernel output")
        err = float((got - plain).abs().max())
        check(err <= KERNEL_VS_PLAIN_ATOL, f"kernel vs plain {err} at R={rows} K={k} S={s}")
        err64 = None
        if k == 64:
            err64 = float(np.abs(got.cpu().numpy() - oscillator_f64(phi, omega, amp, s)).max())
            check(err64 <= KERNEL_VS_F64_ATOL, f"kernel vs f64 {err64} at R={rows}")
        # at most ~1000 queued launches (the plain version makes ~4K + 8 per
        # call), so the host never waits on a full launch queue while timing
        ms, call_ms = time_ms(lambda: osc.oscillator_bank(*args, s), 200, cycles_per_ms)
        plain_ms, plain_call_ms = time_ms(
            lambda: osc.oscillator_bank_plain(*args, s), max(1, min(20, 1000 // (4 * k + 8))),
            cycles_per_ms,
        )
        kernel_ms["oscillator_fwd", rows, k, s] = ms
        bound_ms, bound_by = oscillator_bound(rows, k, s)
        print(
            f"oscillator_fwd R={rows} K={k} S={s} [{osc.kernel_variant(k)}]: "
            f"max|kernel-plain|={err:.3e} "
            f"max|kernel-f64|={err64 if err64 is None else f'{err64:.3e}'} "
            f"kernel_ms={ms:.6f} plain_ms={plain_ms:.6f} bound_ms={bound_ms:.6f} ({bound_by}) "
            f"share_of_bound={bound_ms / ms:.3f} "
            f"host_call_ms: kernel={call_ms:.6f} plain={plain_call_ms:.6f}",
            flush=True,
        )
        if (rows, k, s) == HEADLINE_SHAPE:
            entry = {
                "name": "oscillator_fwd",
                "route": "cuda",
                "source": "ddsp_pytorch_tpu_torch/ops/kernels/oscillator_fwd.cu",
                "replaces": "ddsp_pytorch_tpu/ops/pallas_kernels/oscillator.py:41",
                "launches": None,
                "max_abs_err": err,
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "library_ms": None,  # no single PyTorch call computes this bank
                "rows_harmonics_samples": list(HEADLINE_SHAPE),
            }
    return entry


def phase_bwd_kernel(device, kernel_ms: dict) -> dict:
    """Phase 2, backward: the kernel against its plain version at every
    shape, timed by the forward's method (into `kernel_ms`);
    OscillatorBank's gradients against autograd through the plain forward
    at the training shape.  Returns the entry at the graphed training
    path's shape."""
    rng = np.random.default_rng(SEED + 1)
    cycles_per_ms = sleep_cycles_per_ms()
    entry = None
    for rows, k, s in KERNEL_SHAPES:
        phi, omega, amp = oscillator_inputs(rng, rows, k)
        g = rng.standard_normal((rows, s)).astype(np.float32)
        args = [torch.tensor(x, device=device) for x in (phi, omega, amp, g)]
        got = osc.oscillator_bank_bwd(*args, s)
        plain = osc.oscillator_bank_bwd_plain(*args, s)
        torch.cuda.synchronize()
        errs = {}
        for name, a, b in zip(("dphi", "domega", "damp"), got, plain):
            check(a.shape == b.shape and bool(torch.isfinite(a).all()), f"bwd {name} output")
            errs[name] = (float((a - b).abs().max()), rel_err(a, b))
            check(errs[name][1] <= BWD_VS_PLAIN_REL,
                  f"bwd kernel vs plain {name} rel {errs[name][1]} at R={rows} K={k} S={s}")
        ms, call_ms = time_ms(lambda: osc.oscillator_bank_bwd(*args, s), 200, cycles_per_ms)
        plain_ms, plain_call_ms = time_ms(
            lambda: osc.oscillator_bank_bwd_plain(*args, s), max(1, min(20, 1000 // (8 * k + 8))),
            cycles_per_ms,
        )
        kernel_ms["oscillator_bwd", rows, k, s] = ms
        bound_ms, bound_by = oscillator_bwd_bound(rows, k, s)
        print(
            f"oscillator_bwd R={rows} K={k} S={s} [{osc.kernel_variant(k)}]: "
            + " ".join(f"{n}: max|Δ|={a:.3e} rel={r:.3e}" for n, (a, r) in errs.items())
            + f" kernel_ms={ms:.6f} plain_ms={plain_ms:.6f} bound_ms={bound_ms:.6f} ({bound_by}) "
            f"share_of_bound={bound_ms / ms:.3f} "
            f"host_call_ms: kernel={call_ms:.6f} plain={plain_call_ms:.6f}",
            flush=True,
        )
        if (rows, k, s) == GRAPHED_SHAPE:
            entry = {
                "name": "oscillator_bwd",
                "route": "cuda",
                "source": "ddsp_pytorch_tpu_torch/ops/kernels/oscillator_bwd.cu",
                "replaces": "ddsp_pytorch_tpu/ops/pallas_kernels/oscillator.py:60",
                "launches": None,
                "max_abs_err": max(a for a, _ in errs.values()),
                "max_rel_err": max(r for _, r in errs.values()),
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "library_ms": None,  # no single PyTorch call computes this backward
                "rows_harmonics_samples": list(GRAPHED_SHAPE),
            }

    # the autograd function (both kernels) against autograd through the
    # plain forward, at the training shape
    rows, k, s = 6000, 64, 512
    phi, omega, amp = oscillator_inputs(rng, rows, k)
    g = torch.tensor(rng.standard_normal((rows, s)).astype(np.float32), device=device)
    ins = [torch.tensor(x, device=device, requires_grad=True) for x in (phi, omega, amp)]
    ref = [torch.tensor(x, device=device, requires_grad=True) for x in (phi, omega, amp)]
    before = (osc.oscillator_bank.launches, osc.oscillator_bank_bwd.launches)
    osc.OscillatorBank.apply(*ins, s).backward(g)
    check((osc.oscillator_bank.launches, osc.oscillator_bank_bwd.launches)
          == (before[0] + 1, before[1] + 1), "OscillatorBank did not launch both kernels once")
    osc.oscillator_bank_plain(*ref, s).backward(g)
    torch.cuda.synchronize()
    errs = {n: rel_err(a.grad, b.grad) for n, a, b in zip(("dphi", "domega", "damp"), ins, ref)}
    print(f"OscillatorBank grads vs autograd through the plain forward R={rows} K={k} S={s}: "
          + " ".join(f"{n} rel={e:.3e}" for n, e in errs.items()), flush=True)
    for n, e in errs.items():
        check(e <= BWD_VS_PLAIN_REL, f"OscillatorBank {n} vs plain autograd rel {e}")
    del ins, ref
    torch.cuda.empty_cache()
    return entry


def phase_streaming(device) -> None:
    """Phase 3: 64 streamed blocks on the card vs the CPU."""
    gpu = make_streaming_synth(BUNDLE, device=device, noise_deterministic=True)
    cpu = make_streaming_synth(BUNDLE, device="cpu", noise_deterministic=True)
    block = gpu.block_size
    pitch, loud = glide(N_BLOCKS, block)
    for i in range(4):  # warm-up on a throwaway state (cuBLAS handles, caches)
        gpu.step_samples(pitch[:, i * block : (i + 1) * block], loud[:, i * block : (i + 1) * block])
    gpu.reset()
    torch.cuda.synchronize()

    osc.oscillator_bank.launches = 0
    render_ms, outs = [], []
    for i in range(N_BLOCKS):
        sl = slice(i * block, (i + 1) * block)
        t0 = time.perf_counter()
        audio = gpu.step_samples(pitch[:, sl], loud[:, sl])
        torch.cuda.synchronize()
        render_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(audio)
    launches = osc.oscillator_bank.launches

    got = torch.cat(outs, dim=-1).cpu().numpy()
    want = torch.cat(
        [cpu.step_samples(pitch[:, i * block : (i + 1) * block], loud[:, i * block : (i + 1) * block])
         for i in range(N_BLOCKS)],
        dim=-1,
    ).numpy()
    err = float(np.abs(got - want).max())
    peak = float(np.abs(got).max())
    budget_ms = 1e3 * block / gpu.sample_rate
    p50, p99 = np.percentile(render_ms, [50, 99])
    print(
        f"streaming {N_BLOCKS} blocks: launches={launches} max|gpu-cpu|={err:.3e} "
        f"peak={peak:.4f} render_ms p50={p50:.4f} p99={p99:.4f} max={max(render_ms):.4f} "
        f"budget_ms={budget_ms:.4f}",
        flush=True,
    )
    check(got.shape == (1, N_BLOCKS * block), "streamed shape")
    check(bool(np.isfinite(got).all()), "streamed audio not finite")
    check(peak > 1e-3, f"streamed audio silent (peak {peak})")
    check(err <= STREAM_GPU_VS_CPU_ATOL, f"gpu vs cpu streaming {err}")
    check(launches == N_BLOCKS, f"oscillator kernel launched {launches}x for {N_BLOCKS} blocks")
    phase_streaming_noise(device, pitch, loud)


def phase_streaming_noise(device, pitch, loud) -> None:
    """Phase 3, with noise: the noise generator's state travels by value in
    the StreamState, so a step builds a generator from it and returns the
    advanced state.  Per-block render time with noise on (beside the
    deterministic run's), the host cost of that state round trip, and on
    the card: replaying a state gives bit-identical audio and leaves the
    state as it was."""
    synth = make_streaming_synth(BUNDLE, device=device, seed=SEED)
    block = synth.block_size
    for i in range(4):
        synth.step_samples(pitch[:, i * block : (i + 1) * block], loud[:, i * block : (i + 1) * block])
    synth.reset(SEED)
    torch.cuda.synchronize()
    render_ms = []
    for i in range(N_BLOCKS):
        sl = slice(i * block, (i + 1) * block)
        t0 = time.perf_counter()
        synth.step_samples(pitch[:, sl], loud[:, sl])
        torch.cuda.synchronize()
        render_ms.append((time.perf_counter() - t0) * 1e3)

    state = synth.fresh_state(SEED + 1)
    kept = state.noise_state.clone()
    f0, ld = pitch[:, :block:block, None], loud[:, :block:block, None]
    a1, n1 = synth.step_stateless(state, f0, ld)
    a2, n2 = synth.step_stateless(state, f0, ld)
    b1, _ = synth.step_stateless(n1, f0, ld)
    torch.cuda.synchronize()
    check(torch.equal(a1, a2) and torch.equal(n1.noise_state, n2.noise_state),
          "replaying a StreamState on the card gave other audio")
    check(torch.equal(state.noise_state, kept), "step_stateless changed the state passed in")
    check(not torch.equal(a1, b1), "the next state's noise did not move on")

    n = 1000
    t0 = time.perf_counter()
    for _ in range(n):
        gen = torch.Generator(device=device)
        gen.set_state(kept)
        gen.get_state()
    roundtrip_us = (time.perf_counter() - t0) * 1e6 / n
    p50, p99 = np.percentile(render_ms, [50, 99])
    print(
        f"streaming {N_BLOCKS} blocks with noise (generator state by value, {kept.numel()} bytes): "
        f"render_ms p50={p50:.4f} p99={p99:.4f} max={max(render_ms):.4f}; "
        f"generator state round trip (build, set_state, get_state) {roundtrip_us:.2f} us a block on the host; "
        f"replayed state: identical audio",
        flush=True,
    )


def phase_server(device) -> int:
    """Phase 4: the socket server on the card.  Returns the kernel launches
    made while it answered; the counter is reset just before the requests."""
    server = serve.StreamServer(BUNDLE, port=0, device=device)
    det = serve.StreamServer(BUNDLE, port=0, device=device, noise_deterministic=True)
    server.start()
    det.start()
    try:
        block = server.block_size
        pitch, loud = glide(N_REQUESTS, block)
        pitch, loud = pitch[0], loud[0]
        host, port = server.address
        clients = [serve.StreamClient(host, port) for _ in range(2)]
        check(all(c.sample_rate == server.sample_rate and c.block_size == block for c in clients), "hello")
        results = {}

        def run(idx):
            c = clients[idx]
            results[idx] = [
                c.render(pitch[i * block : (i + 1) * block], loud[i * block : (i + 1) * block])
                for i in range(N_REQUESTS)
            ]

        osc.oscillator_bank.launches = 0
        threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        d_host, d_port = det.address
        d1 = serve.StreamClient(d_host, d_port)
        first = d1.render(pitch[:block], loud[:block])
        second = d1.render(pitch[:block], loud[:block])
        d2 = serve.StreamClient(d_host, d_port)
        fresh = d2.render(pitch[:block], loud[:block])
        launches = osc.oscillator_bank.launches
        for c in (*clients, d1, d2):
            c.close()

        check(set(results) == {0, 1}, "a client thread did not finish")
        for idx in (0, 1):
            for a in results[idx]:
                check(a.shape == (block,) and bool(np.isfinite(a).all()), "response shape/finite")
        a0, b0 = results[0][0], results[1][0]
        check(not np.allclose(first, second), "phase did not continue across requests")
        check(np.array_equal(fresh, first), "deterministic fresh session differs from the first")
        check(bool(np.allclose(a0, b0, atol=1e-2)) and not np.array_equal(a0, b0),
              "sessions' noise streams not independent")
        check(launches == 2 * N_REQUESTS + 3, f"server launched the kernel {launches}x")
        print(
            f"server: 2 clients x {N_REQUESTS} requests + 3 deterministic: launches={launches} "
            f"max|session0-session1| first block={float(np.abs(a0 - b0).max()):.3e}",
            flush=True,
        )
        return launches
    finally:
        server.stop()
        det.stop()


def _full_kwargs():
    return dict(Config.from_yaml(CONFIG).model.kwargs)


def _grad_errors(got: dict, want: dict):
    """(whole-gradient relative L2 error, {leaf: (‖Δ‖, ‖g_leaf‖)}, ‖g‖)."""
    leaf = {n: (float((got[n] - w).norm()), float(w.norm())) for n, w in want.items()}
    a = torch.cat([got[n].flatten() for n in want])
    b = torch.cat([want[n].flatten() for n in want])
    return float((a - b).norm() / b.norm()), leaf, float(b.norm())


def phase_train_step(device) -> None:
    """Phase 5a: one full-width train step on the card against the CPU from
    the same init_params weights, batch and injected noise."""
    kw = _full_kwargs()
    block, sr = kw["block_size"], kw["sample_rate"]
    frames, batch_size = 48, 2  # 24 576 samples: longer than the 4096 scale
    cfg = Config.from_yaml(CONFIG)
    meta = read_meta(BUNDLE)
    meta_mean, meta_std = meta["mean_loudness"], meta["std_loudness"]
    pitch, loud = glide_controls(batch_size, frames, block, sr, seed=SEED + 2,
                                 mean_loudness=meta_mean, std_loudness=meta_std)
    rng = np.random.default_rng(SEED + 3)
    t = np.arange(frames * block) / sr
    sig = (0.3 * np.sin(2 * np.pi * 330.0 * t)[None] + 0.01 * rng.standard_normal((batch_size, t.size)))
    noise = rng.uniform(-1.0, 1.0, (batch_size, frames, block)).astype(np.float32)
    batch = {"pitch": pitch[..., None], "loudness": loud[..., None], "sig": sig.astype(np.float32)}

    def step(model, dev, dtype=torch.float32):
        tb = {k: torch.tensor(v, device=dev, dtype=dtype) for k, v in batch.items()}
        loss, grads = loss_and_grads(model, tb, meta_mean, meta_std, cfg.train.scales,
                                     cfg.train.overlap, noise=torch.tensor(noise, device=dev, dtype=dtype))
        names = [n for n, _ in model.named_parameters()]
        return float(loss), {n: g.detach().cpu().double() for n, g in zip(names, grads)}

    def held_step(model, dev, dtype, held=None):
        """The same loss with the STFT bins marked in `held` (a bool mask
        per scale) held constant, and its gradients; also the
        reconstruction's magnitudes per scale."""
        tb = {k: torch.tensor(v, device=dev, dtype=dtype) for k, v in batch.items()}
        tb["loudness"] = (tb["loudness"] - meta_mean) / meta_std
        out = model(tb, noise=torch.tensor(noise, device=dev, dtype=dtype))
        ori = multiscale_fft(tb["sig"], cfg.train.scales, cfg.train.overlap)
        rec = multiscale_fft(out["signal"], cfg.train.scales, cfg.train.overlap)
        if held is not None:
            ori = [torch.where(h.to(dev), torch.ones_like(o), o) for h, o in zip(held, ori)]
            rec = [torch.where(h.to(dev), torch.ones_like(r), r) for h, r in zip(held, rec)]
        loss = multiscale_spec_loss(ori, rec)
        names = [n for n, _ in model.named_parameters()]
        grads = torch.autograd.grad(loss, [q for _, q in model.named_parameters()])
        return (float(loss.detach()), {n: g.detach().cpu().double() for n, g in zip(names, grads)},
                [r.detach().cpu() for r in rec])

    cpu_model = init_params(DDSPDecoder(**kw), torch.Generator().manual_seed(SEED))
    gpu_model = copy.deepcopy(cpu_model).to(device)
    before = (osc.oscillator_bank.launches, osc.oscillator_bank_bwd.launches)
    gpu_loss, gpu_grads = step(gpu_model, device)
    launched = (osc.oscillator_bank.launches - before[0], osc.oscillator_bank_bwd.launches - before[1])
    cpu_loss, cpu_grads = step(cpu_model, "cpu")
    whole, leaf, norm = _grad_errors(gpu_grads, cpu_grads)
    of_whole = {n: d / norm for n, (d, _) in leaf.items()}
    rel = {n: d / max(w, 1e-30) for n, (d, w) in leaf.items()}
    worst = sorted(of_whole, key=of_whole.get, reverse=True)[:4]
    loss_rel = abs(gpu_loss - cpu_loss) / abs(cpu_loss)
    print(f"train step GPU vs CPU (full width, batch {batch_size} x {frames} frames, init_params "
          f"weights): loss gpu={gpu_loss:.7f} cpu={cpu_loss:.7f} rel={loss_rel:.3e}; whole-gradient "
          f"rel L2={whole:.3e} (|g|={norm:.4e}); harmonic_proj.weight rel L2="
          f"{rel['harmonic_proj.weight']:.3e}; largest leaf errors (|Δ|/|g|, own rel L2): " + ", ".join(
              f"{n}={of_whole[n]:.3e} ({rel[n]:.3e})" for n in worst)
          + f"; launches fwd={launched[0]} bwd={launched[1]}", flush=True)
    check(np.isfinite(gpu_loss), "GPU step loss not finite")
    check(launched == (1, 1), f"GPU step launched the kernels {launched}, expected (1, 1)")
    check(leaf["harmonic_proj.weight"][1] > 0, "no gradient reaches harmonic_proj on the card")
    check(loss_rel <= STEP_LOSS_REL, f"GPU vs CPU loss rel {loss_rel}")
    check(whole <= STEP_GRAD_REL, f"GPU vs CPU whole-gradient rel L2 {whole}")
    check(rel["harmonic_proj.weight"] <= STEP_HARMONIC_REL,
          f"GPU vs CPU harmonic_proj.weight rel L2 {rel['harmonic_proj.weight']}")
    for n, e in of_whole.items():
        check(e <= STEP_LEAF_OF_WHOLE, f"GPU vs CPU gradient of {n}: |Δ|/|g| {e}")
    phase_train_step_f64(step, held_step, copy.deepcopy(cpu_model).double(),
                         {"gpu_f32": (gpu_model, device, gpu_loss, gpu_grads),
                          "cpu_f32": (cpu_model, "cpu", cpu_loss, cpu_grads)},
                         cfg.train.scales)


# The leaves on which GPU-f32 and CPU-f32 steps disagreed most at fresh
# weights (PERF.md §6).
FLAGGED_LEAVES = ("noise_proj.weight", "noise_proj.bias", "reverb.noise",
                  "decoder.loudness_mlp.Dense_0.bias")
HELD_BIN_LEVEL = 1e-6


def phase_train_step_f64(step, held_step, model64, sides: dict, scales) -> None:
    """Phase 5a, float64 reference: the same step on the CPU in float64
    (the plain paths, same weights, batch and noise), and each float32
    side's error against it, leaf by leaf (relative L2 to the f64 leaf's
    norm).  Both f32 sides off f64 by similar amounts says the f32
    disagreement is the loss's conditioning; one side far off would be a
    defect of that side.  Then the STFT bins whose f64 magnitude is below
    HELD_BIN_LEVEL, where the log term's weight 1/(S + 1e-7) passes 10^6,
    are held constant on every side, and the whole-gradient errors are
    taken again: what is left is the rest of the step's f32 rounding."""
    loss64, grads64 = step(model64, "cpu", torch.float64)
    summary, own = {}, {}
    for side, (_, _, loss, grads) in sides.items():
        whole, leaf, _ = _grad_errors(grads, grads64)
        own[side] = {n: d / max(w, 1e-300) for n, (d, w) in leaf.items()}
        summary[side] = (abs(loss - loss64) / abs(loss64), whole)
    print("train step vs CPU float64 (full width, batch 2 x 48 frames, init_params weights): loss f64="
          f"{loss64:.10f}; " + "; ".join(
              f"{side} loss rel={lr:.3e} whole-gradient rel L2={w:.3e}" for side, (lr, w) in summary.items()),
          flush=True)
    for n in FLAGGED_LEAVES:
        print(f"  flagged leaf {n}: rel L2 vs f64 gpu_f32={own['gpu_f32'][n]:.3e} "
              f"cpu_f32={own['cpu_f32'][n]:.3e}", flush=True)
    print("  every leaf, rel L2 vs f64 (gpu_f32, cpu_f32): " + ", ".join(
        f"{n}=({own['gpu_f32'][n]:.2e}, {own['cpu_f32'][n]:.2e})" for n in grads64), flush=True)

    _, _, rec64 = held_step(model64, "cpu", torch.float64)
    held = [r < HELD_BIN_LEVEL for r in rec64]
    where = [(sc, tuple(idx)) for sc, h in zip(scales, held) for idx in torch.nonzero(h).tolist()]
    print(f"  STFT bins below {HELD_BIN_LEVEL:g} in f64 (scale, (item, bin, frame)): {where}; smallest "
          "magnitude per scale: " + ", ".join(f"{sc}={float(r.min()):.3e}" for sc, r in zip(scales, rec64)),
          flush=True)
    _, held64, _ = held_step(model64, "cpu", torch.float64, held)
    for side, (model, dev, _, _) in sides.items():
        _, grads, _ = held_step(model, dev, torch.float32, held)
        print(f"  {side} vs f64 with those bins held: whole-gradient rel L2="
              f"{_grad_errors(grads, held64)[0]:.3e}", flush=True)
    for side, (loss_rel, _) in summary.items():
        check(loss_rel <= STEP_LOSS_REL, f"{side} vs f64 loss rel {loss_rel}")


def write_cache(out_dir: str, device) -> None:
    """A feature cache of 4 s glides with vibrato (train: N_TRAIN_ITEMS,
    validation: N_VAL_ITEMS), whose targets the violin bundle renders on the
    card through DDSPDecoder.forward (reverb on)."""
    bundle, meta = load_bundle(BUNDLE, device=device)
    mean, std = meta["mean_loudness"], meta["std_loudness"]
    block, sr = bundle.block_size, bundle.sample_rate
    frames = Config.from_yaml(CONFIG).n_frames
    generator = torch.Generator(device).manual_seed(SEED)
    for part, n, seed in (("train", N_TRAIN_ITEMS, SEED + 10), ("validation", N_VAL_ITEMS, SEED + 11)):
        pitch, loud = glide_controls(n, frames, block, sr, seed=seed,
                                     mean_loudness=mean, std_loudness=std)
        with torch.no_grad():
            sig = bundle({
                "pitch": torch.tensor(pitch[..., None], device=device),
                "loudness": (torch.tensor(loud[..., None], device=device) - mean) / std,
            }, generator=generator)["signal"]
        sig = sig.cpu().numpy()
        check(sig.shape == (n, frames * block) and bool(np.isfinite(sig).all()), "rendered targets")
        os.makedirs(os.path.join(out_dir, part))
        for name, arr in (("signals", sig), ("pitchs", pitch), ("loudness", loud)):
            np.save(os.path.join(out_dir, part, f"{name}.npy"), arr.astype(np.float32))
    del bundle
    torch.cuda.empty_cache()


def phase_training(device, cache: str, tmp: str) -> tuple:
    """Phase 5b: Trainer.fit at configs/config.yaml on the violin-rendered
    cache.  Returns (forward launches, backward launches) of the fit."""
    cfg = Config.from_yaml(CONFIG)
    cfg.apply_overrides([
        f"preprocess.out_dir={cache}", f"train.steps={N_TRAIN_STEPS}",
        "train.val_interval_epochs=10", "train.log_interval_epochs=10",
        "train.checkpoint_every_steps=0", "train.metrics_flush_steps=10",
    ])
    dm = Datamodule(cfg)
    dm.setup()
    run_dir = os.path.join(tmp, "run_config")
    trainer = Trainer(cfg, run_dir, device=device)
    osc.reset_kernel_counts()
    t0 = time.perf_counter()
    state = trainer.fit(dm)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fwd, bwd = osc.oscillator_bank.launches, osc.oscillator_bank_bwd.launches
    steps_run = state.step
    trainer.close()
    losses = [v for _, v in read_metrics(run_dir, "loss")]
    skipped = [v for _, v in read_metrics(run_dir, "update_skipped")]
    val = read_metrics(run_dir, "loss/val")
    window = read_metrics(run_dir, "train_window_steps_per_s")

    # ms per step on the host clock, each step ending in a synchronize
    # (after the counted run: these launches are not the main path's)
    batch = next(iter(dm.train_dataloader()))
    step = make_train_step(trainer.model, trainer.tx, cfg)
    tb = to_device(batch, device)
    step_ms = []
    for _ in range(6):
        t1 = time.perf_counter()
        step(state, tb)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
    step_ms = step_ms[1:]

    first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    print(
        f"training: {steps_run} steps (batch {cfg.train.batch} x {cfg.n_frames} frames, "
        f"scales {cfg.train.scales}, reverb on) in {fit_s:.2f} s, train window "
        f"{window[-1][1] if window else float('nan'):.4f} steps/s; ms/step (host, synced) "
        f"median={float(np.median(step_ms)):.3f} min={min(step_ms):.3f} max={max(step_ms):.3f}; "
        f"loss first5={first5:.5f} last5={last5:.5f} factor={first5 / last5:.4f}; "
        f"loss[0]={losses[0]:.5f} loss[-1]={losses[-1]:.5f}; val={[round(v, 5) for _, v in val]}; "
        f"launches fwd={fwd} bwd={bwd} eval_forwards={trainer.eval_forwards}",
        flush=True,
    )
    print("loss curve: " + " ".join(f"{v:.5f}" for v in losses), flush=True)
    check(steps_run == N_TRAIN_STEPS and len(losses) == N_TRAIN_STEPS, "steps run")
    check(all(np.isfinite(losses)), "a training loss is not finite")
    check(sum(skipped) == 0, f"{int(sum(skipped))} updates skipped")
    check(first5 >= LOSS_FALL_FACTOR * last5,
          f"loss did not fall by {LOSS_FALL_FACTOR}x: first5 {first5} last5 {last5}")
    check(bwd == N_TRAIN_STEPS, f"oscillator_bwd launched {bwd}x in {N_TRAIN_STEPS} steps")
    check(fwd == N_TRAIN_STEPS + trainer.eval_forwards,
          f"oscillator_fwd launched {fwd}x: {N_TRAIN_STEPS} steps + {trainer.eval_forwards} eval")
    return fwd, bwd


def _leaf_rel(a: torch.nn.Module, b: torch.nn.Module) -> dict:
    """{leaf: max |a − b| / max |b|} over two models' parameters."""
    return {n: rel_err(x.detach(), y.detach())
            for (n, x), y in zip(a.named_parameters(), b.parameters())}


def phase_graphed_vs_eager(device, cache: str, card: str) -> dict:
    """Phase 6: the train step as a CUDA graph against eager steps at
    configs/config.yaml's full width (batch 16 x 375 frames, hidden 512,
    K = 64, 65 bands, reverb on, six scales).  From one state and the same
    N_GRAPH_STEPS batches of the device-resident cache: N_GRAPH_STEPS eager
    steps, and one call of steps_per_call N_GRAPH_STEPS replaying a graph of
    U = 1 and of U = 2 steps; per-step losses and every parameter leaf
    within GRAPHED_REL relative.  Then ms per step, synced, for both, the
    capture time, the graph pool and the peak memory of each.  Returns the
    numbers for the report."""
    cfg = Config.from_yaml(CONFIG)
    loader = DeviceDataLoader(Dataset(os.path.join(cache, "train")), cfg.train.batch, shuffle=True,
                              drop_last=True, seed=SEED, device=device)
    idx2d = []
    for epoch in range(N_GRAPH_STEPS):
        loader.set_epoch(epoch)
        idx2d += list(loader.index_batches())
    idx2d = np.stack(idx2d[:N_GRAPH_STEPS])
    base = init_params(DDSPDecoder(**_full_kwargs()), torch.Generator().manual_seed(SEED)).to(device)
    meta = read_meta(BUNDLE)

    def fresh():
        model = copy.deepcopy(base)
        tx = make_optimizer(cfg)
        state = TrainState(0, model, tx.init([q for _, q in model.named_parameters()]),
                           torch.Generator(device).manual_seed(SEED + 20),
                           meta["mean_loudness"], meta["std_loudness"])
        return model, tx, state

    model_e, tx_e, state_e = fresh()
    step = make_train_step(model_e, tx_e, cfg)
    torch.cuda.reset_peak_memory_stats(device)
    eager = torch.stack([metrics_row(step(state_e, loader.take(i))) for i in idx2d]).cpu()
    eager_peak = torch.cuda.max_memory_allocated(device)
    out = {"eager_peak_bytes": eager_peak}
    for unroll in (1, 2):
        model_g, tx_g, state_g = fresh()
        multi = make_train_multi_step_indexed(model_g, tx_g, cfg, N_GRAPH_STEPS, unroll)
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        graphed = multi(state_g, loader.device_data, idx2d).cpu()
        first_call_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(device)
        loss_rel = rel_err(graphed[:, 0], eager[:, 0])
        leaf = _leaf_rel(model_g, model_e)
        worst = max(leaf, key=leaf.get)
        bitwise = torch.equal(graphed, eager) and all(
            torch.equal(x, y) for x, y in zip(model_g.parameters(), model_e.parameters()))
        same_gen = torch.equal(state_g.generator.get_state(), state_e.generator.get_state())
        # ms per step: calls of N_GRAPH_STEPS steps, each synced (training on)
        call_ms = []
        for _ in range(N_TIMED_CALLS):
            t1 = time.perf_counter()
            multi(state_g, loader.device_data, idx2d)
            torch.cuda.synchronize()
            call_ms.append((time.perf_counter() - t1) * 1e3)
        step_ms = float(np.median(call_ms)) / N_GRAPH_STEPS
        print(
            f"graphed vs eager step (configs/config.yaml full width, batch {cfg.train.batch} x "
            f"{cfg.n_frames} frames, {N_GRAPH_STEPS} steps, U={unroll}): per-step loss max rel "
            f"{loss_rel:.3e}; worst leaf {worst} rel {leaf[worst]:.3e}; bitwise equal: {bitwise}; "
            f"generator state equal: {same_gen}; capture+instantiate s={multi.capture_s:.3f} "
            f"first call s={first_call_s:.3f} (warm-up, capture, {N_GRAPH_STEPS // unroll} replays); "
            f"graph pool bytes={multi.pool_bytes} peak bytes={peak}; captured per graph "
            f"{multi.captured}; graphed ms/step (median of {N_TIMED_CALLS} synced calls of "
            f"{N_GRAPH_STEPS}) = {step_ms:.3f}; card {card}",
            flush=True,
        )
        check(loss_rel <= GRAPHED_REL, f"graphed vs eager loss rel {loss_rel} (U={unroll})")
        check(leaf[worst] <= GRAPHED_REL, f"graphed vs eager {worst} rel {leaf[worst]} (U={unroll})")
        check(same_gen, "the graphed steps left the generator elsewhere than eager steps")
        check(multi.captured == {"oscillator_fwd": unroll, "oscillator_bwd": unroll},
              f"captured launches {multi.captured}")
        out[unroll] = {"step_ms": step_ms, "capture_s": multi.capture_s, "pool_bytes": multi.pool_bytes,
                       "peak_bytes": peak, "bitwise": bitwise}
        del multi, model_g, state_g
        torch.cuda.empty_cache()

    eager_ms = []
    for i in range(N_TIMED_EAGER):
        batch = loader.take(idx2d[i % N_GRAPH_STEPS])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step(state_e, batch)
        torch.cuda.synchronize()
        eager_ms.append((time.perf_counter() - t1) * 1e3)
    out["eager_step_ms"] = float(np.median(eager_ms))
    print(
        f"eager ms/step (median of {N_TIMED_EAGER} synced steps) = {out['eager_step_ms']:.3f} "
        f"(min {min(eager_ms):.3f} max {max(eager_ms):.3f}); peak bytes={eager_peak}; graphed "
        f"U=1 {out[1]['step_ms']:.3f} U=2 {out[2]['step_ms']:.3f} ms/step; eager/graphed "
        f"{out['eager_step_ms'] / out[1]['step_ms']:.3f}x; card {card}",
        flush=True,
    )
    del loader, base, model_e, state_e
    torch.cuda.empty_cache()
    return out


class _PreemptedTrainer(Trainer):
    """A Trainer that sends itself SIGTERM right after its second call."""

    calls = 0

    def _run_multi(self, state, batches, loader):
        rows = super()._run_multi(state, batches, loader)
        self.calls += 1
        if self.calls == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return rows


def _violin_fit(cls, run_dir: str, cache: str, device):
    cfg = Config.from_yaml(VIOLIN_CONFIG)
    cfg.apply_overrides([
        f"preprocess.out_dir={cache}", f"train.steps={N_VIOLIN_STEPS}",
        f"train.val_interval_epochs={VIOLIN_VAL_EPOCHS}",
        f"train.checkpoint_every_steps={VIOLIN_CHECKPOINT_STEPS}",
    ])
    dm = Datamodule(cfg, device_cache=True, device=device)
    dm.setup()
    trainer = cls(cfg, run_dir, device=device)
    t0 = time.perf_counter()
    state = trainer.fit(dm)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    trainer.close()
    return cfg, trainer, state, fit_s


def phase_violin_run(device, cache: str, tmp: str) -> tuple:
    """Phase 7: Trainer.fit at pretrained/ddsp_violin_config.yaml (its
    steps_per_call 25, batch 8, six scales) with the device-resident
    loader, for N_VIOLIN_STEPS steps on the violin-rendered cache: the loss
    falls; the kernels ran inside the graph.  Then a second run preempted
    by SIGTERM after its second call resumes to N_VIOLIN_STEPS and ends
    equal to the first.  Returns ({kernel: launches on this path}, the
    first run's directory)."""
    run_dir = os.path.join(tmp, "run_violin")
    osc.reset_kernel_counts()
    cfg, trainer, state, fit_s = _violin_fit(Trainer, run_dir, cache, device)
    shape = (cfg.train.batch * cfg.n_frames, cfg.model.kwargs["n_harmonic"], cfg.model.kwargs["block_size"])
    check(shape == GRAPHED_SHAPE, f"the violin run's kernel shape {shape} is not phase 2's {GRAPHED_SHAPE}")
    counts = {name: (w.launches, w.captured, w.replayed) for name, w in osc.KERNEL_WRAPPERS.items()}
    multi = trainer._multi_step
    losses = [v for _, v in read_metrics(run_dir, "loss")]
    skipped = [v for _, v in read_metrics(run_dir, "update_skipped")]
    sps = read_metrics(run_dir, "steps_per_s")
    window = read_metrics(run_dir, "train_window_steps_per_s")
    val = read_metrics(run_dir, "loss/val")
    first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    print(
        f"violin-config run ({VIOLIN_CONFIG}: steps_per_call {cfg.train.steps_per_call}, scan_unroll "
        f"{cfg.train.scan_unroll}, batch {cfg.train.batch} x {cfg.n_frames} frames, scales "
        f"{cfg.train.scales}, device cache): {state.step} steps in {fit_s:.2f} s; steps_per_s "
        f"{[round(v, 4) for _, v in sps]}; train window {window[-1][1]:.4f} steps/s; capture+instantiate "
        f"s={multi.capture_s:.3f}, graph pool bytes={multi.pool_bytes}, replays={multi.replays}; loss "
        f"first5={first5:.5f} last5={last5:.5f} factor={first5 / last5:.4f}; val="
        f"{[round(v, 5) for _, v in val]}; kernel counts (launches, captured, replayed) {counts}; "
        f"eval_forwards={trainer.eval_forwards}",
        flush=True,
    )
    print("violin loss curve: " + " ".join(f"{v:.5f}" for v in losses), flush=True)
    check(state.step == N_VIOLIN_STEPS and len(losses) == N_VIOLIN_STEPS, "violin steps run")
    check(all(np.isfinite(losses)) and sum(skipped) == 0, "violin run: a loss not finite or a skip")
    check(first5 >= LOSS_FALL_FACTOR * last5,
          f"violin run: loss did not fall by {LOSS_FALL_FACTOR}x: first5 {first5} last5 {last5}")
    check(multi.replays == N_VIOLIN_STEPS // cfg.train.scan_unroll, f"replays {multi.replays}")
    for name, (launches, captured, replayed) in counts.items():
        check(replayed == N_VIOLIN_STEPS, f"{name} replayed {replayed}x in {N_VIOLIN_STEPS} graphed steps")
    want = {n: p.detach().cpu().clone() for n, p in state.model.named_parameters()}
    want_gen = state.generator.get_state()
    del trainer, state, multi
    torch.cuda.empty_cache()

    run2 = os.path.join(tmp, "run_violin_preempted")
    _, _, stopped, _ = _violin_fit(_PreemptedTrainer, run2, cache, device)
    stop_step = stopped.step
    del stopped
    _, _, resumed, _ = _violin_fit(Trainer, run2, cache, device)
    rel = {n: rel_err(p.detach().cpu(), want[n]) for n, p in resumed.model.named_parameters()}
    worst = max(rel, key=rel.get)
    bitwise = all(torch.equal(p.detach().cpu(), want[n]) for n, p in resumed.model.named_parameters())
    same_gen = torch.equal(resumed.generator.get_state(), want_gen)
    print(
        f"violin run preempted by SIGTERM after its second call: stopped at step {stop_step}, resumed "
        f"to {resumed.step}; vs the uninterrupted run: worst leaf {worst} rel {rel[worst]:.3e}, "
        f"bitwise equal: {bitwise}, generator state equal: {same_gen}",
        flush=True,
    )
    check(stop_step == 2 * cfg.train.steps_per_call, f"preempted run stopped at {stop_step}")
    check(resumed.step == N_VIOLIN_STEPS, "resumed run did not reach its steps")
    check(rel[worst] <= GRAPHED_REL, f"resumed vs uninterrupted {worst} rel {rel[worst]}")
    check(same_gen, "resumed run's generator state differs")
    del resumed
    torch.cuda.empty_cache()
    return {name: launches + replayed for name, (launches, _, replayed) in counts.items()}, run_dir


def phase_export_serve(device, run_dir: str, cache: str, tmp: str) -> int:
    """Phase 8: export_run on the violin-config run (its parameters must
    come back bit for bit), then the exported bundle streamed on the card
    against the CPU plain stream (64 blocks of the controls of a training
    item, in the distribution the run trained on), served to one client for
    two requests, and its impulse read back with `wave`.  Returns
    oscillator_fwd's launches while serving it."""
    out_dir = os.path.join(tmp, "export")
    bundle = export_run(run_dir, out_dir, name="smoke", device=device)
    exported = load_bundle(bundle, device="cpu")[0].state_dict()
    trained = run_params(run_dir)
    check(exported.keys() == trained.keys()
          and all(torch.equal(exported[k], trained[k]) for k in trained),
          "the exported parameters differ from the run's")
    gpu = make_streaming_synth(bundle, device=device, noise_deterministic=True)
    cpu = make_streaming_synth(bundle, device="cpu", noise_deterministic=True)
    block = gpu.block_size
    # the controls of the run's first training item, held over each frame
    pitch, loud = (np.repeat(np.load(os.path.join(cache, "train", f"{name}.npy"))[:1, :N_BLOCKS], block, axis=1)
                   for name in ("pitchs", "loudness"))
    gpu.step_samples(pitch[:, :block], loud[:, :block])  # warm-up on a throwaway state
    gpu.reset()
    osc.reset_kernel_counts()
    got = torch.cat([gpu.step_samples(pitch[:, i * block:(i + 1) * block], loud[:, i * block:(i + 1) * block])
                     for i in range(N_BLOCKS)], dim=-1).cpu().numpy()
    streamed = osc.oscillator_bank.launches
    want = torch.cat([cpu.step_samples(pitch[:, i * block:(i + 1) * block], loud[:, i * block:(i + 1) * block])
                      for i in range(N_BLOCKS)], dim=-1).numpy()
    err = float(np.abs(got - want).max())
    peak = float(np.abs(got).max())

    server = serve.StreamServer(bundle, port=0, device=device)
    server.start()
    try:
        client = serve.StreamClient(*server.address)
        first = client.render(pitch[0, :block], loud[0, :block])
        second = client.render(pitch[0, :block], loud[0, :block])
        client.close()
    finally:
        server.stop()
    served = osc.oscillator_bank.launches - streamed

    with wave.open(os.path.join(out_dir, "ddsp_smoke_impulse.wav"), "rb") as f:
        sr, n = f.getframerate(), f.getnframes()
        ir = np.frombuffer(f.readframes(n), "<i2")
    tap = float(ir[0]) / 32768.0
    print(
        f"exported bundle {os.path.basename(bundle)}: parameters equal to the run's; {N_BLOCKS} blocks "
        f"of a training item's controls on the card vs the CPU: max|gpu-cpu|={err:.3e} "
        f"peak={peak:.3e} (max|gpu-cpu| over peak {err / max(peak, 1e-30):.3e}; "
        f"a run of {N_VIOLIN_STEPS} steps from fresh weights plays near silence) oscillator_fwd launches="
        f"{streamed}; server: 2 requests, {served} launches, shapes {first.shape} {second.shape}; "
        f"impulse {n} samples at {sr} Hz, first tap {tap:.5f}",
        flush=True,
    )
    check(got.shape == (1, N_BLOCKS * block) and bool(np.isfinite(got).all()), "exported stream")
    check(peak > 0, "exported stream is all zeros")
    check(err <= STREAM_GPU_VS_CPU_ATOL, f"exported bundle gpu vs cpu {err}")
    check(err <= EXPORT_STREAM_REL_OF_PEAK * peak,
          f"exported bundle gpu vs cpu {err} over peak {peak}: above {EXPORT_STREAM_REL_OF_PEAK}")
    check(streamed == N_BLOCKS and served == 2, f"oscillator_fwd launched {streamed}, {served}x")
    for a in (first, second):
        check(a.shape == (block,) and bool(np.isfinite(a).all()), "server response")
    check(not np.allclose(first, second), "the server's phase did not continue across requests")
    check(sr == gpu.sample_rate and n == gpu.sample_rate, "impulse length or rate")
    check(abs(tap - 1.0) <= 2e-2, f"impulse dry tap {tap}")
    return streamed + served


def phase_probe_kernels(device) -> dict:
    """Phase 2, the roofline probes: each kernel against its plain version
    on the script's input (256 tiles of 32 × 512) in float32, and both
    against the same chain in float64; the plain version's time.  Returns
    {kernel: (max |kernel − plain|, plain ms)}."""
    x = roofline.probe_input(seed=SEED, device=device)
    cycles_per_ms = sleep_cycles_per_ms()
    out = {}
    for name, fn, plain, atol in (("roofline_fma", roofline.fma_chain, roofline.fma_chain_plain, 0.0),
                                  ("roofline_sin", roofline.sin_chain, roofline.sin_chain_plain,
                                   PROBE_SIN_ATOL)):
        got = fn(x)
        want = plain(x)
        want64 = plain(x.double())
        torch.cuda.synchronize()
        check(got.shape == x.shape and bool(torch.isfinite(got).all()), f"{name} output")
        err = float((got - want).abs().max())
        err64 = float((got.double() - want64).abs().max())
        plain_err64 = float((want.double() - want64).abs().max())
        # the plain chain is ~1000 elementwise launches a call
        plain_ms, _ = time_ms(lambda: plain(x), 2, cycles_per_ms, warmup=1)
        print(f"{name} ({x.numel()} elements): max|kernel-plain|={err:.3e} max|kernel-f64|={err64:.3e} "
              f"max|plain-f64|={plain_err64:.3e} scale={float(want64.abs().max()):.4f} "
              f"plain_ms={plain_ms:.6f}", flush=True)
        check(err <= atol, f"{name} kernel vs plain {err}")
        check(err64 <= PROBE_VS_F64_ATOL, f"{name} kernel vs float64 {err64}")
        out[name] = (err, plain_ms)
    return out


def phase_roofline(device, card: str, probe_checks: dict, kernel_ms: dict) -> list:
    """Phase 9: the roofline entry point (bench_roofline.run) with the probe
    counts set to 0 just before it; the rates, the SM clock and power under
    the fma probe, and each oscillator kernel's instruction-mix share from
    phase 2's times.  Returns the probes' JSON entries."""
    roofline.reset_kernel_counts()
    result = bench_roofline.run(device, kernel_ms=kernel_ms)
    launches = {name: w.launches for name, w in roofline.KERNEL_WRAPPERS.items()}
    rates = result["rates"]
    clocks = rates["clocks_under_fma_load"]
    check(len(clocks["samples"]) > 0, f"no nvidia-smi sample inside the fma probe's load: {clocks}")
    sweep = "; ".join(f"{kind} probe by threads a block: " + ", ".join(
        f"{t}: {1e3 * ms:.3f} us" for t, ms in rates[f"{kind}_ms_by_threads"].items())
        for kind in ("fma", "sin"))
    print(f"roofline (card {card}): {sweep}", flush=True)
    print(f"roofline (card {card}): fma probe {rates['fma_ms']:.6f} ms at {rates['fma_threads']} threads = "
          f"{rates['fma_elems_per_s']:.4e} FMA/s = {rates['fma_tflops']:.3f} FP32 TFLOP/s "
          f"({100 * rates['fma_share_of_fp32_peak']:.1f} % of {rates['fp32_peak_tflops']:.0f}); sin probe "
          f"{rates['sin_ms']:.6f} ms at {rates['sin_threads']} threads = {rates['sin_elems_per_s']:.4e} "
          f"sinf/s; launches {launches}; under {clocks['window_s']:.2f} s of the fma probe, "
          f"{len(clocks['samples'])} nvidia-smi samples: SM clock {clocks['sm_mhz_min']:.0f}-"
          f"{clocks['sm_mhz_max']:.0f} MHz (max {clocks['sm_mhz_limit']:.0f}), power "
          f"{clocks['power_w_min']:.2f}-{clocks['power_w_max']:.2f} W", flush=True)
    for row in result["oscillator"]:
        print(f"  {row['kernel']} R={row['rows']} K={row['k']} S={row['s']}: {1e3 * row['ms']:.3f} us, "
              f"instruction-mix ideal {1e3 * row['instruction_mix_ms']:.3f} us "
              f"(share {row['share_of_instruction_mix']:.3f}), FP32 bound {1e3 * row['bound_ms']:.3f} us "
              f"(share {row['share_of_bound']:.3f})", flush=True)
    check(all(n > 0 for n in launches.values()), f"a probe was not launched on the roofline path: {launches}")
    check(rates["fma_elems_per_s"] > 0 and rates["sin_elems_per_s"] > 0, "probe rates")
    n = rates["elements"]
    entries = []
    print(f"roofline (card {card}): sin probe bound {1e3 * rates['sin_bound_ms']:.3f} us "
          f"({rates['sin_bound_by']}: {rates['sin_sass']['fp32_per_element']} FP32 instructions an element "
          f"on {rates['sin_sass']['sms']} SMs x {bench_roofline.LANES_PER_SM} lanes at "
          f"{clocks['sm_mhz_max']:.0f} MHz); the probe reaches {100 * rates['sin_share_of_bound']:.1f} % of it",
          flush=True)
    for name, line, ms, (bound_ms, bound_by) in (
            ("roofline_fma", 229, rates["fma_ms"], bench_roofline.fma_probe_bound(n)),
            ("roofline_sin", 244, rates["sin_ms"], (rates["sin_bound_ms"], rates["sin_bound_by"]))):
        err, plain_ms = probe_checks[name]
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "ddsp_pytorch_tpu_torch/ops/kernels/roofline_probe.cu",
            "replaces": f"scripts/bench_roofline.py:{line}",
            "launches": launches[name],
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,  # no single PyTorch call computes these chains
            "launches_by_path": {"roofline": launches[name]},
        })
    return entries


def _violin_requests(rng, slots) -> dict:
    return {s: (rng.uniform(196.0, 1568.0, (1, 1)).astype(np.float32),
                rng.uniform(-9.0, -6.0, (1, 1)).astype(np.float32)) for s in slots}


def _pool_vs_streams(device) -> None:
    """Phase 10a-b: N_POOL_VOICES violin voices in one pool on the card
    against as many independent batch-1 streams on the card and against
    the same pool on the CPU; then a released slot against a fresh one."""
    pool = VoicePool(make_streaming_synth(BUNDLE, batch=N_POOL_VOICES, device=device,
                                          noise_deterministic=True))
    cpu = VoicePool(make_streaming_synth(BUNDLE, batch=N_POOL_VOICES, device="cpu",
                                         noise_deterministic=True))
    streams = [make_streaming_synth(BUNDLE, device=device, noise_deterministic=True)
               for _ in range(N_POOL_VOICES)]
    slots = [pool.acquire() for _ in range(N_POOL_VOICES)]
    check(slots == [cpu.acquire() for _ in range(N_POOL_VOICES)], "pool slots")
    rng = np.random.default_rng(SEED + 30)
    err_streams = err_cpu = peak = 0.0
    first = None
    for i in range(N_POOL_BLOCKS):
        reqs = _violin_requests(rng, slots)
        got, want = pool.step(reqs), cpu.step(reqs)
        first = first or (reqs, got)
        for s, synth in zip(slots, streams):
            alone = synth.step(reqs[s][0][None], reqs[s][1][None])[0].cpu().numpy()
            check(got[s].shape == (synth.block_size,) and bool(np.isfinite(got[s]).all()), "pooled row")
            err_streams = max(err_streams, float(np.abs(got[s] - alone).max()))
            err_cpu = max(err_cpu, float(np.abs(got[s] - want[s]).max()))
            peak = max(peak, float(np.abs(got[s]).max()))
    pool.release(slots[1])
    again = pool.acquire()
    released = float(np.abs(pool.step({again: first[0][slots[1]]})[again] - first[1][slots[1]]).max())
    print(f"pool of {N_POOL_VOICES} violin voices, {N_POOL_BLOCKS} blocks: max|pooled-independent|="
          f"{err_streams:.3e} max|gpu-cpu|={err_cpu:.3e} peak={peak:.4f}; released slot {slots[1]} "
          f"reacquired as {again}: max|Δ| against a fresh slot's first block={released:.3e}", flush=True)
    check(peak > 1e-3, f"pooled audio silent (peak {peak})")
    for what, err in (("independent streams", err_streams), ("the CPU pool", err_cpu)):
        check(err <= STREAM_GPU_VS_CPU_ATOL and err <= EXPORT_STREAM_REL_OF_PEAK * peak,
              f"pool vs {what}: {err} (peak {peak})")
    check(again == slots[1] and released <= RELEASED_SLOT_ATOL, f"released slot {again}: {released}")


def _reverb_vs_offline(device) -> None:
    """Phase 10c: StreamingSynth(include_reverb=True) on the card against the
    offline fft_convolve of the same dry stream with the model's impulse."""
    wet = make_streaming_synth(BUNDLE, batch=2, device=device, noise_deterministic=True,
                               include_reverb=True)
    dry = make_streaming_synth(BUNDLE, batch=2, device=device, noise_deterministic=True)
    block = wet.block_size
    pitch, loud = glide(N_POOL_BLOCKS, block)
    pitch, loud = np.concatenate([pitch, pitch[:, ::-1]]), np.concatenate([loud, loud])
    wets, drys = [], []
    for i in range(N_POOL_BLOCKS):
        sl = slice(i * block, (i + 1) * block)
        wets.append(wet.step_samples(pitch[:, sl], loud[:, sl]))
        drys.append(dry.step_samples(pitch[:, sl], loud[:, sl]))
    got, d = torch.cat(wets, -1), torch.cat(drys, -1)
    with torch.no_grad():
        ir = wet.model.reverb.build_impulse()
    n = d.shape[-1]
    ir = ir[:n] if ir.shape[-1] >= n else torch.nn.functional.pad(ir, (0, n - ir.shape[-1]))
    want = fft_convolve(d, ir[None])
    err = float((got - want).abs().max())
    peak = float(got.abs().max())
    heard = float((want - d).abs().max())
    print(f"in-stream reverb ({wet._pir.spectra.shape[0]} partitions of {wet._pir.spectra.shape[1]} bins), "
          f"{N_POOL_BLOCKS} blocks x 2 voices on the card: max|streamed-offline|={err:.3e} peak={peak:.4f} "
          f"max|wet-dry|={heard:.4f}", flush=True)
    check(bool(torch.isfinite(got).all()) and heard > 1e-3, "reverb output")
    check(err <= REVERB_VS_OFFLINE_ATOL and err <= EXPORT_STREAM_REL_OF_PEAK * peak,
          f"in-stream reverb vs offline {err} (peak {peak})")


def _serve_clients(bundle: str, voices: int, n_clients: int, device, n_requests: int,
                   audio_in=None):
    """n_clients concurrent clients of a StreamServer(voices) with
    deterministic noise, each rendering n_requests blocks of one glide (and,
    for an autoencoder bundle, `audio_in`).  Returns (their streams, the
    server's kernel launches)."""
    server = serve.StreamServer(bundle, port=0, voices=voices, device=device, noise_deterministic=True)
    server.start()
    try:
        block = server.block_size
        pitch, loud = glide(n_requests, block)
        results = {}

        def run(i):
            c = serve.StreamClient(*server.address)
            try:
                extra = (lambda k: (audio_in[k * block:(k + 1) * block],)) if c.needs_audio else (lambda k: ())
                results[i] = np.concatenate([c.render(pitch[0, k * block:(k + 1) * block],
                                                      loud[0, k * block:(k + 1) * block], *extra(k))
                                             for k in range(n_requests)])
            finally:
                c.close()

        before = osc.oscillator_bank.launches
        threads = [threading.Thread(target=run, args=(i,)) for i in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        launches = osc.oscillator_bank.launches - before
        check(sorted(results) == list(range(n_clients)), f"a client of the voices={voices} server did not finish")
        return [results[i] for i in range(n_clients)], launches
    finally:
        server.stop()


def phase_pool(device, card: str) -> tuple:
    """Phase 10, with oscillator_fwd's count set to 0 just before it.
    Returns (its launches, the ramps)."""
    osc.reset_kernel_counts()
    _pool_vs_streams(device)
    _reverb_vs_offline(device)
    streams, served = _serve_clients(BUNDLE, N_SERVER_VOICES, N_SERVER_VOICES, device, N_REQUESTS)
    for a in streams:
        check(a.shape == (N_REQUESTS * 512,) and bool(np.isfinite(a).all()), "pooled server response")
        check(float(np.abs(a - streams[0]).max()) <= POOLED_VS_UNPOOLED_ATOL,
              "pooled sessions of one input differ")
    print(f"StreamServer(voices={N_SERVER_VOICES}): {N_SERVER_VOICES} concurrent clients x {N_REQUESTS} "
          f"requests answered; oscillator_fwd launches={served} (one per batched dispatch)", flush=True)
    check(0 < served <= N_SERVER_VOICES * N_REQUESTS + 1, f"pooled server launches {served}")
    ramps = {}
    for reverb, blocks in ((False, RAMP_BLOCKS), (True, RAMP_REVERB_BLOCKS)):
        ramp = voice_ramp(BUNDLE, RAMP_VOICES, blocks=blocks, include_reverb=reverb, device=device)
        ramps["reverb" if reverb else "dry"] = ramp
        for row in ramp["rows"]:
            check(row["oscillator_fwd_launches"] == blocks and row["peak"] > 1e-3,
                  f"ramp V={row['voices']}: {row['oscillator_fwd_launches']} launches, peak {row['peak']}")
        print(f"voice ramp ({'in-stream reverb' if reverb else 'dry, as the pooled server serves'}; "
              f"{blocks} blocks a V, one frame a block, VoicePool.step on the host clock with the audio "
              f"pull; budget {ramp['budget_ms']:.4f} ms; card {card}): " + "; ".join(
                  f"V={r['voices']} p50={r['block_ms_p50']:.4f} p99={r['block_ms_p99']:.4f} "
                  f"max={r['block_ms_max']:.4f} ms x{r['x_realtime_aggregate']:.1f} realtime "
                  f"(traced: device busy {r['device_busy_ms_per_block']:.4f} of "
                  f"{r['traced_block_ms']:.4f} ms a block, {r['kernel_launches_per_block']:.0f} launches)"
                  for r in ramp["rows"]) + f"; voices per card {voices_per_card_text(ramp)}", flush=True)
    torch.cuda.empty_cache()
    return osc.oscillator_bank.launches, ramps


def phase_autoencoder(device, card: str) -> int:
    """Phase 11, with oscillator_fwd's count set to 0 just before it: the AE
    bundle through make_stream_session on the card against the CPU, then
    through StreamServer at voices = 1 and N_SERVER_VOICES.  Returns its
    launches."""
    osc.reset_kernel_counts()
    gpu = make_stream_session(AE_BUNDLE, device=device, noise_deterministic=True)
    cpu = make_stream_session(AE_BUNDLE, device="cpu", noise_deterministic=True)
    block, sr = gpu.block_size, gpu.sample_rate
    n = N_BLOCKS * block
    t = np.arange(n) / sr
    f0 = 220.0 * 2.0 ** (t / t[-1])  # a 220 → 440 Hz glide
    phase = 2 * np.pi * np.cumsum(f0) / sr
    audio_in = sum(0.3 / h * np.sin(h * phase) for h in range(1, 6)).astype(np.float32)
    pitch, loud = f0.astype(np.float32), np.full(n, -7.0, np.float32)

    def sl(i):
        return slice(i * block, (i + 1) * block)

    warm = make_stream_session(AE_BUNDLE, device=device, noise_deterministic=True)
    for i in range(4):  # warm-up on a throwaway session
        warm.step_samples(pitch[sl(i)], loud[sl(i)], audio_in[sl(i)])
    render_ms, outs = [], []
    for i in range(N_BLOCKS):
        t0 = time.perf_counter()
        outs.append(gpu.step_samples(pitch[sl(i)], loud[sl(i)], audio_in[sl(i)]))
        render_ms.append((time.perf_counter() - t0) * 1e3)
    got = np.concatenate(outs)
    want = np.concatenate([cpu.step_samples(pitch[sl(i)], loud[sl(i)], audio_in[sl(i)]) for i in range(N_BLOCKS)])
    err, peak = float(np.abs(got - want).max()), float(np.abs(got).max())
    p50, p99 = np.percentile(render_ms[1:], [50, 99])
    print(f"autoencoder session ({AE_BUNDLE}, {N_BLOCKS} blocks of a 220-440 Hz harmonic input): "
          f"max|gpu-cpu|={err:.3e} peak={peak:.4f} first block silent={bool(np.all(got[:block] == 0))}; "
          f"render_ms (host MFCC, step and pull) p50={p50:.4f} p99={p99:.4f} max={max(render_ms[1:]):.4f} "
          f"budget_ms={1e3 * block / sr:.4f}; card {card}", flush=True)
    check(bool(np.isfinite(got).all()) and np.all(got[:block] == 0), "AE session output")
    check(peak > 1e-3, f"AE session silent (peak {peak})")
    check(err <= STREAM_GPU_VS_CPU_ATOL and err <= EXPORT_STREAM_REL_OF_PEAK * peak,
          f"AE session gpu vs cpu {err} (peak {peak})")

    n_req = 8
    served = {}
    for voices in (1, N_SERVER_VOICES):
        streams, launches = _serve_clients(AE_BUNDLE, voices, N_SERVER_VOICES, device, n_req, audio_in)
        served[voices] = (streams, launches)
    want = served[1][0][0]
    err = max(float(np.abs(a - want).max()) for streams, _ in served.values() for a in streams)
    print(f"autoencoder StreamServer: {N_SERVER_VOICES} concurrent clients x {n_req} requests at voices=1 "
          f"(launches {served[1][1]}) and voices={N_SERVER_VOICES} (launches {served[N_SERVER_VOICES][1]}): "
          f"max|pooled or unpooled - first session|={err:.3e} peak={float(np.abs(want).max()):.4f}", flush=True)
    check(float(np.abs(want).max()) > 1e-3 and np.all(want[:block] == 0), "served AE stream")
    check(err <= POOLED_VS_UNPOOLED_ATOL, f"AE pooled vs unpooled {err}")
    check(served[1][1] > 0 and served[N_SERVER_VOICES][1] > 0, "AE server launches")
    return osc.oscillator_bank.launches


def phase_ae_corpus(device, tmp: str) -> tuple:
    """Phase 12a, with the kernel counts set to 0 just before it: the violin
    AE corpus rendered on the card by train_pretrained.render_corpus; its
    first note against the CPU plain render of the same draws.  Returns
    (the cache directory, oscillator_fwd's launches)."""
    osc.reset_kernel_counts()
    t0 = time.perf_counter()
    cache = train_pretrained.render_corpus(tmp, "violin", True, AE_ITEMS, device)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    launches = osc.oscillator_bank.launches
    train = {n: np.load(os.path.join(cache, "train", f"{n}.npy")) for n in ("signals", "pitchs", "loudness", "mfccs")}
    # the first note of the train partition: the first draws of the seed
    cpu = make_synthetic_dataset(
        os.path.join(tmp, "corpus_cpu"), n_items=1, sample_rate=train_pretrained.SAMPLE_RATE,
        signal_length=train_pretrained.SIGNAL_LENGTH, block_size=train_pretrained.BLOCK_SIZE,
        n_harmonic=train_pretrained.CORPUS_HARMONICS, instrument="violin", mfcc_ref_db=0.0,
        seed=train_pretrained.corpus_seed("violin"), partitions=("train",), device="cpu")
    peak = float(np.abs(cpu["signals"][0]).max())
    sig_err = float(np.abs(train["signals"][0] - cpu["signals"][0]).max())
    loud_err = float(np.abs(train["loudness"][0] - cpu["loudness"][0]).max())
    mf_peak = float(np.abs(cpu["mfccs"][0]).max())
    mf_err = float(np.abs(train["mfccs"][0] - cpu["mfccs"][0]).max())
    print(f"AE corpus ({AE_ITEMS} x 2 violin notes of {train_pretrained.SIGNAL_LENGTH} samples at "
          f"{train_pretrained.SAMPLE_RATE} Hz, {train_pretrained.CORPUS_HARMONICS} harmonics, rows "
          f"{AE_ITEMS * train_pretrained.SIGNAL_LENGTH // train_pretrained.BLOCK_SIZE} a partition) rendered "
          f"on the card in {render_s:.3f} s, oscillator_fwd launches={launches}; shapes "
          f"{ {n: a.shape for n, a in train.items()} }; first note vs the CPU plain render: "
          f"max|signal|={sig_err:.3e} (peak {peak:.4f}, {sig_err / peak:.3e} of it), pitch bitwise "
          f"{bool(np.array_equal(train['pitchs'][0], cpu['pitchs'][0]))}, max|loudness|={loud_err:.3e}, "
          f"max|mfcc|={mf_err:.3e} (peak {mf_peak:.2f})", flush=True)
    check(launches == 2, f"the corpus took {launches} forward launches, not one a partition")
    check(train["signals"].shape == (AE_ITEMS, train_pretrained.SIGNAL_LENGTH)
          and train["mfccs"].shape == (AE_ITEMS, train_pretrained.SIGNAL_LENGTH // train_pretrained.BLOCK_SIZE + 1, 30)
          and all(bool(np.isfinite(a).all()) for a in train.values()), "AE corpus arrays")
    check(np.array_equal(train["pitchs"][0], cpu["pitchs"][0]), "corpus pitch differs from the CPU's")
    check(sig_err <= CORPUS_REL_OF_PEAK * peak, f"corpus audio vs CPU {sig_err} (peak {peak})")
    check(loud_err <= LOUDNESS_ATOL and mf_err <= MFCC_REL_OF_PEAK * mf_peak,
          f"corpus features vs CPU: loudness {loud_err}, mfcc {mf_err}")
    return cache, launches


def phase_ae_run(device, cache: str, tmp: str) -> tuple:
    """Phase 12b, with the kernel counts set to 0 just before it: Trainer.fit
    at pretrained/ddsp_violin_ae_config.yaml for N_AE_STEPS steps (its cache,
    steps and intervals overridden).  Returns ({kernel: launches on this
    path}, the run directory)."""
    cfg = Config.from_yaml(AE_VIOLIN_CONFIG)
    cfg.apply_overrides([
        f"preprocess.out_dir={cache}", f"train.steps={N_AE_STEPS}",
        f"train.val_interval_epochs={AE_INTERVAL_EPOCHS}", f"train.log_interval_epochs={AE_INTERVAL_EPOCHS}",
        f"train.checkpoint_every_steps={AE_CHECKPOINT_STEPS}",
    ])
    run_dir = os.path.join(tmp, "run_violin_ae")
    dm = Datamodule(cfg, device_cache=True, device=device)
    dm.setup()
    trainer = Trainer(cfg, run_dir, device=device)
    osc.reset_kernel_counts()
    t0 = time.perf_counter()
    state = trainer.fit(dm)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    trainer.close()
    counts = {name: (w.launches, w.captured, w.replayed) for name, w in osc.KERNEL_WRAPPERS.items()}
    multi = trainer._multi_step
    losses = [v for _, v in read_metrics(run_dir, "loss")]
    skipped = [v for _, v in read_metrics(run_dir, "update_skipped")]
    sps = read_metrics(run_dir, "steps_per_s")
    window = read_metrics(run_dir, "train_window_steps_per_s")
    val = read_metrics(run_dir, "loss/val")
    with open(JAX_AE_LOSS) as f:
        jax_curve = json.load(f)["loss_curve_every_100"]
    first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    print(
        f"violin AE run ({AE_VIOLIN_CONFIG}: steps_per_call {cfg.train.steps_per_call}, scan_unroll "
        f"{cfg.train.scan_unroll}, batch {cfg.train.batch} x {cfg.n_frames} frames, device cache): {state.step} "
        f"steps in {fit_s:.2f} s; steps_per_s {[round(v, 4) for _, v in sps]}; train window "
        f"{window[-1][1]:.4f} steps/s; capture+instantiate s={multi.capture_s:.3f}, graph pool bytes="
        f"{multi.pool_bytes}, replays={multi.replays}; loss first5={first5:.5f} last5={last5:.5f} factor="
        f"{first5 / last5:.4f}; val={[round(v, 5) for _, v in val]}; kernel counts (launches, captured, "
        f"replayed) {counts}; eval_forwards={trainer.eval_forwards}", flush=True)
    print(f"violin AE loss at step 1: {losses[0]:.5f} and step {N_AE_STEPS}: {losses[N_AE_STEPS - 1]:.5f} "
          f"(the JAX run of {JAX_AE_LOSS}, other initial weights: {jax_curve[0]:.5f} and {jax_curve[1]:.5f}); "
          "curve: " + " ".join(f"{v:.4f}" for v in losses), flush=True)
    check(state.step == N_AE_STEPS and len(losses) == N_AE_STEPS, "AE steps run")
    check(all(np.isfinite(losses)) and sum(skipped) == 0, "AE run: a loss not finite or a skip")
    check(first5 >= LOSS_FALL_FACTOR * last5,
          f"AE run: loss did not fall by {LOSS_FALL_FACTOR}x: first5 {first5} last5 {last5}")
    check(multi.replays == N_AE_STEPS // cfg.train.scan_unroll, f"AE replays {multi.replays}")
    for name, (_, captured, replayed) in counts.items():
        check(captured == cfg.train.scan_unroll and replayed == N_AE_STEPS,
              f"{name} captured {captured}, replayed {replayed}x in {N_AE_STEPS} graphed AE steps")
    del trainer, state, multi, dm
    torch.cuda.empty_cache()
    return {name: launches + replayed for name, (launches, _, replayed) in counts.items()}, run_dir


def phase_ae_graphed_vs_eager(device, cache: str, card: str) -> None:
    """Phase 12c: the AE train step as a CUDA graph (U = 1) against eager
    steps at configs/autoencoder.yaml's full width (batch 16 x 375 frames),
    from one state on the same N_GRAPH_STEPS batches of the device-resident
    corpus: per-step losses and every leaf within GRAPHED_REL; ms per step,
    synced, for both; the graph pool and the peak memory of each."""
    cfg = Config.from_yaml(AE_CONFIG)
    loader = DeviceDataLoader(Dataset(os.path.join(cache, "train")), cfg.train.batch, shuffle=True,
                              drop_last=True, seed=SEED, device=device)
    idx2d = []
    for epoch in range(N_GRAPH_STEPS):
        loader.set_epoch(epoch)
        idx2d += list(loader.index_batches())
    idx2d = np.stack(idx2d[:N_GRAPH_STEPS])
    base = init_params(DDSPAutoencoder(**cfg.model.kwargs), torch.Generator().manual_seed(SEED)).to(device)
    mean, std = loader.loudness_stats()

    def fresh():
        model = copy.deepcopy(base)
        tx = make_optimizer(cfg)
        state = TrainState(0, model, tx.init([q for _, q in model.named_parameters()]),
                           torch.Generator(device).manual_seed(SEED + 20), mean, std)
        return model, tx, state

    model_e, tx_e, state_e = fresh()
    step = make_train_step(model_e, tx_e, cfg)
    torch.cuda.reset_peak_memory_stats(device)
    eager = torch.stack([metrics_row(step(state_e, loader.take(i))) for i in idx2d]).cpu()
    eager_peak = torch.cuda.max_memory_allocated(device)
    model_g, tx_g, state_g = fresh()
    multi = make_train_multi_step_indexed(model_g, tx_g, cfg, N_GRAPH_STEPS, 1)
    torch.cuda.reset_peak_memory_stats(device)
    graphed = multi(state_g, loader.device_data, idx2d).cpu()
    peak = torch.cuda.max_memory_allocated(device)
    loss_rel = rel_err(graphed[:, 0], eager[:, 0])
    leaf = _leaf_rel(model_g, model_e)
    worst = max(leaf, key=leaf.get)
    bitwise = torch.equal(graphed, eager) and all(
        torch.equal(x, y) for x, y in zip(model_g.parameters(), model_e.parameters()))
    call_ms = []
    for _ in range(N_TIMED_CALLS):
        t1 = time.perf_counter()
        multi(state_g, loader.device_data, idx2d)
        torch.cuda.synchronize()
        call_ms.append((time.perf_counter() - t1) * 1e3)
    graphed_ms = float(np.median(call_ms)) / N_GRAPH_STEPS
    eager_ms = []
    for i in range(N_TIMED_EAGER):
        batch = loader.take(idx2d[i % N_GRAPH_STEPS])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step(state_e, batch)
        torch.cuda.synchronize()
        eager_ms.append((time.perf_counter() - t1) * 1e3)
    print(
        f"AE graphed vs eager step ({AE_CONFIG} full width, batch {cfg.train.batch} x {cfg.n_frames} frames, "
        f"{N_GRAPH_STEPS} steps, U=1): per-step loss max rel {loss_rel:.3e}; worst leaf {worst} rel "
        f"{leaf[worst]:.3e}; bitwise equal: {bitwise}; capture+instantiate s={multi.capture_s:.3f}; graph pool "
        f"bytes={multi.pool_bytes} peak bytes={peak} (eager peak {eager_peak}); captured per graph "
        f"{multi.captured}; graphed ms/step (median of {N_TIMED_CALLS} synced calls of {N_GRAPH_STEPS}) = "
        f"{graphed_ms:.3f}; eager ms/step (median of {N_TIMED_EAGER} synced steps) = "
        f"{float(np.median(eager_ms)):.3f} (min {min(eager_ms):.3f} max {max(eager_ms):.3f}); card {card}",
        flush=True)
    check(loss_rel <= GRAPHED_REL, f"AE graphed vs eager loss rel {loss_rel}")
    check(leaf[worst] <= GRAPHED_REL, f"AE graphed vs eager {worst} rel {leaf[worst]}")
    check(multi.captured == {"oscillator_fwd": 1, "oscillator_bwd": 1}, f"AE captured {multi.captured}")
    del multi, model_g, state_g, model_e, state_e, base, loader
    torch.cuda.empty_cache()


def phase_ae_export_serve(device, run_dir: str, cache: str, tmp: str) -> int:
    """Phase 12d: export_run on the AE run (its parameters bit for bit), the
    bundle through make_stream_session on the card against the CPU on a
    validation note of the corpus, and one StreamServer client's requests.
    Then the train_pretrained CLI for N_CLI_STEPS steps on the same corpus,
    into a temporary --out.  Returns oscillator_fwd's launches while
    serving the bundle."""
    out_dir = os.path.join(tmp, "export_ae")
    bundle = export_run(run_dir, out_dir, name="smoke_ae", device=device)
    exported = load_bundle(bundle, device="cpu")[0].state_dict()
    trained = run_params(run_dir)
    check(exported.keys() == trained.keys() and all(torch.equal(exported[k], trained[k]) for k in trained),
          "the exported AE parameters differ from the run's")
    gpu = make_stream_session(bundle, device=device, noise_deterministic=True)
    cpu = make_stream_session(bundle, device="cpu", noise_deterministic=True)
    block = gpu.block_size
    val = {n: np.load(os.path.join(cache, "validation", f"{n}.npy"))[0] for n in ("signals", "pitchs", "loudness")}
    # N_BLOCKS frames from the middle of the note (past its attack), its
    # controls and its audio
    start = (val["pitchs"].shape[0] - N_BLOCKS) // 2
    pitch, loud = (np.repeat(val[k][start:start + N_BLOCKS], block) for k in ("pitchs", "loudness"))
    audio = val["signals"][start * block:(start + N_BLOCKS) * block]

    def sl(i):
        return slice(i * block, (i + 1) * block)

    osc.reset_kernel_counts()
    got = np.concatenate([gpu.step_samples(pitch[sl(i)], loud[sl(i)], audio[sl(i)]) for i in range(N_BLOCKS)])
    streamed = osc.oscillator_bank.launches
    want = np.concatenate([cpu.step_samples(pitch[sl(i)], loud[sl(i)], audio[sl(i)]) for i in range(N_BLOCKS)])
    err, peak = float(np.abs(got - want).max()), float(np.abs(got).max())
    server = serve.StreamServer(bundle, port=0, device=device)
    server.start()
    try:
        client = serve.StreamClient(*server.address)
        served_audio = [client.render(pitch[sl(i)], loud[sl(i)], audio[sl(i)]) for i in range(4)]
        client.close()
    finally:
        server.stop()
    served = osc.oscillator_bank.launches - streamed
    print(f"exported AE bundle {os.path.basename(bundle)}: parameters equal to the run's; {N_BLOCKS} blocks from "
          f"the middle of a validation note through make_stream_session on the card vs the CPU: max|gpu-cpu|={err:.3e} "
          f"peak={peak:.3e}; first block silent {bool(np.all(got[:block] == 0))}; oscillator_fwd launches="
          f"{streamed}; server: 4 requests, {served} launches, peak "
          f"{max(float(np.abs(a).max()) for a in served_audio):.3e}", flush=True)
    check(bool(np.isfinite(got).all()) and np.all(got[:block] == 0) and peak > 0, "exported AE stream")
    check(err <= STREAM_GPU_VS_CPU_ATOL and err <= EXPORT_STREAM_REL_OF_PEAK * peak,
          f"exported AE bundle gpu vs cpu {err} (peak {peak})")
    check(streamed >= N_BLOCKS - 1 and served > 0, f"AE stream launches {streamed}, {served}")
    for a in served_audio:
        check(a.shape == (block,) and bool(np.isfinite(a).all()), "AE server response")

    cli_out = os.path.join(tmp, "train_pretrained_out")
    t0 = time.perf_counter()
    cli_bundle = train_pretrained.main(["--model", "mfcc-autoencoder", "--instrument", "violin",
                                        "--steps", str(N_CLI_STEPS), "--root", tmp, "--out", cli_out,
                                        "--device", "cuda"])
    files = sorted(os.listdir(cli_out))
    print(f"train_pretrained CLI ({N_CLI_STEPS} steps on the rendered corpus) in "
          f"{time.perf_counter() - t0:.2f} s: wrote {files} under a temporary --out", flush=True)
    check(files == ["ddsp_violin_ae_bundle", "ddsp_violin_ae_config.yaml", "ddsp_violin_ae_impulse.wav",
                    "violin_ae_loss.json"] and cli_bundle == os.path.join(cli_out, "ddsp_violin_ae_bundle"),
          f"train_pretrained outputs {files}")
    torch.cuda.empty_cache()
    return streamed + served


def phase_ae_preprocess(device, cache: str, tmp: str) -> None:
    """Phase 12e: preprocess_folder (YIN) at the AE config on two wav files
    written from the corpus, one at 44.1 kHz (resampled on load), on the
    card against the CPU plain path."""
    sr = train_pretrained.SAMPLE_RATE
    notes = np.load(os.path.join(cache, "validation", "signals.npy"))[:2]
    os.makedirs(os.path.join(tmp, "wavs", "train"))
    save_wav(os.path.join(tmp, "wavs", "train", "a.wav"), notes[0], sr)
    save_wav(os.path.join(tmp, "wavs", "train", "b.wav"), resample_poly(notes[1], 147, 160), 44100)
    out = {}
    for side in ("cuda", "cpu"):
        cfg = Config.from_yaml(AE_VIOLIN_CONFIG)
        cfg.apply_overrides([f"preprocess.out_dir={os.path.join(tmp, 'pre_' + side)}",
                             f"data.data_location={os.path.join(tmp, 'wavs')}"])
        t0 = time.perf_counter()
        preprocess_folder(cfg.data.data_location, "train", cfg, device=device if side == "cuda" else "cpu")
        secs = time.perf_counter() - t0
        out[side] = {n: np.load(os.path.join(cfg.preprocess.out_dir, "train", f"{n}.npy"))
                     for n in ("signals", "pitchs", "loudness", "mfccs")}
        print(f"preprocess (pitch_tracker {cfg.preprocess.pitch_tracker}) of 2 files on the {side}: {secs:.3f} s",
              flush=True)
    gpu, cpu = out["cuda"], out["cpu"]
    agree = float(np.mean(np.abs(gpu["pitchs"] / cpu["pitchs"] - 1.0) <= PITCH_RTOL))
    loud_err = float(np.abs(gpu["loudness"] - cpu["loudness"]).max())
    mf_peak = float(np.abs(cpu["mfccs"]).max())
    mf_err = float(np.abs(gpu["mfccs"] - cpu["mfccs"]).max())
    print(f"preprocess on the card vs the CPU: shapes { {n: a.shape for n, a in gpu.items()} }; signals equal "
          f"{bool(np.array_equal(gpu['signals'], cpu['signals']))}; f0 within {PITCH_RTOL} on {100 * agree:.2f} % "
          f"of frames (max rel {float(np.abs(gpu['pitchs'] / cpu['pitchs'] - 1).max()):.3e}; median f0 "
          f"{float(np.median(gpu['pitchs'])):.2f} Hz); max|loudness|={loud_err:.3e}; max|mfcc|={mf_err:.3e} "
          f"(peak {mf_peak:.2f})", flush=True)
    check(gpu["signals"].shape == (2, train_pretrained.SIGNAL_LENGTH)
          and np.array_equal(gpu["signals"], cpu["signals"]), "preprocess signals")
    check(all(bool(np.isfinite(a).all()) for a in gpu.values()), "preprocess arrays not finite")
    check(agree >= PITCH_FRAMES_AGREE, f"YIN on the card agrees with the CPU on {agree} of frames")
    check(loud_err <= LOUDNESS_ATOL and mf_err <= MFCC_REL_OF_PEAK * mf_peak,
          f"preprocess features vs CPU: loudness {loud_err}, mfcc {mf_err}")


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _pink_glide(sr: int, n: int, seed: int, f_lo: float, f_hi: float, noise_db: float):
    """A 5-harmonic exponential glide from f_lo to f_hi plus pink noise at
    `noise_db` of the tone's peak: (float32 audio (n,), f0 of each sample)."""
    rng = np.random.default_rng(seed)
    f0 = f_lo * (f_hi / f_lo) ** (np.arange(n) / n)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    tone = sum(0.4 / h * np.sin(h * phase) for h in range(1, 6))
    spec = np.fft.rfft(rng.standard_normal(n))
    pink = np.fft.irfft(spec / np.sqrt(np.arange(spec.size) + 1.0), n)
    pink *= 10 ** (noise_db / 20) * np.abs(tone).max() / np.abs(pink).max()
    return (tone + pink).astype(np.float32), f0


def phase_crepe_forward(device) -> None:
    """Phase 13a: the shipped CREPE on the card against the CPU plain path
    on N_CREPE_FRAMES frames of a glide with pink noise, then again with
    TF32 allowed globally for cuDNN and cuBLAS (restored after); the
    card's frames/s."""
    hop = 160  # 10 ms at 16 kHz
    x16, _ = _pink_glide(crepe.MODEL_SRATE, (N_CREPE_FRAMES - 1) * hop, 30, 110.0, 880.0, -20.0)
    pad = crepe.FRAME_LENGTH // 2
    idx = np.arange(N_CREPE_FRAMES)[:, None] * hop + np.arange(crepe.FRAME_LENGTH)[None, :]
    frames = torch.tensor(np.pad(x16, (pad, pad))[idx])
    gpu = crepe.load_crepe(CREPE_PARAMS, device=device)
    frames_gpu = frames.to(device)
    with torch.inference_mode():
        t0 = time.perf_counter()
        want = torch.sigmoid(crepe.load_crepe(CREPE_PARAMS, device="cpu")(frames))
        cpu_s = time.perf_counter() - t0
        got = torch.sigmoid(gpu(frames_gpu)).cpu()
        secs = []
        for _ in range(5):
            _sync(device)
            t0 = time.perf_counter()
            gpu(frames_gpu)
            _sync(device)
            secs.append(time.perf_counter() - t0)
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            got_tf32 = torch.sigmoid(gpu(frames_gpu)).cpu()
            still = torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
        finally:
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
    err = float((got - want).abs().max())
    err_tf32 = float((got_tf32 - want).abs().max())
    fps = N_CREPE_FRAMES / float(np.median(secs))
    print(f"CREPE tiny forward, {N_CREPE_FRAMES} frames of a 110-880 Hz glide + pink noise: max|salience "
          f"card-CPU|={err:.3e}; {err_tf32:.3e} with cudnn.allow_tf32 and matmul.allow_tf32 set globally "
          f"(still set inside the call: {still}); bound {CREPE_SALIENCE_ATOL}; card ms "
          f"{[round(1e3 * s, 3) for s in secs]} = {fps:.0f} frames/s; CPU {cpu_s:.3f} s", flush=True)
    check(bool(torch.isfinite(got).all()), "CREPE salience not finite")
    check(err <= CREPE_SALIENCE_ATOL and err_tf32 <= CREPE_SALIENCE_ATOL,
          f"CREPE on the card vs the CPU: {err}, with TF32 allowed globally {err_tf32}")


def _path_cost(cost: np.ndarray, path: np.ndarray, switch: np.ndarray) -> float:
    """Σ_t cost[t, path[t]] + switch[path[t−1], path[t]], in float64."""
    cost, switch = cost.astype(np.float64), switch.astype(np.float64)
    return float(cost[np.arange(len(path)), path].sum() + switch[path[:-1], path[1:]].sum())


def _tracker_cost(name: str, x, sr: int, block: int, model, device):
    """(the (F16, 360) cost extract_pitch_<name> runs its Viterbi on at its
    defaults, as numpy; its path; the switch cost), on `device`."""
    if name == "crepe":
        sal, _ = crepe.crepe_salience(x, sr, block, model, device=device)
        cost, per_octave = -torch.log(torch.clamp(sal, 1e-6, 1.0)), 3.0
    else:
        sal, d_16, _ = crepe.hybrid_evidence(x, sr, block, model, device=device)
        cost = crepe.fused_cost(sal, d_16, yin_weight=8.0, salience_floor=0.03, confidence_gate=2.0,
                                keep=crepe.cents_keep(32.0, 2100.0))
        per_octave = 60.0
    return cost.cpu().numpy(), crepe.viterbi_path(cost, per_octave), switch_cost(crepe.N_BINS, crepe.BINS_PER_OCTAVE, per_octave)


def phase_trackers(device) -> None:
    """Phase 13b: extract_pitch_crepe and extract_pitch_hybrid on a 4 s,
    48 kHz glide of known f0 with a −20 dB pink-noise floor, on the card
    against the CPU: Viterbi paths equal on every frame (else the differing
    frames are printed with their cost margins), f0 within TRACK_CENTS on
    every frame, RPA@50 cents against the known f0 on the voiced frames;
    seconds a call; then one hybrid call's stages timed and traced."""
    sr, block = 48000, 512
    x, f0_true = _pink_glide(sr, 4 * sr, 31, 196.0, 784.0, -20.0)
    n_out = x.size // block
    truth = f0_true[np.arange(n_out) * block]
    # voiced: the frames whose CREPE window (1024 samples at 16 kHz, three
    # blocks each side) lies inside the clip
    voiced = slice(3, n_out - 3)
    models = {"cuda": crepe.load_crepe(CREPE_PARAMS, device=device),
              "cpu": crepe.load_crepe(CREPE_PARAMS, device="cpu")}
    for name, fn in (("crepe", crepe.extract_pitch_crepe), ("hybrid", crepe.extract_pitch_hybrid)):
        fn(x, sr, block, models["cuda"], device=device)  # warm-up: cuDNN and cuFFT plans
        _sync(device)
        t0 = time.perf_counter()
        got = fn(x, sr, block, models["cuda"], device=device).cpu().numpy()
        secs = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = fn(x, sr, block, models["cpu"], device="cpu").numpy()
        cpu_secs = time.perf_counter() - t0
        cost_g, path_g, switch = _tracker_cost(name, x, sr, block, models["cuda"], device)
        cost_c, path_c, _ = _tracker_cost(name, x, sr, block, models["cpu"], "cpu")
        differ = np.nonzero(path_g != path_c)[0]
        cents = 1200 * np.abs(np.log2(got / want))
        err_true = 1200 * np.abs(np.log2(got[voiced] / truth[voiced]))
        rpa = float(np.mean(err_true <= RPA_CENTS))
        print(f"{name} tracker, 4 s 196-784 Hz glide + pink noise at -20 dB ({len(path_g)} CREPE frames): "
              f"card {secs:.4f} s a call, CPU {cpu_secs:.4f} s; Viterbi paths differ on {differ.size} frames; "
              f"max|f0 card-CPU| {cents.max():.3e} cents; against the known f0 on {err_true.size} voiced "
              f"frames: RPA@50c {rpa:.4f}, median |cents| {float(np.median(err_true)):.3f}, max "
              f"{float(err_true.max()):.3f}", flush=True)
        if differ.size:
            margins = [(int(t), int(path_g[t]), int(path_c[t]), float(cost_c[t, path_g[t]] - cost_c[t, path_c[t]]))
                       for t in differ[:20]]
            whole = _path_cost(cost_c, path_g, switch) - _path_cost(cost_c, path_c, switch)
            print(f"  differing frames (frame, card bin, CPU bin, cost margin on the CPU's costs): {margins}; "
                  f"whole-path margin {whole:.3e}", flush=True)
        check(got.shape == want.shape == (n_out,) and bool(np.isfinite(got).all()), f"{name} tracker output")
        check(differ.size == 0, f"{name}: Viterbi paths differ on {differ.size} frames")
        check(float(cents.max()) <= TRACK_CENTS, f"{name}: card vs CPU {cents.max()} cents")
        check(rpa == 1.0, f"{name}: RPA@50c {rpa} on the voiced frames")
    _hybrid_breakdown(x, sr, block, models["cuda"], device)


def _hybrid_breakdown(x, sr: int, block: int, model, device) -> None:
    """One hybrid call on the card by stage (CREPE salience, YIN emission,
    the fused decode with its Viterbi loop), each timed between
    synchronizes, then the whole call traced: wall, device busy, idle
    share, kernels launched and the kernels with the most device time."""
    xt = torch.tensor(x, device=device)
    stages = {}

    def timed(key, fn):
        _sync(device)
        t0 = time.perf_counter()
        value = fn()
        _sync(device)
        stages[key] = (time.perf_counter() - t0) * 1e3
        return value

    timed("salience", lambda: crepe.crepe_salience(xt, sr, block, model, device=device))
    timed("yin", lambda: yin_emission(xt, sr, block, fmin=32.0, fmax=2100.0))
    sal, d_16, _ = crepe.hybrid_evidence(xt, sr, block, model, device=device)
    timed("decode", lambda: crepe.decode_fused(sal, d_16, yin_weight=8.0, switch_per_octave=60.0,
                                               salience_floor=0.03, confidence_gate=2.0,
                                               keep=crepe.cents_keep(32.0, 2100.0)))
    with torch.profiler.profile(activities=PROFILER_ACTIVITIES) as prof:
        _sync(device)
        t0 = time.perf_counter()
        crepe.extract_pitch_hybrid(xt, sr, block, model, device=device)
        _sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, busy_ms = device_kernels(prof)
    by_name = {}
    for e in kernels:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    n16 = sal.shape[-2]
    print("hybrid call on the card by stage (ms, each between synchronizes): "
          + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
          + f"; traced: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms (idle "
          f"{100 * (1 - busy_ms / wall_ms):.1f} %), {len(kernels)} kernels ({len(kernels) / n16:.1f} a CREPE "
          f"frame, {n16} frames)", flush=True)
    print("  kernels with the most device time: " + "; ".join(
        f"{name[:80]} x{n} {us / 1e3:.3f} ms" for name, (n, us) in top), flush=True)


def phase_default_preprocess(device, tmp: str) -> None:
    """Phase 13c: preprocess_folder at configs/config.yaml's preprocess
    section (pitch_tracker hybrid, the shipped crepe_tiny) on two wav
    files, one at 44.1 kHz (resampled on load), on the card against the
    CPU plain path, with phase 12e's checks."""
    base = Config.from_yaml(CONFIG)
    sr, length = base.preprocess.sample_rate, base.preprocess.signal_length
    a, _ = _pink_glide(sr, length, 32, 150.0, 600.0, -30.0)
    b, _ = _pink_glide(44100, length * 441 // 480, 33, 400.0, 250.0, -30.0)
    os.makedirs(os.path.join(tmp, "wavs", "train"))
    save_wav(os.path.join(tmp, "wavs", "train", "a.wav"), a, sr)
    save_wav(os.path.join(tmp, "wavs", "train", "b.wav"), b, 44100)
    out = {}
    for side in ("cuda", "cpu"):
        cfg = Config.from_yaml(CONFIG)
        cfg.apply_overrides([f"preprocess.out_dir={os.path.join(tmp, 'pre_' + side)}",
                             f"data.data_location={os.path.join(tmp, 'wavs')}"])
        t0 = time.perf_counter()
        preprocess_folder(cfg.data.data_location, "train", cfg, device=device if side == "cuda" else "cpu")
        secs = time.perf_counter() - t0
        out[side] = {n: np.load(os.path.join(cfg.preprocess.out_dir, "train", f"{n}.npy"))
                     for n in ("signals", "pitchs", "loudness", "mfccs")}
        print(f"preprocess at {CONFIG} (pitch_tracker {cfg.preprocess.pitch_tracker}) of 2 files on the {side}: "
              f"{secs:.3f} s", flush=True)
    gpu, cpu = out["cuda"], out["cpu"]
    rel = np.abs(gpu["pitchs"] / cpu["pitchs"] - 1.0)
    agree = float(np.mean(rel <= PITCH_RTOL))
    loud_err = float(np.abs(gpu["loudness"] - cpu["loudness"]).max())
    mf_peak = float(np.abs(cpu["mfccs"]).max())
    mf_err = float(np.abs(gpu["mfccs"] - cpu["mfccs"]).max())
    print(f"hybrid preprocess on the card vs the CPU: shapes { {n: v.shape for n, v in gpu.items()} }; f0 within "
          f"{PITCH_RTOL} on {100 * agree:.2f} % of frames (max rel {float(rel.max()):.3e}; median f0 "
          f"{float(np.median(gpu['pitchs'])):.2f} Hz); max|loudness|={loud_err:.3e}; max|mfcc|={mf_err:.3e} "
          f"(peak {mf_peak:.2f})", flush=True)
    check(gpu["signals"].shape == (2, length) and np.array_equal(gpu["signals"], cpu["signals"]),
          "hybrid preprocess signals")
    check(all(bool(np.isfinite(v).all()) for v in gpu.values()), "hybrid preprocess arrays not finite")
    check(agree >= PITCH_FRAMES_AGREE, f"hybrid pitch on the card agrees with the CPU on {agree} of frames")
    check(loud_err <= LOUDNESS_ATOL and mf_err <= MFCC_REL_OF_PEAK * mf_peak,
          f"hybrid preprocess features vs CPU: loudness {loud_err}, mfcc {mf_err}")


def phase_transfer(device, tmp: str) -> int:
    """Phase 13d, with oscillator_fwd's count set to 0 just before it:
    timbre_transfer through a full-width bundle of each family (sigmund:
    hybrid tracker, decoder; violin AE: its YIN tracker, autoencoder) on a
    3 s 220 Hz harmonic input at octave shifts 0 and 1, on the card with
    and without noise and on the CPU without: length, finite, the
    harmonic-only render's YIN median at the shifted 220 Hz, one forward
    launch a card call; the card's controls against the CPU's, the card's
    render of the CPU's controls against the CPU's render, and the whole
    path card against CPU; then the transfer CLI into a temporary file.
    Returns the forward kernel's launches."""
    osc.reset_kernel_counts()
    sr = 48000
    n = 3 * sr
    phase = 2 * np.pi * 220.0 * np.arange(n) / sr
    x = (sum(0.3 / h * np.sin(h * phase) for h in range(1, 6))
         + 0.003 * np.random.default_rng(34).standard_normal(n)).astype(np.float32)
    frames = n // 512
    check((frames, 64, 512) == TRANSFER_SHAPE, f"transfer's kernel shape is not phase 2's {TRANSFER_SHAPE}")
    for bundle in (SIGMUND_BUNDLE, AE_BUNDLE):
        cfg = Config.from_yaml(os.path.join(bundle, "config.yaml"))
        model, _ = load_bundle(bundle, device=device)
        for octave in (0.0, 1.0):
            calls = []

            def call(fn, dev, *args, **kw):
                before = osc.oscillator_bank.launches
                t0 = time.perf_counter()
                y = fn(*args, device=dev, **kw)
                calls.append((time.perf_counter() - t0, osc.oscillator_bank.launches - before))
                return y

            det = call(timbre_transfer, device, bundle, x, sr, octave_shift=octave, noise_deterministic=True)
            noisy = call(timbre_transfer, device, bundle, x, sr, octave_shift=octave)
            det_cpu = call(timbre_transfer, "cpu", bundle, x, sr, octave_shift=octave, noise_deterministic=True)
            ctrl_cpu = transfer_controls(cfg, x, octave_shift=octave, device="cpu")
            ctrl_gpu = transfer_controls(cfg, x, octave_shift=octave, device=device)
            same = call(render, device, model, cfg, *ctrl_cpu, noise_deterministic=True)
            f0_rel = float(np.abs(ctrl_gpu[0] / ctrl_cpu[0] - 1.0).max())
            loud_err = float(np.abs(ctrl_gpu[1] - ctrl_cpu[1]).max())
            # YIN on the harmonic-only render: the sigmund model's noise
            # branch dominates its full output at this input's loudness
            median, median_full = (float(np.median(extract_pitch(y, sr, 512, device=device).cpu().numpy()[8:-8]))
                                   for y in (det, noisy))
            target = 220.0 * 2.0 ** octave
            peak = float(np.abs(det_cpu).max())
            err_same = float(np.abs(same - det_cpu).max())
            err = float(np.abs(det - det_cpu).max())
            (det_s, det_n), (secs, n_launch), (cpu_s, cpu_n), (_, same_n) = calls
            print(f"timbre_transfer {bundle} octave {octave:+.0f}: {len(noisy)} samples; card {secs:.3f} s a call "
                  f"({n / sr / secs:.1f}x realtime; harmonic-only {det_s:.3f} s), CPU {cpu_s:.3f} s; YIN median of "
                  f"the harmonic-only output {median:.2f} Hz (target {target:.0f}; of the full output "
                  f"{median_full:.2f}); controls card vs CPU: f0 max rel {f0_rel:.3e}, loudness {loud_err:.3e}; "
                  f"harmonic-only, peak {peak:.4f}: the CPU's controls rendered on the card vs the CPU "
                  f"{err_same:.3e}, the whole path card vs CPU {err:.3e}; launches per card call "
                  f"{det_n}, {n_launch}, {same_n}", flush=True)
            check(noisy.shape == det.shape == (frames * 512,) and bool(np.isfinite(noisy).all())
                  and bool(np.isfinite(det).all()), f"transfer output of {bundle}")
            check(abs(median / target - 1.0) <= TRANSFER_F0_REL, f"transfer f0 {median} against {target}")
            check(f0_rel <= TRANSFER_CONTROL_F0_REL and loud_err <= LOUDNESS_ATOL,
                  f"transfer controls card vs CPU: f0 {f0_rel}, loudness {loud_err}")
            check(peak > 1e-4 and err_same <= TRANSFER_REL_OF_PEAK * peak,
                  f"the CPU's controls rendered on the card vs the CPU {err_same} (peak {peak})")
            check(err <= TRANSFER_WHOLE_REL_OF_PEAK * peak, f"transfer card vs CPU {err} (peak {peak})")
            check(det_n == n_launch == same_n == 1 and cpu_n == 0, f"forward launches per transfer call {calls}")
    wav_in, wav_out = os.path.join(tmp, "transfer_in.wav"), os.path.join(tmp, "transfer_out.wav")
    save_wav(wav_in, x, sr)
    t0 = time.perf_counter()
    transfer.main(["--bundle", SIGMUND_BUNDLE, "--input", wav_in, "--output", wav_out, "--octave-shift", "1"])
    with wave.open(wav_out) as f:
        written = (f.getnchannels(), f.getframerate(), f.getnframes())
    print(f"transfer CLI ({SIGMUND_BUNDLE}, octave +1) wrote {written} (channels, rate, frames) in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    check(written == (1, sr, frames * 512), f"transfer CLI wrote {written}")
    return osc.oscillator_bank.launches


def phase_headline(device, card: str) -> int:
    """Phase 14, with the kernel counts set to 0 just before it: the port's
    bench.py (×-realtime at 48 kHz, 100 harmonics, hidden 512; dispatch and
    value-pull), one forward launch a synth call, then performance.py on the
    violin bundle at batch 1.  Returns its forward launches."""
    osc.reset_kernel_counts()
    line = bench.main(["--device", str(device)])
    bench_launches = osc.oscillator_bank.launches
    r = performance.run_benchmark(BUNDLE, n_run=10, batch=1, device=device)
    launches = osc.oscillator_bank.launches
    print(f"headline: {line['value']:.3f}x realtime dispatch ({line['mean_ms_per_call']:.4f} ms a "
          f"{line['audio_ms_per_call']:.1f} ms call), {line['value_pull_x_realtime']:.3f}x value-pull "
          f"({line['value_pull_ms_per_call']:.4f} ms); forward launches {bench_launches} for "
          f"{line['calls']} calls; card {card}", flush=True)
    print(f"performance.py {BUNDLE} batch 1: average of {r['mean_ms']:.4f} ms to generate "
          f"{r['audio_ms']:.2f} ms over 10 trials, {r['x_realtime']:.3f}x realtime on {r['device_name']}; "
          f"forward launches {launches - bench_launches} for {r['calls']} calls", flush=True)
    check(bench_launches == line["calls"], f"headline: {bench_launches} forward launches, {line['calls']} calls")
    check(launches - bench_launches == r["calls"], "performance.py: not one forward launch a call")
    check(line["value"] > 1 and line["value_pull_x_realtime"] > 1 and r["x_realtime"] > 1,
          "synthesis slower than realtime")
    return launches


def phase_drift(device) -> int:
    """Phase 15, with the kernel counts set to 0 just before it: soak.py's
    phase drift over SOAK_SAMPLES and pool churn over SOAK_POOL_SAMPLES on
    the card, then the same phase drift on the CPU.  Returns the card run's
    forward launches."""
    osc.reset_kernel_counts()
    drift = soak.phase_drift_soak(SOAK_SAMPLES, device=device)
    churn = soak.pool_churn_soak(SOAK_POOL_SAMPLES, device=device)
    launches = osc.oscillator_bank.launches
    cpu = soak.phase_drift_soak(SOAK_SAMPLES, device="cpu")
    n_calls = drift["total_samples"] // (soak.FRAMES_PER_CALL * 512)
    pool_calls = churn["total_samples"] // (soak.FRAMES_PER_CALL * 512)
    card_vs_cpu = max(soak.circular_err(g["phase_f32"], c["phase_f32"])
                      for g, c in zip(drift["checkpoints"], cpu["checkpoints"]))
    print(f"drift soak: {drift['total_samples']} samples ({drift['hours_at_sr']:.4f} h) on the card in "
          f"{drift['wall_s']:.2f} s: max |phase - oracle| {drift['max_abs_err_rad']:.3e} rad, final "
          f"{drift['final_abs_err_rad']:.3e}; CPU max {cpu['max_abs_err_rad']:.3e} rad in {cpu['wall_s']:.2f} s; "
          f"card vs CPU phase max {card_vs_cpu:.3e} rad; audio peak {drift['audio_peak']:.4f}, "
          f"gru carry max {drift['gru_carry_max_abs']:.4f}; pool churn {churn['total_samples']} samples, "
          f"{churn['churn_events']} churns: hero vs solo {churn['hero_vs_solo_max_abs_diff']:.3e}; "
          f"forward launches {launches} for {n_calls} + 2 x {pool_calls} calls", flush=True)
    print(json.dumps({"drift_soak_checkpoints": [[c["samples"], c["abs_err_rad"]] for c in drift["checkpoints"]]}),
          flush=True)
    check(drift["max_abs_err_rad"] <= DRIFT_MAX_RAD, f"phase drift {drift['max_abs_err_rad']}")
    check(cpu["max_abs_err_rad"] <= DRIFT_MAX_RAD and card_vs_cpu <= DRIFT_MAX_RAD, "card vs CPU phase")
    check(churn["hero_vs_solo_max_abs_diff"] < POOL_ISOLATION_ATOL, f"pool isolation {churn}")
    check(drift["gru_carry_max_abs"] <= 1.0 and 0 < drift["audio_peak"] < 100.0, "soak state")
    check(launches == n_calls + 2 * pool_calls, f"drift soak launches {launches}")
    return launches


def _host_vs_session(bundle: str, device, pitch, loud, audio=None) -> dict:
    """The in-process model host against the Python session on the card
    (same seed, so the same noise), block by block; with the noise off,
    against the CPU plain session.  Returns launches, errors and ms."""
    block = 512
    n_blocks = len(pitch) // block
    feeds = [(pitch[i * block:(i + 1) * block], loud[i * block:(i + 1) * block],
              None if audio is None else audio[i * block:(i + 1) * block]) for i in range(n_blocks)]

    def session_out(x):
        return x[0].cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    def session_step(s, p, l, a):
        return session_out(s.step_samples(p[None], l[None]) if a is None else s.step_samples(p, l, a))

    host, twin = ModelHost(bundle), make_stream_session(bundle, device=device)
    osc.reset_kernel_counts()
    got, host_ms = [], []
    for p, l, a in feeds:
        t0 = time.perf_counter()
        got.append(host.perform(p, l, a))
        host_ms.append((time.perf_counter() - t0) * 1e3)
    launches = osc.oscillator_bank.launches
    want, session_ms = [], []
    for p, l, a in feeds:
        t0 = time.perf_counter()
        want.append(session_step(twin, p, l, a))
        session_ms.append((time.perf_counter() - t0) * 1e3)
    host.close()
    got, want = np.concatenate(got), np.concatenate(want)
    # the noise off: the card's host against the CPU plain session
    plain = export.make_stream_session
    export.make_stream_session = functools.partial(plain, noise_deterministic=True)
    try:
        det = ModelHost(bundle)
    finally:
        export.make_stream_session = plain
    cpu = make_stream_session(bundle, device="cpu", noise_deterministic=True)
    det_out = np.concatenate([det.perform(p, l, a) for p, l, a in feeds])
    cpu_out = np.concatenate([session_step(cpu, p, l, a) for p, l, a in feeds])
    det.close()
    return {"launches": launches, "blocks": n_blocks, "err_session": float(np.abs(got - want).max()),
            "err_cpu": float(np.abs(det_out - cpu_out).max()), "peak": float(np.abs(got).max()),
            "peak_det": float(np.abs(det_out).max()), "finite": bool(np.isfinite(got).all()),
            "first_block_silent": bool(np.all(got[:block] == 0)),
            "host_ms": np.percentile(host_ms[1:], [50, 99]), "session_ms": np.percentile(session_ms[1:], [50, 99])}


def phase_realtime(device, card: str, tmp: str) -> int:
    """Phase 16: the native realtime path.  build_runtime() from this
    checkout's sources (g++) and stream_test; the model host through ctypes
    in this process on the violin and violin-AE bundles (kernel counts set
    to 0 just before each host stream) against the Python session on the
    card and, with the noise off, the CPU plain session, one forward launch
    a model block; ddsp_host for DDSP_HOST_SECONDS of audio; pd_mock_test
    rendering the violin bundle through ddsp~; selftest --soak at realtime
    pacing, which must count no underrun.  Returns the host's forward
    launches."""
    shutil.rmtree(runtime.BUILD_ROOT, ignore_errors=True)
    t0 = time.perf_counter()
    built = runtime.build_runtime()
    print(f"runtime build (g++, 6 outputs in 2 parallel stages) wall s={time.perf_counter() - t0:.2f} "
          f"into {os.path.relpath(built)}", flush=True)
    rc, out, secs = runtime.run_binary("stream_test", timeout=120)
    print(f"stream_test rc={rc} in {secs:.2f} s: {' | '.join(out.strip().splitlines())}", flush=True)
    check(rc == 0 and "PASS (5 tests)" in out, "stream_test failed")

    pitch, loud = glide(N_HOST_BLOCKS, 512)
    dec = _host_vs_session(BUNDLE, device, pitch[0], loud[0])
    n = N_HOST_BLOCKS * 512
    t = np.arange(n) / 48000
    f0 = 220.0 * 2.0 ** (t / t[-1])
    audio_in = sum(0.3 / h * np.sin(h * 2 * np.pi * np.cumsum(f0) / 48000) for h in range(1, 6)).astype(np.float32)
    ae = _host_vs_session(AE_BUNDLE, device, f0.astype(np.float32), np.full(n, -7.0, np.float32), audio_in)
    for name, r, rendered in (("violin", dec, dec["blocks"]), ("violin AE", ae, ae["blocks"] - 1)):
        print(f"model host in process ({name}, {r['blocks']} blocks): max|host-session on card|="
              f"{r['err_session']:.3e}, noise off max|host on card - CPU plain|={r['err_cpu']:.3e} "
              f"(peak {r['peak_det']:.4f}); forward launches {r['launches']} for {rendered} rendered blocks; "
              f"host perform ms p50={r['host_ms'][0]:.4f} p99={r['host_ms'][1]:.4f}, python session "
              f"(step and copy out) p50={r['session_ms'][0]:.4f} p99={r['session_ms'][1]:.4f}; card {card}",
              flush=True)
        check(r["finite"] and r["peak"] > 1e-3, f"{name}: host stream silent or not finite")
        check(r["err_session"] <= HOST_VS_SESSION_ATOL, f"{name}: host vs session {r['err_session']}")
        check(r["err_cpu"] <= STREAM_GPU_VS_CPU_ATOL and r["err_cpu"] <= EXPORT_STREAM_REL_OF_PEAK * r["peak_det"],
              f"{name}: host vs CPU {r['err_cpu']} (peak {r['peak_det']})")
        check(r["launches"] == rendered, f"{name}: {r['launches']} forward launches for {rendered} blocks")
    check(ae["first_block_silent"], "AE host: the first block is not the session's silent block")

    rc, out, secs = runtime.run_binary("ddsp_host", os.path.abspath(BUNDLE), str(DDSP_HOST_SECONDS), "64",
                                       os.getcwd(), timeout=300, cwd=tmp)
    print(f"ddsp_host ({DDSP_HOST_SECONDS} s of audio, 64-sample ticks, unpaced) rc={rc} in {secs:.2f} s: "
          f"{' | '.join(out.strip().splitlines())}", flush=True)
    check(rc == 0 and "rendered" in out and os.path.exists(os.path.join(tmp, "ddsp_host_out.wav")), "ddsp_host")
    rc, out, secs = runtime.run_binary("pd_mock_test", runtime.runtime_path("ddsp~.pd_linux"),
                                       os.path.abspath(BUNDLE), timeout=300)
    print(f"pd_mock_test ddsp~ {BUNDLE} rc={rc} in {secs:.2f} s: {' | '.join(out.strip().splitlines())}",
          flush=True)
    check(rc == 0 and "pd_mock_test ok (bundle" in out, "pd_mock_test")

    result = selftest.soak(REALTIME_SOAK_SECONDS, device=device)
    print(json.dumps(result), flush=True)
    check(result["underruns"] == 0, f"realtime soak counted {result['underruns']} underruns")
    return dec["launches"] + ae["launches"]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    # parity settings: full-precision f32 matmuls and convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    # build from this checkout's sources every time, so ptxas reports
    shutil.rmtree(kernels.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    report = kernels.build()
    print(f"kernel build wall s={time.perf_counter() - t0:.2f}", flush=True)
    for name, (secs, log) in report.items():
        print(f"built {name} in {secs:.2f} s", flush=True)
        check_spills(name, log)

    kernel_ms = {}
    fwd_entry = phase_kernels(device, kernel_ms)
    bwd_entry = phase_bwd_kernel(device, kernel_ms)
    probe_checks = phase_probe_kernels(device)
    phase_streaming(device)
    serving_fwd = phase_server(device)
    check(serving_fwd > 0, "oscillator_fwd not launched on the serving path")
    phase_train_step(device)
    with tempfile.TemporaryDirectory(prefix="ddsp_chip_smoke_") as tmp:
        cache = os.path.join(tmp, "cache")
        write_cache(cache, device)
        train_fwd, train_bwd = phase_training(device, cache, tmp)
        check(train_fwd > 0 and train_bwd > 0, "a kernel was not launched on the training path")
        phase_graphed_vs_eager(device, cache, card)
        graphed, run_dir = phase_violin_run(device, cache, tmp)
        check(all(n > 0 for n in graphed.values()), "a kernel was not launched on the graphed path")
        exported_fwd = phase_export_serve(device, run_dir, cache, tmp)
    probe_entries = phase_roofline(device, card, probe_checks, kernel_ms)
    pool_fwd, _ = phase_pool(device, card)
    check(pool_fwd > 0, "oscillator_fwd not launched on the pooled serving path")
    ae_fwd = phase_autoencoder(device, card)
    check(ae_fwd > 0, "oscillator_fwd not launched on the autoencoder serving path")
    with tempfile.TemporaryDirectory(prefix="ddsp_chip_smoke_ae_") as tmp:
        ae_cache, synthetic_fwd = phase_ae_corpus(device, tmp)
        ae_train, ae_run_dir = phase_ae_run(device, ae_cache, tmp)
        check(all(n > 0 for n in ae_train.values()), "a kernel was not launched on the AE training path")
        phase_ae_graphed_vs_eager(device, ae_cache, card)
        phase_ae_export_serve(device, ae_run_dir, ae_cache, tmp)
        phase_ae_preprocess(device, ae_cache, tmp)
    phase_crepe_forward(device)
    phase_trackers(device)
    with tempfile.TemporaryDirectory(prefix="ddsp_chip_smoke_transfer_") as tmp:
        phase_default_preprocess(device, tmp)
        transfer_fwd = phase_transfer(device, tmp)
    check(transfer_fwd > 0, "oscillator_fwd not launched on the timbre-transfer path")
    headline_fwd = phase_headline(device, card)
    drift_fwd = phase_drift(device)
    with tempfile.TemporaryDirectory(prefix="ddsp_chip_smoke_runtime_") as tmp:
        host_fwd = phase_realtime(device, card, tmp)
    check(headline_fwd > 0 and drift_fwd > 0 and host_fwd > 0,
          "oscillator_fwd not launched on the headline, drift-soak or model-host path")
    # launches: this slice's main path, the headline
    fwd_entry["launches"] = headline_fwd
    fwd_entry["launches_by_path"] = {"serving": serving_fwd, "training": train_fwd,
                                     "training_graphed": graphed["oscillator_fwd"],
                                     "serving_exported": exported_fwd, "serving_pool": pool_fwd,
                                     "serving_autoencoder": ae_fwd, "synthetic": synthetic_fwd,
                                     "training_autoencoder": ae_train["oscillator_fwd"],
                                     "timbre_transfer": transfer_fwd, "headline": headline_fwd,
                                     "drift_soak": drift_fwd, "runtime_host": host_fwd}
    bwd_entry["launches"] = ae_train["oscillator_bwd"]
    bwd_entry["launches_by_path"] = {"serving": 0, "training": train_bwd,
                                     "training_graphed": graphed["oscillator_bwd"],
                                     "serving_exported": 0, "serving_pool": 0, "serving_autoencoder": 0,
                                     "synthetic": 0, "training_autoencoder": ae_train["oscillator_bwd"],
                                     "timbre_transfer": 0, "headline": 0, "drift_soak": 0, "runtime_host": 0}

    print(json.dumps({"kernels": [fwd_entry, bwd_entry, *probe_entries]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
