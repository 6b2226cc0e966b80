#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving, training, pitch-tracking, timbre-transfer,
benchmark, drift-soak, native realtime, out-of-family evidence, parallel and
bf16 paths, the repository's benchmark scripts, its run-level tools and the
last modules of the JAX package (the public ops, the voice ramp, the
reference head-to-head), and check them.

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
     training shape; the GRU's kernels against their plain versions at
     the training shape (B = 16, F = 375, H = 512, inputs 30, 1024 and
     1536) and the forward at the streaming shapes (1, 1), (1, 8) and the
     pool's (1024, 1), each timed beside its operations bound, its
     sequential floor (375 frames of the barrier probe) and the loop's
     time at the same shape; the fused spectral loss's kernels
     (ops/stft_loss.py) against their plain versions at the train cells'
     shape (B = 16, T = 192 000, six scales), each pass (the cuFFT
     transforms too) timed beside its plain version and its bytes at the
     measured copy rate, and the whole loss forward and backward against
     the plain path, both float32 paths held to the plain path in float64;
     Adam's kernels (ops/adam.py) over the decoder's, the autoencoder's
     and CREPE full's leaves, equal bit for bit to the plain path after 10
     steps, each timed beside the plain path and its byte floor;
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
 17. pitch accuracy: pitch_accuracy.score_corpus on the card over
     the default 16 kHz fixture corpus (9 notes): yin and the shipped
     CREPE held to pretrained/pitch_accuracy.json (1089 frames, RPA@50c
     within 0.005, median |cents| within 0.5), the card's YIN against the
     CPU's on the scored frames;
 18. train_oof: the CLI at the reference width (48 kHz, hidden
     512, 64 harmonics, 65 bands, reverb, batch 8, steps_per_call 25) on
     the default fixture corpus for 150 steps: the loss falls, both
     kernels replayed every step, steps/s, the first and last 10 losses
     beside pretrained/oof_loss.json's; the exported bundle streamed on
     the card against the CPU (1e-4, and 1e-3 of the peak);
 19. train_sigmund at a narrow config: the emulated sigmund~
     wav ingested and trained in two segments (fresh child processes),
     validated and exported; the same steps unsegmented in this process
     (`train --profile`: its trace holds the graphed steps' CUDA kernels)
     equal bit for bit; segments.jsonl's lines;
 20. CREPE training: one micro train step card vs CPU with the
     same draws and dropout masks (loss and batch_stats within 1e-5); three
     tiny steps traced; tiny at batch 256 for 300 steps (the loss falls,
     the eval RPA rises, steps/s); the saved msgpack reloaded by
     load_crepe with the same salience;
 21. hybrid sweep: tune_hybrid_pitch's cache and a 2 x 2 sweep
     on one file, card against CPU: the same RPA;
 22. time sharding at configs/config_timesharded.yaml (the reference
     workload, mesh.time 4, 375 frames padded to 384): Trainer.fit with its
     in-process time = 4 mesh for 4 steps on violin-rendered glides (this
     slice's main path, launches counted from zero around it); the
     time-sharded loss and gradients on a time = 4 and a data 2 × time 4
     mesh against the unsharded step on the card (loss 1e-4, gradient norm
     2e-2, each leaf within 1.5e-1 of its largest), one launch of each
     kernel over 6144 rows; 4 eager against 4 graphed steps, sharded and
     unsharded (1e-6), and ms per step of each;
 23. the trajectory: time_sharded_trajectory.py at its defaults (400 Adam
     steps, sharded and not) held to pretrained/time_sharded_trajectory.
     json's bounds;
 24. data parallel across processes on the one card: two gloo ranks on
     cuda:0 through the train CLI (--multihost) at configs/config.yaml,
     each step equal to one process's on the global batch from the same
     state (loss 1e-5, gradient norm 1e-3); one NCCL rank's graphed
     MultiStep, the gradient all_reduce captured, bit for bit the steps
     without a mesh;
 25. long-form: the violin bundle renders 8 voices × 60 s through
     LongFormSynthesizer on a time = 4 mesh against the unsharded render
     (2e-3 of the peak), its seconds and realtime factor;
 26. the bf16 model dtype (model.kwargs.dtype bfloat16) at configs/
     config.yaml's full width: one train step (16 × 375 frames) on the card
     against the CPU's plain step, the CPU's float32 step the reference:
     the MLPs and the GRU by the gap criterion of tests/test_torch_bf16.py,
     the signal and loss within the bf16–f32 gap, the gradient within
     phase 5's 2e-2; one launch of each kernel; again with
     allow_bf16_reduced_precision_reduction
     left on (no scope): its difference and bf16 GEMMs of the model's shapes
     timed both ways; Trainer.fit for 40 steps (this slice's main path,
     launches counted from zero around it: the loss falls, float32 state);
     graphed against eager steps (1e-6) and ms per graphed step beside
     phase 6's float32; export_run of that run (meta.json dtype bfloat16)
     streamed 64 blocks card vs CPU (within the gap) and a VoicePool step;
     one mfcc-autoencoder train step in bf16;
 27. the repository's benchmark scripts on the port, each line with the
     card's name and power limit: bench_headline's five configs (config 1
     on the CPU in its own process; reps cut to 0.34 of the JAX script's,
     printed), bench_step_breakdown at batch 16 (ceilings, the stages, the
     bf16 verdict; 10 iterations a stage) and bench_scaling at world size 1;
 28. the run-level tools, at the reference workload (workload.py:
     configs/config.yaml's widths, batch 16 × 375 frames, R = 6000 rows of
     the oscillator a step), each launch counted in the child processes
     that make it (ops/kernels COUNTS_FILE_ENV): the trainrun
     rehearsal (hybrid prep of the 24 + 4 note fixture corpus on the card,
     200 steps in segments of 100 at steps_per_call 50, validation; every
     segment exits 0, the losses finite and falling, each segment's graph
     replays one forward and one backward launch a step, the report's keys
     TRAINRUN_r05.json's plus `card`); the ceiling sweep at 50:1 and 1:1,
     50 probe steps (both rates a child, the capture, peak memory, SM
     clock); the CLI journey of e2e_smoke.py on the card (every CLI exits
     0, its artifacts there); CREPE(dtype="bfloat16"), the shipped tiny,
     on the card against the CPU's bf16 plain path in eval mode and in
     train mode with injected dropout masks, by the gap criterion of
     tests/test_torch_bf16.py (the CPU's float32 the reference); the
     engine's unit tests under ThreadSanitizer and AddressSanitizer + UBSan
     on the card's host (clean: every test passes, no report); the phase's
     seconds;
 29. the last modules of the JAX package, with the kernel counts set to 0
     just before each path and read just after it: the public sample-rate
     ops (upsample, resample, harmonic_synth, amplitude_to_db) on the card
     against the CPU, harmonic_synth also against the float64 oracle
     (2e-4); init_stream_state feeding one StreamingSynth.step of the
     violin bundle, equal bit for bit to a step from fresh_state;
     voice_ramp.py at its defaults (a fresh 100-harmonic, hidden-512 voice,
     pool 32, V = 1 … 32, 8-frame steps, best and mean of 6) and at pool
     1024 (V = 32, 128, 512, 1024), both reports printed, one forward
     launch a pool step; bench_reference.py on the card (the reference's
     restated forward against the port's, both configs, one forward launch
     a call of the port's side); the phase's seconds;
 30. report: one JSON line {"kernels": [...]} (all four kernels, the GRU
     kernels', the fused spectral loss's and Adam's entries of phase 2; launches by
     path: serving, training, training_graphed (host launches plus graph
     replays), serving_exported, serving_pool, serving_autoencoder,
     synthetic, training_autoencoder, timbre_transfer, headline, drift_soak,
     runtime_host, pitch_accuracy, train_oof, train_sigmund (this
     process's launches: the unsegmented run and the validation),
     time_sharded_fit, time_sharded_graphed, time_sharded_trajectory,
     data_parallel_nccl_graphed, longform, training_bf16,
     training_bf16_graphed, serving_bf16, training_autoencoder_bf16,
     trainrun, ceiling and e2e_journey (phase 28's child processes),
     init_stream_state, voice_ramp and bench_reference (phase 29) and, for
     the probes, roofline; the forward's `launches` are phase 29's, this
     slice's main path, the backward's trainrun's (phase 29 trains
     nothing); the forward's times at the headline's shape, the
     backward's at R = 3000, train_oof's; phase 2 also times both at the
     sharded rows 1536 and 6144), the card's name and power limit, and last
     {"ok": true, "device": {...}}.

Imports torch, numpy, the standard library and ddsp_pytorch_tpu_torch only.
Exits nonzero when torch.cuda.is_available() is false.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import json
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import wave

import numpy as np
import torch

from ddsp_pytorch_tpu_torch import bench, bench_headline, bench_reference, bench_roofline, bench_scaling
from ddsp_pytorch_tpu_torch import bench_step_breakdown
from ddsp_pytorch_tpu_torch import ceiling_probe, e2e_smoke, trainrun
from ddsp_pytorch_tpu_torch import export, performance, pitch_accuracy, runtime, serve, soak
from ddsp_pytorch_tpu_torch import train as train_cli
from ddsp_pytorch_tpu_torch import time_sharded_trajectory, train_crepe, train_oof, train_pretrained, train_sigmund
from ddsp_pytorch_tpu_torch import ops, transfer, tune_hybrid_pitch
from ddsp_pytorch_tpu_torch import voice_ramp as voice_ramp_cli
from ddsp_pytorch_tpu_torch.bundle import read_meta
from ddsp_pytorch_tpu_torch.config import Config
from ddsp_pytorch_tpu_torch.data import DataLoader, Datamodule, Dataset, DeviceDataLoader, make_synthetic_dataset
from ddsp_pytorch_tpu_torch.data.dataset import dict_collate
from ddsp_pytorch_tpu_torch.data.fixtures import cents_error, frame_truth, make_oof_corpus
from ddsp_pytorch_tpu_torch.data.preprocess import preprocess_folder
from ddsp_pytorch_tpu_torch.export import (
    export_run,
    load_bundle,
    make_stream_session,
    make_streaming_synth,
    run_params,
)
from ddsp_pytorch_tpu_torch.kernel_bench import (
    PEAK_FP32_FLOPS,
    card_line,
    oscillator_bound,
    oscillator_bwd_bound,
    oscillator_inputs,
    sleep_cycles_per_ms,
    time_ms,
)
from ddsp_pytorch_tpu_torch.inference import render, timbre_transfer, transfer_controls
from ddsp_pytorch_tpu_torch.models import DDSPAutoencoder, DDSPDecoder, crepe, init_params, load_model
from ddsp_pytorch_tpu_torch.models.decoder import GRU, matmul_precision
from ddsp_pytorch_tpu_torch.ops import fft_convolve, gru, kernels, mean_std_loudness, multiscale_fft, roofline
from ddsp_pytorch_tpu_torch.ops import uniform_noise
from ddsp_pytorch_tpu_torch.ops import oscillator as osc
from ddsp_pytorch_tpu_torch.ops.pitch import extract_pitch, switch_cost, yin_emission
from ddsp_pytorch_tpu_torch.profile_serving import (
    PROFILER_ACTIVITIES,
    RAMP_VOICES,
    glide,
    voice_ramp,
    voices_per_card_text,
)
from ddsp_pytorch_tpu_torch.parallel import LongFormSynthesizer, make_mesh
from ddsp_pytorch_tpu_torch.profile_training import glide_controls
from ddsp_pytorch_tpu_torch.runtime import ModelHost, selftest
from ddsp_pytorch_tpu_torch.streaming import StreamingSynth, init_stream_state
from ddsp_pytorch_tpu_torch.streaming.pool import VoicePool
from ddsp_pytorch_tpu_torch.training import Trainer, make_optimizer, profiling
from ddsp_pytorch_tpu_torch.training.profiling import device_kernels
from ddsp_pytorch_tpu_torch.training.loss import multiscale_spec_loss
from ddsp_pytorch_tpu_torch.training.metrics import read_metrics
from ddsp_pytorch_tpu_torch.training.optim import Optimizer, global_norm, tree_leaves
from ddsp_pytorch_tpu_torch.training.state import TrainState
from ddsp_pytorch_tpu_torch.training.time_sharded import plan_time_padding
from ddsp_pytorch_tpu_torch.training.train import (
    WARMUP_RUNS,
    loss_and_grads,
    make_loss_and_grads,
    make_train_multi_step,
    make_train_multi_step_indexed,
    make_train_step,
    metrics_row,
    to_device,
)
from ddsp_pytorch_tpu_torch.utils import resample_poly, save_wav
from ddsp_pytorch_tpu_torch.utils.audio_io import load_wav, read_wav

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
# Phases 22-25 (the parallel layer): one launch holds shards × batch ×
# frames a shard rows, 4 × 16 × 96 = 6144 at configs/config_timesharded.yaml
# with the shards stacked in one process, 16 × 96 = 1536 a rank with one
# shard a rank.
SHARDED_SHAPES = ((1536, 64, 512), (6144, 64, 512))
KERNEL_SHAPES = ((1, 64, 512), (6000, 64, 512), GRAPHED_SHAPE, (37, 100, 512), (6000, 100, 512),
                 (5, 1, 64), (2, 64, 512), (256, 64, 512), (1024, 64, 512), (2048, 64, 512), TRANSFER_SHAPE,
                 HEADLINE_SHAPE, (2, 100, 512), (16, 8, 512), (64, 8, 512), *SHARDED_SHAPES)
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
# phase 17: the default 16 kHz validation corpus (9 notes of 2 s, seed 0)
# scored on the card against pretrained/pitch_accuracy.json (yin RPA 1.0,
# median 1.19 cents; crepe 0.998 and 4.10 cents; 1089 frames), and the
# card's YIN against the CPU's on the scored (voiced) frames: within 1 cent
# on all but 1 % of them and within 3 cents on every one.  Two float32 FFT
# libraries move YIN's parabolic refinement on a flat CMNDF valley: on the
# CPU, the correlation taken in float64 instead of float32 moves 2 of these
# 1089 frames beyond 1 cent, the largest by 1.41 cents (and unvoiced frames
# by up to 49.6 cents, a neighbouring bin)
ACCURACY_JSON = "pretrained/pitch_accuracy.json"
ACCURACY_FILES = 9
ACCURACY_FRAMES = 1089
ACCURACY_RPA_ATOL = 0.005
ACCURACY_MEDIAN_ATOL = 0.5
ACCURACY_YIN_CENTS = 1.0
ACCURACY_YIN_SHARE_BEYOND = 0.01
ACCURACY_YIN_MAX_CENTS = 3.0
# phase 18: train_oof at the reference width, 18 training notes at batch 8
# (2 steps an epoch): 150 steps, 6 graphed calls of 25, validation and the
# log eval at epochs 0, 25 and 50
OOF_LOSS_JSON = "pretrained/oof_loss.json"  # the JAX run's trajectory
N_OOF_STEPS = 150
OOF_INTERVAL_EPOCHS = 25
# phase 19: train_sigmund at a narrow config (16 kHz, 1 s chunks, hidden
# 64, 16 harmonics), two segments of 4 steps at steps_per_call 2
SIGMUND_SEGMENT = 4
SIGMUND_SETS = ("preprocess.sample_rate=16000", "preprocess.signal_length=16384", "preprocess.block_size=256",
                "model.kwargs.sample_rate=16000", "model.kwargs.block_size=256", "model.kwargs.hidden_size=64",
                "model.kwargs.n_harmonic=16", "model.kwargs.n_bands=17", "train.scales=[1024, 512, 256]")
# phase 20: one CREPE train step card vs CPU (loss and batch statistics),
# then tiny capacity at batch 256
CREPE_STEP_ATOL = 1e-5
N_CREPE_STEPS = 300


TIMESHARDED_CONFIG = "configs/config_timesharded.yaml"
# phase 22: the time-sharded step against the unsharded step on the card at
# the bounds of tests/test_time_sharded_training.py:324-361 (the reference
# shape): the loss within 1e-4 relative, the gradient's norm within 2e-2,
# each leaf elementwise within 1.5e-1 of its largest magnitude plus 1e-3
# relative — but FLAGGED_LEAVES, which carry the float32 loss's
# conditioning at fresh weights (phase 5: a 1e-7 relative change of the
# noise moves noise_proj's gradient by 17-29 %), are held instead, as every
# leaf also is, to phase 5's bounds for two float32 steps rounded
# differently: |Δ| within STEP_LEAF_OF_WHOLE of the whole gradient's norm,
# the whole gradient within STEP_GRAD_REL.  The unsharded step with its
# noise scaled by 1 + 1e-7 is printed beside it: the same leaves move as far.
TS_LOSS_REL, TS_GRAD_NORM_REL, TS_LEAF_OF_MAX = 1e-4, 2e-2, 1.5e-1
TS_FIT_STEPS = 4  # Trainer.fit at the committed config (the main path)
TS_GRAPH_STEPS = 4  # eager against graphed steps, and the timed calls' steps
# phase 24: two gloo ranks on the one card through the train CLI, at
# configs/config.yaml (global batch 16, 8 a rank); each step held to one
# process's step on the global batch from the run's own state (its
# checkpoint): loss 1e-5 relative, gradient norm 1e-3 (tests/
# test_parallel.py:187-241)
DP_STEPS = 3
DP_LOSS_REL, DP_GRAD_NORM_REL = 1e-5, 1e-3
DP_TIMEOUT_S = 600
# phase 25: 8 voices × 5632 frames (60.07 s at 48 kHz; 5632 = 4 × 1408) on a
# time = 4 mesh against the unsharded render, within 2e-3 of its peak
# (tests/test_longform.py:92)
LONGFORM_VOICES, LONGFORM_FRAMES = 8, 5632
LONGFORM_REL_OF_PEAK = 2e-3
# phase 26: the bf16 model dtype (model.kwargs.dtype bfloat16) at
# configs/config.yaml's full width.  The card against the CPU by the gap
# criterion of tests/test_torch_bf16.py: with gap = |cpu_bf16 − cpu_f32| and
# err = |card_bf16 − cpu_bf16| elementwise, mean err ≤ BF16_GAP_MEAN × mean
# gap, max err ≤ BF16_GAP_MAX × max gap, and mean |card_bf16 − cpu_f32|
# within BF16_GAP_BAND × mean gap (the card carries bf16's error, not
# float32's answer); the whole gradient's relative L2 error against the CPU's
# bf16 one ≤ BF16_GAP_MEAN × that between the CPU's bf16 and f32 ones.
BF16_GAP_MEAN, BF16_GAP_MAX, BF16_GAP_BAND = 0.25, 2.0, (0.5, 1.5)
# The card's bf16 GEMMs (tensor cores) round ~0.05 % of their outputs to
# another bf16 than the CPU's float32-accumulated ones (elementwise ops agree
# bit for bit; measured, NVIDIA H100 80GB HBM3, 700.00 W), and every dense
# layer after the GRU mixes those flips into most of its outputs: card
# against CPU, the GRU's outputs are 0.07 of the gap apart, the decoder's
# hidden state 0.28, the controls 0.48, the signal 0.70.  So the gap
# criterion's mean bound holds stage by stage up to the GRU (the MLPs, the
# GRU's input projection and its outputs), and the whole model's signal,
# loss and streams are held to the card's bf16 being no farther from the
# CPU's than bf16 is from float32 (BF16_CARD_MEAN), with the max and band
# bounds as in the tests; the gradient to phase 5's float32 card-vs-CPU
# bound (STEP_GRAD_REL: float32 gradients at fresh weights differ across
# devices by ~1e-2 already).
BF16_CARD_MEAN = 1.0
BF16_STAGES_HELD = ("f0_mlp", "loudness_mlp", "gru")
N_BF16_STEPS = 40  # Trainer.fit in bf16, as phase 5b's in float32
# phase 27: the repository's benchmark scripts on the port.  bench_headline's
# reps are cut to this share of the JAX script's (at least 1 a mean); the
# step breakdown runs at batch 16 with this many chained iterations a stage
# (the JAX script's 20 cut); bench_scaling at world size 1 (one card).
BENCH_REPS_SCALE = 0.34
BREAKDOWN_BATCH, BREAKDOWN_ITERS = 16, 10
# phase 28: the run-level tools at the reference workload.  The trainrun
# rehearsal: 200 steps in segments of 100 at steps_per_call 50; the ceiling
# sweep at 50:1 and 1:1 with 100 probe steps; CREPE bf16 (the shipped tiny)
# on CREPE_BF16_FRAMES frames in eval mode and CREPE_BF16_BATCH in train
# mode, by the gap criterion above (BF16_GAP_*).
TRAINRUN_STEPS, TRAINRUN_SCHEDULE, TRAINRUN_SPC = 200, "100,100", 50
CEILING_CONFIGS, CEILING_PROBE_STEPS = "50:1,1:1", 50
# phase 29: the public sample-rate ops on the card against the CPU (the
# JAX suite's tolerances: tests/test_ops_core.py:97 for resample; 2e-4, the
# float64 oracle's bound at tests/test_oscillator.py:47-53, for
# harmonic_synth, whose float32 cumsum runs in another order on the card)
OPS_RESAMPLE_RTOL, OPS_RESAMPLE_ATOL, OPS_ORACLE_ATOL, OPS_DB_ATOL = 1e-4, 1e-5, 2e-4, 1e-5
# the voice ramp at its defaults, then one wider pool
WIDE_RAMP = ["--pool", "1024", "--ramp", "32,128,512,1024"]
CREPE_BF16_FRAMES, CREPE_BF16_BATCH = 256, 256
# phase 2, the GRU's kernels: the training shape of each GRU input (the
# encoder's 30, the decoder's 1024 and 1536) and the streaming shapes
# (B, F, input); the kernel against the plain version: GRU_KERNEL_ATOL on
# h, the gates and hp_n (the two sum each frame's product in other orders,
# and the recurrence carries the difference on through 375 frames),
# GRU_BWD_REL of each cotangent's largest magnitude
GRU_HIDDEN, GRU_PROBE_FRAMES = 512, 375
GRU_SHAPES = ((16, 375, 30), (16, 375, 1024), (16, 375, 1536), (1, 1, 1024), (1, 8, 1024), (1024, 1, 1024))
GRU_KERNEL_ATOL, GRU_BWD_REL = 2e-5, 1e-4
# phase 2, the fused spectral loss (ops/stft_loss.py) at the train cells'
# shape: each kernel against its plain version (STFT_KERNEL_REL of the
# plain version's largest magnitude: hypotf, logf and FMA contraction
# against torch's elementwise kernels; the framing bit for bit), its bytes
# over the card's measured copy rate (saxpy, PERF.md §6), and the whole
# loss forward and backward against the plain path in float64: the loss
# within STFT_LOSS_REL, the gradient's 90th percentile of error no more
# than STFT_GRAD_OVER_PLAIN times the float32 plain path's
STFT_BATCH, STFT_SAMPLES, STFT_SCALES, STFT_OVERLAP = 16, 192_000, (4096, 2048, 1024, 512, 256, 128), 0.75
STFT_KERNEL_REL, STFT_LOSS_REL, MEASURED_COPY_BYTES_PER_S = 1e-5, 1e-5, 2.983e12
STFT_GRAD_OVER_PLAIN = 1.5
# RAVE v1's distances at rave.train_b8's shape: 8 crops × 16 band rows of
# 4 096 samples, and the 8 full-band rows of 65 536; its five scales
RAVE_STFT_SHAPES, RAVE_STFT_SCALES = ((8 * 16, 4096), (8, 65_536)), (2048, 1024, 512, 256, 128)
# phase 2, Adam (ops/adam.py) over each train cell's leaves: the kernel
# against the plain path (`update` and the guard's copies) bit for bit
# after ADAM_STEPS steps, its time beside the byte floor at the measured
# copy rate: 32 bytes a parameter with the norm (the DDSP steps), 28
# without (CREPE's)
ADAM_STEPS = 10
ADAM_LEAF_SETS = (("decoder", CONFIG, True), ("autoencoder", AE_CONFIG, True), ("crepe-full", None, False))


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
    (the main path's, template argument 64), the GRU's kernels and the
    probes must not spill.
    For the probes, also each function's FFMA count in its SASS: the fma
    probe's chain must not be folded."""
    report = ptxas_report(log)
    probes = name == "roofline_fma"
    if name.startswith(("stft", "adam")):
        checked = list(report)
    elif probes or name.startswith("gru"):
        checked = list(report)
        ffma = {fn: len(re.findall(r"\bFFMA\b", text)) for fn, text in kernels.sass(name).items()}
    else:
        checked = [f for f in report if f"ILi{osc.KERNEL_FIXED_K}E" in f]
    if not probes:
        ffma = {}
    check(bool(checked), f"no checked variant of {name} in the ptxas report")
    for fn, (stores, loads, regs) in sorted(report.items()):
        m = re.search(r"\d((?:oscillator|roofline|gru|stft|adam)_\w+?_kernel(?:I\w*?E)?)", fn)
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


def train_launches(grus: int, steps: int = 1, scales: int = 6, adam: bool = True) -> dict:
    """{kernel: launches} of `steps` float32 train steps on the card: one of
    each oscillator kernel a step, one of each GRU kernel for each of
    the model's `grus` GRUs (1 for the decoder, 2 for the autoencoder; 0
    where the bf16 compute dtype runs the GRU's loop), the fused
    loss's framing, loss-and-gradient and overlap-add kernels for each of
    its `scales` STFT scales and its sum once (0 scales: the time-sharded
    step's own loss), and Adam's norm and update once (not `adam`: the
    loss and gradients alone)."""
    return {"oscillator_fwd": steps, "oscillator_bwd": steps,
            "gru_fwd": grus * steps, "gru_bwd": grus * steps,
            "stft_frame": scales * steps, "stft_loss_grad": scales * steps, "stft_rave_norms": 0,
            "stft_rave_loss_grad": 0, "stft_loss_sum": steps if scales else 0, "stft_overlap_add": scales * steps,
            "adam_norm": steps if adam else 0, "adam_update": steps if adam else 0}


def rave_train_launches(steps: int, adam_launches: int) -> dict:
    """{kernel: launches} of `steps` RAVE v1 phase-1 steps on the card: for
    each of its two distances (bands, full band) and each of its scales the
    framing, norms, RAVE loss-and-gradient and overlap-add kernels, and the
    sum once; Adam's norm and update `adam_launches` times each (its 119
    leaves take more than one launch of ops/adam.py's table); nothing of
    DDSP's."""
    scales = 2 * len(RAVE_STFT_SCALES)
    return {**{name: 0 for name in train_launches(0)},
            "stft_frame": scales * steps, "stft_rave_norms": scales * steps, "stft_rave_loss_grad": scales * steps,
            "stft_loss_sum": 2 * steps, "stft_overlap_add": scales * steps, "adam_norm": adam_launches * steps,
            "adam_update": adam_launches * steps}


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
    before = (_launched("oscillator_fwd"), _launched("oscillator_bwd"))
    osc.OscillatorBank.apply(*ins, s).backward(g)
    check((_launched("oscillator_fwd"), _launched("oscillator_bwd"))
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


def _gru_inputs(device, b: int, f: int, in_size: int, seed: int):
    """A GRU of H = 512 with init_params's weights, and x_proj (B, F, 3H) and
    h0 (B, H) for its recurrence."""
    gen = torch.Generator().manual_seed(seed)
    model = init_params(GRU(in_size, GRU_HIDDEN), gen).to(device)
    x = torch.randn((b, f, in_size), generator=gen).to(device)
    h0 = (0.5 * torch.randn((b, GRU_HIDDEN), generator=gen)).to(device)
    with torch.no_grad():
        x_proj = x @ model.weight_ih.T + model.bias_ih
    return x_proj, model.weight_hh.detach(), model.bias_hh.detach(), h0


def phase_gru_kernels(device) -> list:
    """Phase 2, the GRU: both kernels against their plain versions at the
    training shape (B = 16, F = 375, H = 512), and the forward at the
    streaming shapes (1, 1), (1, 8) and the pool's (1024, 1); each kernel's
    time (CUDA events) beside its operations bound (2·B·F·3H·H over the
    float32 peak), its sequential floor (F times one frame of the
    barrier probe: a cluster's exchange and barrier alone) and the loop's
    time at the same shape.  Returns the entries for the report."""
    cycles_per_ms = sleep_cycles_per_ms()
    sink = torch.empty((8, GRU_HIDDEN), device=device)

    @functools.lru_cache(maxsize=None)
    def frame_ms(rows: int) -> float:
        ms, _ = time_ms(lambda: kernels.launch("gru_barrier_probe", sink, GRU_PROBE_FRAMES, GRU_HIDDEN, rows),
                        20, cycles_per_ms)
        print(f"gru_barrier_probe rows={rows}: {1e3 * ms / GRU_PROBE_FRAMES:.4f} us a frame "
              f"(exchange of h to 16 blocks and one barrier.cluster)", flush=True)
        return ms / GRU_PROBE_FRAMES

    entries = []
    for b, f, in_size in GRU_SHAPES:
        x_proj, w_hh, b_hh, h0 = _gru_inputs(device, b, f, in_size, SEED + b + f)
        train = f > 1 and b > 1
        with torch.no_grad():
            out, h, saved = gru.gru_fwd(x_proj, w_hh, b_hh, h0, save=train)
            rows, clusters = gru.plans["gru_fwd"]
            want = gru.gru_fwd_plain(x_proj, w_hh, b_hh, h0)
            torch.cuda.synchronize()
            err = max(float((out - want[0]).abs().max()), float((h - want[1]).abs().max()))
            if train:
                err = max(err, float((saved - want[2]).abs().max()))
            check(err <= GRU_KERNEL_ATOL, f"gru_fwd vs plain {err} at B={b} F={f} in={in_size}")
            ms, _ = time_ms(lambda: gru.gru_fwd(x_proj, w_hh, b_hh, h0, save=train), 20, cycles_per_ms)
            loop_ms, _ = time_ms(lambda: gru.gru_fwd_plain(x_proj, w_hh, b_hh, h0), 2, cycles_per_ms, warmup=1)
        flops = 2 * b * f * 3 * GRU_HIDDEN * GRU_HIDDEN
        bound_ms = 1e3 * flops / PEAK_FP32_FLOPS
        floor_ms = f * frame_ms(rows)
        print(f"gru_fwd B={b} F={f} in={in_size} (rows a cluster {rows}, clusters {clusters}, "
              f"saved {train}): max|kernel-plain|={err:.3e} kernel_ms={ms:.6f} loop_ms={loop_ms:.6f} "
              f"ops_bound_ms={bound_ms:.6f} sequential_floor_ms={floor_ms:.6f} "
              f"share_of_floor={floor_ms / ms:.3f} speedup_over_loop={loop_ms / ms:.2f}", flush=True)
        entries.append({"name": "gru_fwd", "shape_b_f_in": [b, f, in_size], "max_abs_err": err,
                        "ms": ms, "loop_ms": loop_ms, "bound_ms": bound_ms, "floor_ms": floor_ms,
                        "rows": rows, "clusters": clusters})
        if not train:
            continue
        dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(SEED + 7)).to(device)
        with torch.no_grad():
            got = gru.gru_bwd(dout, None, saved, w_hh)
            want_b = gru.gru_bwd_plain(dout, None, saved, w_hh)
            torch.cuda.synchronize()
            errs = {n: rel_err(a, w) for n, a, w in zip(("dxp", "dhp", "dh0"), got, want_b)}
            check(max(errs.values()) <= GRU_BWD_REL, f"gru_bwd vs plain {errs} at B={b} F={f}")
            ms, _ = time_ms(lambda: gru.gru_bwd(dout, None, saved, w_hh), 20, cycles_per_ms)
        # the loop's backward: autograd through the loop's forward, timed alone
        xl = x_proj.clone().requires_grad_(True)
        wl = w_hh.clone().requires_grad_(True)
        outl, _, _ = gru.gru_fwd_plain(xl, wl, b_hh, h0)
        loop_ms, _ = time_ms(lambda: torch.autograd.grad(outl, (xl, wl), dout, retain_graph=True), 2,
                             cycles_per_ms, warmup=1)
        del xl, wl, outl
        print(f"gru_bwd B={b} F={f} in={in_size} (rows a cluster {gru.plans["gru_bwd"][0]}, clusters "
              f"{gru.plans["gru_bwd"][1]}): rel err vs plain "
              + " ".join(f"{n}={e:.3e}" for n, e in errs.items())
              + f" kernel_ms={ms:.6f} loop_ms={loop_ms:.6f} (autograd through the loop, dW_hh "
              f"included) ops_bound_ms={bound_ms:.6f} sequential_floor_ms={floor_ms:.6f} "
              f"share_of_floor={floor_ms / ms:.3f} speedup_over_loop={loop_ms / ms:.2f}", flush=True)
        entries.append({"name": "gru_bwd", "shape_b_f_in": [b, f, in_size],
                        "max_rel_err": max(errs.values()), "ms": ms, "loop_ms": loop_ms,
                        "bound_ms": bound_ms, "floor_ms": floor_ms, "rows": gru.plans["gru_bwd"][0],
                        "clusters": gru.plans["gru_bwd"][1]})
    torch.cuda.empty_cache()
    return entries


def phase_stft_loss_kernels(device) -> list:
    """Phase 2, the fused spectral loss (ops/stft_loss.py) at the train
    cells' shape (B = 16, T = 192 000, six scales, overlap 0.75): each
    kernel against its plain version; each pass's time (CUDA events, the
    cuFFT transforms beside the kernels) and the bytes it moves over the
    measured copy rate, summed over the scales; the plain version's time
    beside each kernel's; then the whole loss forward and backward, fused
    against the plain path (STFTs, means and autograd's backward), loss and
    gradient compared; then RAVE's two kernels (`stft_rave_kernels`).
    Returns the entries for the report."""
    from ddsp_pytorch_tpu_torch.ops import stft_loss as sl
    from ddsp_pytorch_tpu_torch.training.loss import spectral_loss_from_signals

    cycles_per_ms = sleep_cycles_per_ms()
    g = torch.Generator().manual_seed(SEED)
    x = (0.3 * torch.randn((STFT_BATCH, STFT_SAMPLES), generator=g)).to(device)
    y = (0.3 * torch.randn((STFT_BATCH, STFT_SAMPLES), generator=g)).to(device)
    go = torch.ones((), device=device)
    b, t, f4 = STFT_BATCH, STFT_SAMPLES, 4
    totals = {}  # pass → [kernel ms, plain ms or None, bytes]

    def add(name, ms, plain_ms, nbytes):
        row = totals.setdefault(name, [0.0, None if plain_ms is None else 0.0, 0])
        row[0] += ms
        if plain_ms is not None:
            row[1] += plain_ms
        row[2] += nbytes

    out = plain_out = None
    with torch.no_grad():
        for n in STFT_SCALES:
            hop = sl.hop_length(n, STFT_OVERLAP)
            frames_n, bins = sl.n_frames(t, n, hop), n // 2 + 1
            c = sl.window_constant(n, torch.float32, device)
            frames = sl.stft_frame(x, y, c, hop)
            check(torch.equal(frames, sl.stft_frame_plain(x, y, c, hop)), f"stft_frame vs plain at n={n}")
            ms, _ = time_ms(lambda: sl.stft_frame(x, y, c, hop), 20, cycles_per_ms)
            pms, _ = time_ms(lambda: sl.stft_frame_plain(x, y, c, hop), 5, cycles_per_ms)
            add("stft_frame", ms, pms, 2 * b * t * f4 + 2 * b * frames_n * n * f4)
            spec = torch.fft.rfft(frames, dim=-1)
            ms, _ = time_ms(lambda: torch.fft.rfft(frames, dim=-1), 20, cycles_per_ms)
            add("rfft (cuFFT)", ms, None, 2 * b * frames_n * n * f4 + 2 * b * frames_n * bins * 8)
            partials = torch.empty(sl.loss_blocks(b * frames_n * bins), dtype=torch.float64, device=device)
            plain_partials = torch.empty_like(partials)
            grad = sl.stft_loss_grad(spec, n, partials)
            want = sl.stft_loss_grad_plain(spec, n, plain_partials)
            err = rel_err(torch.view_as_real(grad), torch.view_as_real(want))
            check(err <= STFT_KERNEL_REL, f"stft_loss_grad vs plain {err} at n={n}")
            check(abs(float(partials.sum()) - float(plain_partials.sum())) <= STFT_KERNEL_REL * float(
                plain_partials.sum()), f"stft_loss_grad partials vs plain at n={n}")
            ms, _ = time_ms(lambda: sl.stft_loss_grad(spec, n, partials), 20, cycles_per_ms)
            pms, _ = time_ms(lambda: sl.stft_loss_grad_plain(spec, n, plain_partials), 5, cycles_per_ms)
            add("stft_loss_grad", ms, pms, 2 * b * frames_n * bins * 8 + b * frames_n * bins * 8)
            gframes = torch.fft.irfft(grad, n=n, dim=-1, norm="forward")
            ms, _ = time_ms(lambda: torch.fft.irfft(grad, n=n, dim=-1, norm="forward"), 20, cycles_per_ms)
            add("irfft (cuFFT, input cloned)", ms, None, b * frames_n * bins * 8 + b * frames_n * n * f4)
            acc = out is not None
            out = sl.stft_overlap_add(gframes, c, go, t, hop, out)
            plain_out = sl.stft_overlap_add_plain(gframes, c, go, t, hop, plain_out)
            err = rel_err(out, plain_out)
            check(err <= STFT_KERNEL_REL, f"stft_overlap_add vs plain {err} at n={n}")
            scratch = torch.zeros_like(out)
            ms, _ = time_ms(lambda: sl.stft_overlap_add(gframes, c, go, t, hop, scratch if acc else None), 20,
                            cycles_per_ms)
            pms, _ = time_ms(lambda: sl.stft_overlap_add_plain(gframes, c, go, t, hop, scratch if acc else None),
                             3, cycles_per_ms)
            add("stft_overlap_add", ms, pms, b * frames_n * n * f4 + b * t * f4 * (2 if acc else 1))
            print(f"stft n={n} hop={hop} frames={frames_n}: kernels match their plain versions", flush=True)
            del frames, spec, grad, want, gframes
        ms, _ = time_ms(lambda: sl.stft_loss_sum(partials, torch.float32), 20, cycles_per_ms)
        add("stft_loss_sum", ms, None, partials.numel() * 8)

    def fused():
        yy = y.clone().requires_grad_(True)
        loss = sl.multiscale_spectral_loss(x, yy, STFT_SCALES, STFT_OVERLAP)
        return loss, torch.autograd.grad(loss, yy)[0]

    def plain(dtype=torch.float32):
        yy = y.to(dtype, copy=True).requires_grad_(True)
        loss = spectral_loss_from_signals(x.to(dtype), yy, STFT_SCALES, STFT_OVERLAP)[0]
        return loss, torch.autograd.grad(loss, yy)[0]

    # both float32 paths against the plain path in float64 on the card: the
    # gradient's 1/|S_y| weights make the float32 rounding of a few small
    # bins dominate any norm of its error, so the fused path is held to the
    # plain path's 90th percentile of |g − g64| (tests/test_torch_stft_loss.py)
    (loss, grad), (plain_loss, plain_grad), (want_loss, want_grad) = fused(), plain(), plain(torch.float64)
    loss_rel, plain_loss_rel = (abs(float(v.detach()) - float(want_loss)) / float(want_loss)
                                for v in (loss, plain_loss))
    grad_rel, plain_grad_rel = (float((g.double() - want_grad).norm() / want_grad.norm())
                                for g in (grad, plain_grad))
    rms = want_grad.pow(2).mean().sqrt()
    q90 = torch.tensor(0.9, dtype=torch.float64, device=device)
    grad_q90, plain_grad_q90 = (float(torch.quantile(((g.double() - want_grad).abs() / rms).flatten(), q90))
                                for g in (grad, plain_grad))
    del want_grad
    check(loss_rel <= STFT_LOSS_REL, f"fused loss vs float64 rel {loss_rel}")
    check(grad_q90 <= STFT_GRAD_OVER_PLAIN * plain_grad_q90,
          f"fused gradient vs float64: 90th percentile {grad_q90}, the plain path's {plain_grad_q90}")
    fused_ms, fused_host = time_ms(fused, 10, cycles_per_ms)
    plain_ms, plain_host = time_ms(plain, 5, cycles_per_ms)
    bound_bytes = sum(row[2] for row in totals.values())
    bound_ms = 1e3 * bound_bytes / MEASURED_COPY_BYTES_PER_S
    entries = []
    for name, (ms, pms, nbytes) in totals.items():
        at_copy = 1e3 * nbytes / MEASURED_COPY_BYTES_PER_S
        plain_text = f" plain_ms={pms:.6f}" if pms is not None else ""
        print(f"{name} B={b} T={t} {len(STFT_SCALES)} scales: ms={ms:.6f}{plain_text} bytes={nbytes} "
              f"ms_at_copy_rate={at_copy:.6f} share={at_copy / ms:.3f}", flush=True)
        entries.append({"name": name, "shape_b_t": [b, t], "scales": list(STFT_SCALES), "ms": ms,
                        "plain_ms": pms, "bytes": nbytes, "ms_at_copy_rate": at_copy})
    print(f"spectral loss fwd+bwd B={b} T={t} {len(STFT_SCALES)} scales: fused_ms={fused_ms:.6f} "
          f"plain_ms={plain_ms:.6f} (host {fused_host:.3f} / {plain_host:.3f}) speedup={plain_ms / fused_ms:.2f} "
          f"byte bound {bound_bytes / 1e9:.3f} GB = {bound_ms:.4f} ms at {MEASURED_COPY_BYTES_PER_S / 1e9:.0f} GB/s "
          f"(share {bound_ms / fused_ms:.3f}); against float64: loss rel {loss_rel:.3e} (plain "
          f"{plain_loss_rel:.3e}), gradient rel L2 {grad_rel:.3e} (plain {plain_grad_rel:.3e}), 90th "
          f"percentile of the error over the RMS {grad_q90:.3e} (plain {plain_grad_q90:.3e})",
          flush=True)
    entries.append({"name": "spectral_loss_fwd_bwd", "shape_b_t": [b, t], "scales": list(STFT_SCALES),
                    "ms": fused_ms, "plain_ms": plain_ms, "bytes": bound_bytes, "ms_at_copy_rate": bound_ms,
                    "loss_rel": loss_rel, "grad_rel_l2": grad_rel, "plain_loss_rel": plain_loss_rel,
                    "plain_grad_rel_l2": plain_grad_rel, "grad_err_q90": grad_q90,
                    "plain_grad_err_q90": plain_grad_q90})
    del x, y, loss, grad, plain_grad, out, plain_out, scratch, partials, plain_partials
    torch.cuda.empty_cache()
    return entries + stft_rave_kernels(device, cycles_per_ms)


def stft_rave_kernels(device, cycles_per_ms: float) -> list:
    """RAVE's kernels of the fused loss (ops/stft_loss.py
    `stft_rave_norms`, `stft_rave_loss_grad`) at rave.train_b8's shapes
    (RAVE_STFT_SHAPES, its five scales, hop n/4): each against its plain
    version on the same spectra, as tests/test_torch_rave.py holds them
    (the norms' float64 block sums to 1e-9, the gradient to 1e-5 of its
    largest element, the partials' sum to 1e-9); each one's time (CUDA
    events) beside the bytes it moves over the measured copy rate, summed
    over the scales and both shapes.  Then the main path: a MultiStep call
    of two graphed phase-1 steps of RAVE v1 at its published size, whose
    captured launches must be `rave_train_launches`.  Returns the entries
    for the report."""
    from ddsp_pytorch_tpu_torch.config import Config
    from ddsp_pytorch_tpu_torch.models import load_model
    from ddsp_pytorch_tpu_torch.ops import adam
    from ddsp_pytorch_tpu_torch.ops import stft_loss as sl
    from ddsp_pytorch_tpu_torch.training.optim import make_optimizer
    from ddsp_pytorch_tpu_torch.training.state import TrainState
    from ddsp_pytorch_tpu_torch.training.train import make_train_multi_step

    g = torch.Generator().manual_seed(SEED)
    totals = {"stft_rave_norms": [0.0, 0.0, 0], "stft_rave_loss_grad": [0.0, 0.0, 0]}  # ms, plain ms, bytes

    def add(name, ms, pms, nbytes):
        totals[name][0] += ms
        totals[name][1] += pms
        totals[name][2] += nbytes

    with torch.no_grad():
        for rows, t in RAVE_STFT_SHAPES:
            x = (0.3 * torch.randn((rows, t), generator=g)).to(device)
            y = x + (0.1 * torch.randn((rows, t), generator=g)).to(device)
            for n in RAVE_STFT_SCALES:
                hop = sl.hop_length(n, STFT_OVERLAP)
                spec = torch.fft.rfft(sl.stft_frame(x, y, sl.window_constant(n, torch.float32, device), hop), dim=-1)
                count = spec.numel() // 2
                norms = sl.stft_rave_norms(spec, n)
                want_norms = sl.stft_rave_norms_plain(spec, torch.empty_like(norms))
                check(torch.allclose(norms, want_norms, rtol=1e-9, atol=0),
                      f"stft_rave_norms vs plain {rel_err(norms, want_norms)} at rows={rows} T={t} n={n}")
                partials = torch.empty(norms.shape[1], dtype=torch.float64, device=device)
                plain_partials = torch.empty_like(partials)
                grad = sl.stft_rave_loss_grad(spec, n, partials, norms)
                want = sl.stft_rave_loss_grad_plain(spec, n, plain_partials, norms)
                err = rel_err(torch.view_as_real(grad), torch.view_as_real(want))
                check(err <= STFT_KERNEL_REL, f"stft_rave_loss_grad vs plain {err} at rows={rows} T={t} n={n}")
                check(abs(float(partials.sum() - plain_partials.sum())) <= 1e-9 * float(plain_partials.sum()),
                      f"stft_rave_loss_grad partials vs plain at rows={rows} T={t} n={n}")
                ms, _ = time_ms(lambda: sl.stft_rave_norms(spec, n), 20, cycles_per_ms)
                pms, _ = time_ms(lambda: sl.stft_rave_norms_plain(spec, want_norms), 5, cycles_per_ms)
                add("stft_rave_norms", ms, pms, 2 * count * 8 + norms.numel() * 8)
                ms, _ = time_ms(lambda: sl.stft_rave_loss_grad(spec, n, partials, norms), 20, cycles_per_ms)
                pms, _ = time_ms(lambda: sl.stft_rave_loss_grad_plain(spec, n, plain_partials, norms), 5,
                                 cycles_per_ms)
                add("stft_rave_loss_grad", ms, pms, 3 * count * 8 + (partials.numel() + norms.numel()) * 8)
                del spec, norms, want_norms, grad, want
            print(f"stft rave rows={rows} T={t}: kernels match their plain versions at {len(RAVE_STFT_SCALES)} "
                  "scales", flush=True)
    entries = []
    for name, (ms, pms, nbytes) in totals.items():
        at_copy = 1e3 * nbytes / MEASURED_COPY_BYTES_PER_S
        print(f"{name} shapes={list(RAVE_STFT_SHAPES)} {len(RAVE_STFT_SCALES)} scales: ms={ms:.6f} "
              f"plain_ms={pms:.6f} bytes={nbytes} ms_at_copy_rate={at_copy:.6f} share={at_copy / ms:.3f}",
              flush=True)
        entries.append({"name": name, "shapes_rows_t": [list(s) for s in RAVE_STFT_SHAPES],
                        "scales": list(RAVE_STFT_SCALES), "ms": ms, "plain_ms": pms, "bytes": nbytes,
                        "ms_at_copy_rate": at_copy})
    del x, y
    torch.cuda.empty_cache()

    cfg = Config.from_yaml("configs/rave_v1.yaml")
    model = load_model(cfg.model.name, cfg.model.kwargs).to(device)
    gen = torch.Generator(device).manual_seed(SEED)
    model.init_weights(gen)
    tx = make_optimizer(cfg)
    state = TrainState(step=0, model=model, opt_state=tx.init(list(model.parameters())), generator=gen,
                       mean_loudness=0.0, std_loudness=1.0)
    b, t = cfg.train.batch, cfg.preprocess.signal_length
    crops = (0.3 * torch.randn((2, b, t), generator=g)).to(device)
    multi = make_train_multi_step(model, tx, cfg, 2)
    rows = multi(state, {"sig": crops}).cpu()
    check(bool(torch.isfinite(rows).all()) and state.step == 2, f"RAVE's graphed steps: {rows.tolist()}")
    want = rave_train_launches(multi.unroll, len(adam.plan([p.numel() for p in model.parameters()])))
    check(multi.captured == want, f"RAVE's graph captured {multi.captured}, want {want}")
    print(f"rave graphed step B={b} T={t}: captured {multi.captured} over {multi.unroll} steps, losses "
          f"{rows[:, 0].tolist()}", flush=True)
    for e in entries:
        e["launches_a_step"] = want[e["name"]] // multi.unroll
    del multi, state, model, crops
    torch.cuda.empty_cache()
    return entries


def phase_adam_kernel(device) -> list:
    """Phase 2, Adam (ops/adam.py) over the leaves of each train cell's
    model (ADAM_LEAF_SETS): ADAM_STEPS steps of the kernel (with the loss
    and the norm where the DDSP step gives them, without for CREPE's) and
    of the plain path on the same gradients, equal bit for bit; then each
    one's device time a step (CUDA events) beside the byte floor at the
    measured copy rate.  Returns the entries for the report."""
    from ddsp_pytorch_tpu_torch.ops import adam

    cycles_per_ms = sleep_cycles_per_ms()
    entries = []
    for label, path, guarded in ADAM_LEAF_SETS:
        if path is None:
            shapes = [p.shape for p in crepe.CREPE("full").parameters()]
        else:
            cfg = Config.from_yaml(path)
            shapes = [p.shape for p in load_model(cfg.model.name, cfg.model.kwargs).parameters()]
        g = torch.Generator(device).manual_seed(SEED)
        grads = [0.01 * torch.randn(s, generator=g, device=device) for s in shapes]
        loss = torch.ones((), device=device) if guarded else None
        sides = []
        for kernel in (True, False):
            tx = Optimizer("adam", 1e-3)
            params = [torch.randn(s, generator=torch.Generator(device).manual_seed(SEED + 1), device=device)
                      for s in shapes]
            state = tx.init(params)

            def step():
                if kernel:
                    return tx.apply_(params, grads, state, loss)
                updates, new = tx.update(grads, state)
                with torch.no_grad():
                    for p, u in zip(params, updates):
                        p.add_(u)
                    for old, value in zip(tree_leaves(state), tree_leaves(new)):
                        old.copy_(value)

            for _ in range(ADAM_STEPS):
                step()
            torch.cuda.synchronize()
            sides.append([t.clone() for t in params + tree_leaves(state)])
            ms, _ = time_ms(step, 20 if kernel else 3, cycles_per_ms)
            sides.append(ms)
            del params, state
        (got, ms), (want, plain_ms) = sides[:2], sides[2:]
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"Adam kernel vs plain after {ADAM_STEPS} steps over the {label} leaves")
        n = sum(int(np.prod(s)) for s in shapes)
        nbytes = (32 if guarded else 28) * n
        floor_ms = 1e3 * nbytes / MEASURED_COPY_BYTES_PER_S
        blocks = sum(launch[1][-1] for launch in adam.plan([int(np.prod(s)) for s in shapes]))
        print(f"adam {label}: {len(shapes)} leaves, {n} parameters, {blocks} blocks, norm {guarded}: equal to "
              f"the plain path after {ADAM_STEPS} steps; kernel_ms={ms:.6f} plain_ms={plain_ms:.6f} "
              f"bytes={nbytes} floor_ms={floor_ms:.6f} share_of_floor={floor_ms / ms:.3f}", flush=True)
        entries.append({"name": "adam", "leaves": label, "parameters": n, "norm": guarded, "ms": ms,
                        "plain_ms": plain_ms, "bytes": nbytes, "ms_at_copy_rate": floor_ms})
        del grads
    torch.cuda.empty_cache()
    return entries


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

    kernels.reset_counts()
    render_ms, outs = [], []
    for i in range(N_BLOCKS):
        sl = slice(i * block, (i + 1) * block)
        t0 = time.perf_counter()
        audio = gpu.step_samples(pitch[:, sl], loud[:, sl])
        torch.cuda.synchronize()
        render_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(audio)
    launches = _launched("oscillator_fwd")

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

        kernels.reset_counts()
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
        launches = _launched("oscillator_fwd")
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
    before = (_launched("oscillator_fwd"), _launched("oscillator_bwd"))
    gpu_loss, gpu_grads = step(gpu_model, device)
    launched = (_launched("oscillator_fwd") - before[0], _launched("oscillator_bwd") - before[1])
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
    kernels.reset_counts()
    t0 = time.perf_counter()
    state = trainer.fit(dm)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fwd, bwd = _launched("oscillator_fwd"), _launched("oscillator_bwd")
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


def phase_graphed_vs_eager(device, cache: str, card: str, dtype: str = "float32",
                           unrolls=(1, 2)) -> dict:
    """Phase 6: the train step as a CUDA graph against eager steps at
    configs/config.yaml's full width (batch 16 x 375 frames, hidden 512,
    K = 64, 65 bands, reverb on, six scales).  From one state and the same
    N_GRAPH_STEPS batches of the device-resident cache: N_GRAPH_STEPS eager
    steps, and one call of steps_per_call N_GRAPH_STEPS replaying a graph of
    U = 1 and of U = 2 steps; per-step losses and every parameter leaf
    within GRAPHED_REL relative.  Then ms per step, synced, for both, the
    capture time, the graph pool and the peak memory of each.  Phase 26
    runs it with the model's dtype bfloat16 and U = 1.  Returns the numbers
    for the report."""
    cfg = Config.from_yaml(CONFIG)
    cfg.model.kwargs = {**cfg.model.kwargs, "dtype": dtype}
    loader = DeviceDataLoader(Dataset(os.path.join(cache, "train")), cfg.train.batch, shuffle=True,
                              drop_last=True, seed=SEED, device=device)
    idx2d = []
    for epoch in range(N_GRAPH_STEPS):
        loader.set_epoch(epoch)
        idx2d += list(loader.index_batches())
    idx2d = np.stack(idx2d[:N_GRAPH_STEPS])
    base = init_params(load_model(cfg.model.name, cfg.model.kwargs),
                       torch.Generator().manual_seed(SEED)).to(device)
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
    for unroll in unrolls:
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
            f"graphed vs eager step (configs/config.yaml full width, {dtype}, batch {cfg.train.batch} x "
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
        check(multi.captured == train_launches(int(dtype == "float32"), unroll),
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
        f"eager ms/step ({dtype}, median of {N_TIMED_EAGER} synced steps) = {out['eager_step_ms']:.3f} "
        f"(min {min(eager_ms):.3f} max {max(eager_ms):.3f}); peak bytes={eager_peak}; graphed "
        + " ".join(f"U={u} {out[u]['step_ms']:.3f}" for u in unrolls) + " ms/step; eager/graphed "
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
    kernels.reset_counts()
    cfg, trainer, state, fit_s = _violin_fit(Trainer, run_dir, cache, device)
    shape = (cfg.train.batch * cfg.n_frames, cfg.model.kwargs["n_harmonic"], cfg.model.kwargs["block_size"])
    check(shape == GRAPHED_SHAPE, f"the violin run's kernel shape {shape} is not phase 2's {GRAPHED_SHAPE}")
    counts = {name: (c["launches"], c["captured"], c["replayed"]) for name, c in _model_counts().items()}
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
        check(replayed == train_launches(1, N_VIOLIN_STEPS)[name],
              f"{name} replayed {replayed}x in {N_VIOLIN_STEPS} graphed steps")
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
    kernels.reset_counts()
    got = torch.cat([gpu.step_samples(pitch[:, i * block:(i + 1) * block], loud[:, i * block:(i + 1) * block])
                     for i in range(N_BLOCKS)], dim=-1).cpu().numpy()
    streamed = _launched("oscillator_fwd")
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
    served = _launched("oscillator_fwd") - streamed

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
    kernels.reset_counts()
    result = bench_roofline.run(device, kernel_ms=kernel_ms)
    launches = {name: _launched(name) for name in ("roofline_fma", "roofline_sin")}
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

        before = _launched("oscillator_fwd")
        threads = [threading.Thread(target=run, args=(i,)) for i in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        launches = _launched("oscillator_fwd") - before
        check(sorted(results) == list(range(n_clients)), f"a client of the voices={voices} server did not finish")
        return [results[i] for i in range(n_clients)], launches
    finally:
        server.stop()


def phase_pool(device, card: str) -> tuple:
    """Phase 10, with oscillator_fwd's count set to 0 just before it.
    Returns (its launches, the ramps)."""
    kernels.reset_counts()
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
    return _launched("oscillator_fwd"), ramps


def phase_autoencoder(device, card: str) -> int:
    """Phase 11, with oscillator_fwd's count set to 0 just before it: the AE
    bundle through make_stream_session on the card against the CPU, then
    through StreamServer at voices = 1 and N_SERVER_VOICES.  Returns its
    launches."""
    kernels.reset_counts()
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
    return _launched("oscillator_fwd")


def phase_ae_corpus(device, tmp: str) -> tuple:
    """Phase 12a, with the kernel counts set to 0 just before it: the violin
    AE corpus rendered on the card by train_pretrained.render_corpus; its
    first note against the CPU plain render of the same draws.  Returns
    (the cache directory, oscillator_fwd's launches)."""
    kernels.reset_counts()
    t0 = time.perf_counter()
    cache = train_pretrained.render_corpus(tmp, "violin", True, AE_ITEMS, device)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    launches = _launched("oscillator_fwd")
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
    kernels.reset_counts()
    t0 = time.perf_counter()
    state = trainer.fit(dm)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    trainer.close()
    counts = {name: (c["launches"], c["captured"], c["replayed"]) for name, c in _model_counts().items()}
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
        per_step = train_launches(2)[name]
        check(captured == per_step * cfg.train.scan_unroll and replayed == per_step * N_AE_STEPS,
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
    check(multi.captured == train_launches(2), f"AE captured {multi.captured}")
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

    kernels.reset_counts()
    got = np.concatenate([gpu.step_samples(pitch[sl(i)], loud[sl(i)], audio[sl(i)]) for i in range(N_BLOCKS)])
    streamed = _launched("oscillator_fwd")
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
    served = _launched("oscillator_fwd") - streamed
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
    kernels.reset_counts()
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
                before = _launched("oscillator_fwd")
                t0 = time.perf_counter()
                y = fn(*args, device=dev, **kw)
                calls.append((time.perf_counter() - t0, _launched("oscillator_fwd") - before))
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
    return _launched("oscillator_fwd")


def phase_headline(device, card: str) -> int:
    """Phase 14, with the kernel counts set to 0 just before it: the port's
    bench.py (×-realtime at 48 kHz, 100 harmonics, hidden 512; dispatch and
    value-pull), one forward launch a synth call, then performance.py on the
    violin bundle at batch 1.  Returns its forward launches."""
    kernels.reset_counts()
    line = bench.main(["--device", str(device)])
    bench_launches = _launched("oscillator_fwd")
    r = performance.run_benchmark(BUNDLE, n_run=10, batch=1, device=device)
    launches = _launched("oscillator_fwd")
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
    kernels.reset_counts()
    drift = soak.phase_drift_soak(SOAK_SAMPLES, device=device)
    churn = soak.pool_churn_soak(SOAK_POOL_SAMPLES, device=device)
    launches = _launched("oscillator_fwd")
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
    kernels.reset_counts()
    got, host_ms = [], []
    for p, l, a in feeds:
        t0 = time.perf_counter()
        got.append(host.perform(p, l, a))
        host_ms.append((time.perf_counter() - t0) * 1e3)
    launches = _launched("oscillator_fwd")
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



def phase_accuracy(device, tmp: str) -> int:
    """Phase 17: pitch_accuracy.score_corpus on the card over the default
    16 kHz validation corpus (ACCURACY_FILES notes, seed 0): yin and the
    shipped CREPE held to pretrained/pitch_accuracy.json (the frame count
    equal, RPA@50c within ACCURACY_RPA_ATOL, median |cents| within
    ACCURACY_MEDIAN_ATOL), and the card's yin f0 against the CPU plain
    path on every file: on the voiced frames the score counts, within
    ACCURACY_YIN_CENTS on all but ACCURACY_YIN_SHARE_BEYOND of them and
    within ACCURACY_YIN_MAX_CENTS on all (the largest difference over all
    frames is printed).
    Returns oscillator_fwd's launches (none: no tracker synthesizes)."""
    corpus = os.path.join(tmp, "oof16k")
    make_oof_corpus(corpus, sample_rate=16000, n_train=0, n_validation=ACCURACY_FILES)
    with open(ACCURACY_JSON) as f:
        artifact = json.load(f)["summary"]
    kernels.reset_counts()
    t0 = time.perf_counter()
    report = pitch_accuracy.score_corpus(corpus, 256, crepe_bundle=CREPE_PARAMS, device=device)
    secs = time.perf_counter() - t0
    launches = _launched("oscillator_fwd")
    rows = {}
    for name, summary in report["summary"].items():
        o = summary["overall"]
        rows[name] = {k: o[k] for k in ("rpa", "mean_abs_cents", "median_abs_cents", "n_frames")}
        if name in artifact:
            rows[name]["artifact"] = {k: artifact[name]["overall"][k] for k in ("rpa", "median_abs_cents",
                                                                                 "n_frames")}
    voiced_cents, worst_all = [], 0.0
    for stem in sorted(os.listdir(os.path.join(corpus, "validation"))):
        sig, _ = load_wav(os.path.join(corpus, "validation", stem), 16000)
        truth = np.load(os.path.join(corpus, "truth", "validation", stem[:-4] + ".npz"))
        card = extract_pitch(sig, 16000, 256, device=device).cpu().numpy()
        cpu_f0 = extract_pitch(sig, 16000, 256, device="cpu").numpy()
        cents = np.abs(cents_error(card, cpu_f0))
        _, voiced = frame_truth(truth["f0"], truth["voiced"], 256, len(card))
        worst_all = max(worst_all, float(cents.max()))
        voiced_cents.append(cents[voiced])
    voiced_cents = np.concatenate(voiced_cents)
    beyond = int(np.sum(voiced_cents > ACCURACY_YIN_CENTS))
    print(json.dumps({"phase": "accuracy", "files": ACCURACY_FILES, "seconds": round(secs, 3),
                      "trackers": rows, "yin_card_vs_cpu_cents": {
                          "voiced_max": float(voiced_cents.max()), "voiced_median": float(np.median(voiced_cents)),
                          "voiced_beyond_1_cent": beyond, "voiced_frames": int(voiced_cents.size),
                          "all_frames_max": worst_all}}),
          flush=True)
    for name in ("yin", "crepe"):
        got, want = rows[name], rows[name]["artifact"]
        check(got["n_frames"] == want["n_frames"] == ACCURACY_FRAMES, f"{name}: {got['n_frames']} frames")
        check(abs(got["rpa"] - want["rpa"]) <= ACCURACY_RPA_ATOL, f"{name} RPA {got['rpa']} vs {want['rpa']}")
        check(abs(got["median_abs_cents"] - want["median_abs_cents"]) <= ACCURACY_MEDIAN_ATOL,
              f"{name} median cents {got['median_abs_cents']} vs {want['median_abs_cents']}")
    check(beyond <= ACCURACY_YIN_SHARE_BEYOND * voiced_cents.size
          and float(voiced_cents.max()) <= ACCURACY_YIN_MAX_CENTS,
          f"yin on the card vs the CPU: {beyond} voiced frames beyond {ACCURACY_YIN_CENTS} cent, "
          f"the largest {float(voiced_cents.max())} cents")
    return launches


def _bundle_stream_card_vs_cpu(bundle: str, cache: str, device) -> tuple:
    """N_BLOCKS blocks of the first training item's controls streamed from
    `bundle` on the card and on the CPU (deterministic noise): (max |Δ|,
    the card's peak, oscillator_fwd's launches on the card)."""
    gpu = make_streaming_synth(bundle, device=device, noise_deterministic=True)
    cpu = make_streaming_synth(bundle, device="cpu", noise_deterministic=True)
    block = gpu.block_size
    pitch, loud = (np.repeat(np.load(os.path.join(cache, "train", f"{name}.npy"))[:1, :N_BLOCKS], block, axis=1)
                   for name in ("pitchs", "loudness"))
    before = _launched("oscillator_fwd")
    got = torch.cat([gpu.step_samples(pitch[:, i * block:(i + 1) * block], loud[:, i * block:(i + 1) * block])
                     for i in range(N_BLOCKS)], dim=-1).cpu().numpy()
    launches = _launched("oscillator_fwd") - before
    want = torch.cat([cpu.step_samples(pitch[:, i * block:(i + 1) * block], loud[:, i * block:(i + 1) * block])
                      for i in range(N_BLOCKS)], dim=-1).numpy()
    check(got.shape == (1, N_BLOCKS * block) and bool(np.isfinite(got).all()), "bundle stream")
    return float(np.abs(got - want).max()), float(np.abs(got).max()), launches


def phase_oof(device, card: str, tmp: str) -> dict:
    """Phase 18: the train_oof CLI at the reference width (48 kHz, hidden
    512, 64 harmonics, 65 bands, reverb, six scales, batch 8,
    steps_per_call 25, the train split on the card) on the default corpus
    (18 + 4 fixture notes of 4 s) for N_OOF_STEPS steps: finite losses that
    fall, both kernels launched (graph replays counted), steps/s, the first
    and last 10 losses beside pretrained/oof_loss.json's first points; then
    its exported bundle streamed on the card against the CPU (1e-4, and
    1e-3 of the peak).  Returns {kernel: launches on the path}."""
    root, out = os.path.join(tmp, "oof"), os.path.join(tmp, "oof_out")
    kernels.reset_counts()
    t0 = time.perf_counter()
    traj = train_oof.main(["--device", str(device), "--steps", str(N_OOF_STEPS), "--root", root, "--out", out,
                           "--flush-steps", "25", "--checkpoint-every", "0",
                           "--val-interval-epochs", str(OOF_INTERVAL_EPOCHS),
                           "--log-interval-epochs", str(OOF_INTERVAL_EPOCHS)])
    secs = time.perf_counter() - t0
    counts = _launches_and_replays()
    replayed = {name: c["replayed"] for name, c in _model_counts().items()}
    run_dir = os.path.join(root, "runs", "oof")
    losses = [v for _, v in read_metrics(run_dir, "loss")]
    skipped = [v for _, v in read_metrics(run_dir, "update_skipped")]
    window = read_metrics(run_dir, "train_window_steps_per_s")
    with open(OOF_LOSS_JSON) as f:
        jax_curve = json.load(f)["loss_curve_every_100"][:2]
    err, peak, stream_fwd = _bundle_stream_card_vs_cpu(os.path.join(out, "ddsp_oof_bundle"),
                                                       os.path.join(root, "cache"), device)
    print(json.dumps({"phase": "train_oof", "card": card, "steps": len(losses), "seconds": round(secs, 3),
                      "steps_per_s": window[-1][1], "loss_first10_mean": traj["loss_first10_mean"],
                      "loss_last10_mean": traj["loss_last10_mean"], "jax_loss_at_steps_0_100": jax_curve,
                      "val_losses": traj["val_losses"], "launches": counts, "replayed": replayed,
                      "export_stream_card_vs_cpu": err, "export_stream_peak": peak,
                      "export_stream_launches": stream_fwd,
                      "media": sorted(os.listdir(os.path.join(run_dir, "audio")))}), flush=True)
    check(len(losses) == N_OOF_STEPS and all(np.isfinite(losses)) and sum(skipped) == 0,
          "train_oof: a loss not finite, a skipped update or a missing step")
    check(traj["loss_first10_mean"] >= LOSS_FALL_FACTOR * traj["loss_last10_mean"],
          f"train_oof: the loss did not fall by {LOSS_FALL_FACTOR}x")
    for name, n in replayed.items():
        check(n == train_launches(1, N_OOF_STEPS)[name], f"{name} replayed {n}x in {N_OOF_STEPS} graphed "
              "train_oof steps")
    check(peak > 0 and stream_fwd == N_BLOCKS, f"exported stream peak {peak}, {stream_fwd} launches")
    check(err <= STREAM_GPU_VS_CPU_ATOL and err <= EXPORT_STREAM_REL_OF_PEAK * peak,
          f"exported OOF bundle card vs CPU {err} (peak {peak})")
    return counts


def phase_sigmund(device, tmp: str) -> dict:
    """Phase 19: the train_sigmund CLI at a narrow config (SIGMUND_SETS):
    the full_chain fixtures through the emulated sigmund~ analyzer into a
    3-channel float wav, ingested, then trained in two segments of
    SIGMUND_SEGMENT steps (fresh child processes on the card after a
    stats-priming child), validated and exported; segments.jsonl has the
    priming line and the two segments'.  The same steps run unsegmented in
    this process from the same config end bitwise equal (parameters,
    optimizer state, generator); that run is `train --profile`, whose
    trace of its graphed steps holds CUDA kernels.  Returns {kernel:
    launches in this process} (the unsegmented run and the validation)."""
    root, out = os.path.join(tmp, "sigmund"), os.path.join(tmp, "sigmund_out")
    steps = 2 * SIGMUND_SEGMENT
    kernels.reset_counts()
    t0 = time.perf_counter()
    traj = train_sigmund.main(["--device", str(device), "--steps", str(steps), "--segment-steps",
                               str(SIGMUND_SEGMENT), "--steps-per-call", "2", "--batch", "4", "--n-train", "6",
                               "--n-validation", "2", "--root", root, "--out", out,
                               *[a for kv in SIGMUND_SETS for a in ("--set", kv)]])
    secs = time.perf_counter() - t0
    runs = os.path.join(root, "runs")
    t1 = time.perf_counter()
    whole = train_cli.main(["--config", os.path.join(root, "sigmund.yaml"), "--root", runs, "--name", "whole",
                            "--device-cache", "--device", str(device), "--steps", str(steps), "--profile"])
    whole_s = time.perf_counter() - t1
    with open(os.path.join(runs, "whole", "trace", profiling.TRACE_FILE)) as f:
        traced = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
    traced_osc = sum(1 for e in traced if "oscillator" in e.get("name", "").lower())
    counts = _launches_and_replays()
    seg = torch.load(os.path.join(runs, "sigmund", "checkpoints", f"{steps}.pt"), map_location="cpu",
                     weights_only=False)
    ref = torch.load(os.path.join(runs, "whole", "checkpoints", f"{steps}.pt"), map_location="cpu",
                     weights_only=False)
    leaves = [(k, seg["params"][k], ref["params"][k]) for k in ref["params"]]
    leaves += [(f"opt/{i}", a, b) for i, (a, b) in enumerate(zip(tree_leaves(seg["opt_state"]),
                                                                 tree_leaves(ref["opt_state"])))]
    unequal = [k for k, a, b in leaves if not torch.equal(a, b)]
    same_gen = torch.equal(seg["generator"], ref["generator"])
    with open(os.path.join(runs, "sigmund", "segments.jsonl")) as f:
        segments = [json.loads(line) for line in f]
    seg_losses = [v for _, v in read_metrics(os.path.join(runs, "sigmund"), "loss")]
    whole_losses = [v for _, v in read_metrics(os.path.join(runs, "whole"), "loss")]
    tri, sr = read_wav(os.path.join(root, "wavs", "train.wav"))
    print(json.dumps({"phase": "train_sigmund_segmented", "steps": steps, "seconds": round(secs, 3),
                      "unsegmented_seconds": round(whole_s, 3), "profile_trace_kernels": len(traced),
                      "profile_trace_oscillator_kernels": traced_osc, "segments": segments,
                      "leaves_compared": len(leaves), "leaves_unequal": unequal, "generator_equal": same_gen,
                      "losses_equal": seg_losses == whole_losses, "wav": [list(tri.shape), str(tri.dtype), sr],
                      "val_losses": traj["val_losses"], "launches_in_process": counts}), flush=True)
    check(whole.step == steps and traj["steps"] == steps, "sigmund steps")
    check([rec["to_step"] for rec in segments] == [0, SIGMUND_SEGMENT, steps]
          and all(rec["returncode"] == 0 for rec in segments), f"segments.jsonl {segments}")
    check(not unequal and same_gen and seg_losses == whole_losses,
          f"segmented != unsegmented: {unequal}, generator equal {same_gen}")
    check(tri.dtype == np.float32 and tri.shape[1] == 3, "sigmund wav")
    check(len(traced) > 0, "train --profile traced no CUDA kernel")
    return counts


def phase_crepe_training(device, card: str, tmp: str) -> None:
    """Phase 20: one train-mode CREPE step at micro capacity on the card
    against the CPU from the same weights, draws and dropout masks (loss
    and updated batch_stats within CREPE_STEP_ATOL); three tiny steps at
    batch 256 traced with the profiler on the card (CUDA kernels in the
    trace; host ms, device busy ms, kernels and the heaviest kernels a
    step); then
    train_crepe.train at tiny capacity, batch 256, N_CREPE_STEPS steps:
    the loss falls, eval_rpa rises above the first step's, steps/s; the
    saved msgpack loads through load_crepe with the in-memory net's
    salience."""
    cpu_model = train_crepe.init_crepe(crepe.CREPE("micro"), torch.Generator().manual_seed(SEED))
    gpu_model = copy.deepcopy(cpu_model).to(device)
    frames, f0 = train_crepe.synth_batch(train_crepe.draw_synth_inputs(8, torch.Generator().manual_seed(1)))
    target = train_crepe.f0_to_target(f0)
    gen = torch.Generator().manual_seed(2)
    masks = [torch.rand(shape, generator=gen) < 1.0 - crepe.DROPOUT_RATE for shape in cpu_model.block_shapes(8)]
    sides = []
    for model, dev in ((cpu_model, "cpu"), (gpu_model, device)):
        tx = Optimizer("adam", 2e-3)
        loss, _, _ = train_crepe.train_step(model, tx, tx.init(list(model.parameters())), frames.to(dev),
                                            target.to(dev), 20.0, dropout_masks=[m.to(dev) for m in masks])
        sides.append((float(loss), {k: v.cpu() for k, v in model.state_dict().items() if "running" in k}))
    (want_loss, want_stats), (got_loss, got_stats) = sides
    stats_err = max(float((got_stats[k] - v).abs().max()) for k, v in want_stats.items())

    gen_card = torch.Generator(device).manual_seed(SEED)
    tx = Optimizer("adam", 2e-3)
    opt_state = tx.init(list(gpu_model.parameters()))
    with profiling.trace(os.path.join(tmp, "crepe_trace"), device) as prof:
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(3):
            batch_frames, batch_f0 = train_crepe.synth_batch(train_crepe.draw_synth_inputs(256, gen_card))
            _, _, opt_state = train_crepe.train_step(gpu_model, tx, opt_state, batch_frames,
                                                     train_crepe.f0_to_target(batch_f0), 20.0,
                                                     generator=gen_card)
        _sync(device)
        traced_ms = 1e3 * (time.perf_counter() - t0) / 3
    with open(os.path.join(tmp, "crepe_trace", profiling.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    kernels_traced = sum(1 for e in events if e.get("cat") == "kernel")
    device_events, busy_ms = device_kernels(prof)
    by_kernel = {}
    for e in device_events:
        by_kernel[e.name] = by_kernel.get(e.name, 0.0) + e.time_range.elapsed_us() / 3e3
    top_kernels = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]

    t0 = time.perf_counter()
    model, log = train_crepe.train("tiny", steps=N_CREPE_STEPS, batch=256, log_every=100, device=device)
    secs = time.perf_counter() - t0
    path = os.path.join(tmp, "crepe_tiny.msgpack")
    with open(path, "wb") as f:
        f.write(train_crepe.crepe_bytes(model))
    loaded = crepe.load_crepe(path, device=device)
    eval_frames, _ = train_crepe.synth_batch(
        train_crepe.draw_synth_inputs(512, torch.Generator(device).manual_seed(train_crepe.EVAL_SEED)))
    with torch.no_grad():
        reload_err = float((torch.sigmoid(loaded(eval_frames)) - torch.sigmoid(model(eval_frames))).abs().max())
    print(json.dumps({"phase": "crepe_training", "card": card,
                      "micro_step_card_vs_cpu": {"loss": [got_loss, want_loss], "batch_stats_max_err": stats_err},
                      "trace_cuda_kernels": kernels_traced,
                      "traced_step": {"host_ms": traced_ms, "device_busy_ms": busy_ms / 3,
                                      "kernels_a_step": len(device_events) / 3,
                                      "top_kernels_ms_a_step": top_kernels},
                      "tiny_batch": 256, "steps": N_CREPE_STEPS,
                      "seconds": round(secs, 3), "steps_per_s": N_CREPE_STEPS / secs, "log": log,
                      "saved_bytes": os.path.getsize(path), "reloaded_salience_max_err": reload_err}), flush=True)
    check(abs(got_loss - want_loss) <= CREPE_STEP_ATOL and stats_err <= CREPE_STEP_ATOL,
          f"CREPE step card vs CPU: loss {got_loss} vs {want_loss}, batch_stats {stats_err}")
    check(kernels_traced > 0, "the profiler traced no CUDA kernel")
    check(all(np.isfinite(r["loss"]) for r in log) and log[-1]["loss"] < log[0]["loss"],
          f"CREPE training loss did not fall: {log}")
    check(log[-1]["rpa50"] > log[0]["rpa50"], f"CREPE eval RPA did not rise: {log}")
    check(reload_err <= 1e-6, f"reloaded CREPE salience differs by {reload_err}")


def phase_sweep(device, tmp: str) -> None:
    """Phase 21: tune_hybrid_pitch on a one-file cache (the snr10
    condition): the evidence built and a 2 x 2 sweep run on the card, then
    the same on the CPU; every combination's RPA equal."""
    conds = [c for c in tune_hybrid_pitch.conditions() if c[0] == "snr10"]
    combos = [(f"y{w}_s{s}", dict(yin_weight=w, switch_per_octave=s, salience_floor=0.03, confidence_gate=2.0))
              for w in (4.0, 8.0) for s in (10.0, 60.0)]
    tables = {}
    for side, dev in (("card", device), ("cpu", "cpu")):
        cache = os.path.join(tmp, f"sweep_{side}")
        model = crepe.load_crepe(CREPE_PARAMS, device=dev)
        t0 = time.perf_counter()
        tune_hybrid_pitch.build_cache(cache, 16000, 256, 1, model, conds, device=dev)
        tables[side] = (tune_hybrid_pitch.sweep(cache, 16000, 256, combos, device=dev), time.perf_counter() - t0)
    print(json.dumps({"phase": "hybrid_sweep", "card": tables["card"][0], "cpu": tables["cpu"][0],
                      "seconds": {k: round(v[1], 3) for k, v in tables.items()}}), flush=True)
    check(tables["card"][0] == tables["cpu"][0], "the hybrid sweep's RPA differs card vs CPU")


def _model_counts() -> dict:
    """{kernel: {launches, captured, replayed}} of the models' kernels since
    the last reset."""
    counts = kernels.counts()
    return {name: counts[name] for name in kernels.MODEL_KERNELS}


def _launches_and_replays() -> dict:
    """{kernel: launches + graph replays} of the models' kernels since the
    last reset."""
    return {name: c["launches"] + c["replayed"] for name, c in _model_counts().items()}


def _launched(name: str) -> int:
    """Kernel `name`'s launches since the last reset."""
    return kernels.counts()[name]["launches"]


def phase_time_sharded(device, cache: str, tmp: str, card: str) -> dict:
    """Phase 22: configs/config_timesharded.yaml on the card (the reference
    workload, 16 × 375 frames, mesh.time 4, padded to 384 frames).  First
    the main path: Trainer.fit at the committed config with its in-process
    time = 4 mesh for TS_FIT_STEPS steps on the violin-rendered cache, the
    launches counted from zero around it.  Then, from fresh weights, one
    batch and injected noise, the time-sharded loss and gradients on a
    time = 4 and a data 2 × time 4 mesh against the unsharded step's, each
    one launch of each kernel over 6144 rows.  Then TS_GRAPH_STEPS eager
    steps against one graphed call (MultiStep) of as many, sharded, within
    GRAPHED_REL; and ms per step, eager and graphed, sharded and unsharded.
    Returns the launches by path."""
    cfg = Config.from_yaml(TIMESHARDED_CONFIG)
    check(cfg.mesh.time == 4 and cfg.n_frames == 375, f"{TIMESHARDED_CONFIG} is not the reference workload")
    fit_cfg = Config.from_yaml(TIMESHARDED_CONFIG)
    fit_cfg.apply_overrides([
        f"preprocess.out_dir={cache}", f"train.steps={TS_FIT_STEPS}", "train.val_interval_epochs=2",
        "train.log_interval_epochs=0", "train.checkpoint_every_steps=0", "train.metrics_flush_steps=10",
    ])
    mesh = make_mesh(fit_cfg.mesh.data, fit_cfg.mesh.time)
    dm = Datamodule(fit_cfg, mesh=mesh)
    dm.setup()
    run_dir = os.path.join(tmp, "run_timesharded")
    trainer = Trainer(fit_cfg, run_dir, device=device, mesh=mesh)
    kernels.reset_counts()
    t0 = time.perf_counter()
    state = trainer.fit(dm)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit = _launches_and_replays()
    trainer.close()
    losses = [v for _, v in read_metrics(run_dir, "loss")]
    val = read_metrics(run_dir, "loss/val")
    plan = plan_time_padding(fit_cfg, mesh)
    print(f"time-sharded Trainer.fit ({TIMESHARDED_CONFIG}, {mesh}, batch {fit_cfg.train.batch} x "
          f"{fit_cfg.n_frames} frames padded to {plan.frames_pad}, chunk {plan.chunk} samples, reverb, "
          f"scales {fit_cfg.train.scales}): {state.step} steps in {fit_s:.2f} s; "
          f"losses {[round(v, 5) for v in losses]}; val {[round(v, 5) for _, v in val]}; launches {fit}; "
          f"eval forwards {trainer.eval_forwards}; card {card}", flush=True)
    check(state.step == TS_FIT_STEPS and len(losses) == TS_FIT_STEPS and all(np.isfinite(losses)),
          "the time-sharded fit's steps or losses")
    check(fit["oscillator_bwd"] == TS_FIT_STEPS and
          fit["oscillator_fwd"] == TS_FIT_STEPS + trainer.eval_forwards,
          f"time-sharded fit launches {fit}, expected a forward and a backward a step (+ evals)")
    del trainer, dm
    torch.cuda.empty_cache()

    data = Dataset(os.path.join(cache, "train"))
    batch = to_device(dict_collate([data[i] for i in range(cfg.train.batch)]), device)
    meta = read_meta(BUNDLE)
    base = init_params(load_model(cfg.model.name, cfg.model.kwargs),
                       torch.Generator().manual_seed(SEED + 30)).to(device)
    noise = uniform_noise((cfg.train.batch, cfg.n_frames, base.block_size),
                          torch.Generator(device).manual_seed(SEED + 31), torch.float32, device)
    state = TrainState(0, base, {}, torch.Generator(device), meta["mean_loudness"], meta["std_loudness"])
    names = [n for n, _ in base.named_parameters()]
    unsharded = make_loss_and_grads(base, cfg, None)
    loss0, g0 = unsharded(state, batch, noise)
    norm0 = float(global_norm(g0))
    _, g_perturbed = unsharded(state, batch, noise * (1.0 + 1e-7))
    moved = {n: float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
             for n, a, b in zip(names, g_perturbed, g0)}
    print("unsharded step, its noise scaled by 1 + 1e-7, against itself (max|Δ|/max|g|): "
          + ", ".join(f"{n}={moved[n]:.3e}" for n in FLAGGED_LEAVES), flush=True)
    del g_perturbed
    step_launches = {}
    for shape in ((1, 4), (2, 4)):
        mesh = make_mesh(*shape)
        fn = make_loss_and_grads(base, cfg, mesh)
        kernels.reset_counts()
        loss1, g1 = fn(state, batch, noise)
        torch.cuda.synchronize()
        launched = _launches_and_replays()
        rows = fn.plan.frames_pad * cfg.train.batch
        loss_rel = abs(float(loss1) - float(loss0)) / abs(float(loss0))
        norm_rel = abs(float(global_norm(g1)) - norm0) / norm0
        of_max = {n: float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                  for n, a, b in zip(names, g1, g0)}
        rel_l2 = {n: float((a - b).norm()) / max(float(b.norm()), 1e-30) for n, a, b in zip(names, g1, g0)}
        of_whole = {n: float((a - b).norm()) / norm0 for n, a, b in zip(names, g1, g0)}
        whole = float(torch.cat([(a - b).flatten() for a, b in zip(g1, g0)]).norm()) / norm0
        worst = sorted(of_max, key=of_max.get, reverse=True)[:4]
        print(f"time-sharded step vs unsharded on the card ({mesh}, fresh weights, {cfg.train.batch} x "
              f"{cfg.n_frames} frames, rows a launch {rows}): loss {float(loss1):.7f} vs {float(loss0):.7f} "
              f"rel {loss_rel:.3e}; grad norm rel {norm_rel:.3e}; whole-gradient rel L2 {whole:.3e}; largest "
              "leaf errors (max|Δ|/max|g|, own rel L2, |Δ|/|g|): "
              + ", ".join(f"{n}=({of_max[n]:.3e}, {rel_l2[n]:.3e}, {of_whole[n]:.3e})" for n in worst)
              + f"; launches {launched}", flush=True)
        check(launched == train_launches(1, scales=0, adam=False),
              f"the sharded step launched {launched}, expected one forward and one backward of each "
              "oscillator and GRU kernel (its loss is its own)")
        check(rows == fn.plan.frames_pad * cfg.train.batch and fn.plan.frames_pad == 384,
              f"the sharded launch holds {rows} rows, expected 6144")
        check(loss_rel <= TS_LOSS_REL, f"time-sharded loss rel {loss_rel}")
        check(norm_rel <= TS_GRAD_NORM_REL, f"time-sharded grad norm rel {norm_rel}")
        check(whole <= STEP_GRAD_REL, f"time-sharded whole-gradient rel L2 {whole}")
        for n, a, b in zip(names, g1, g0):
            check(of_whole[n] <= STEP_LEAF_OF_WHOLE, f"time-sharded gradient of {n}: |Δ|/|g| {of_whole[n]}")
            if n in FLAGGED_LEAVES:
                continue
            bound = TS_LEAF_OF_MAX * float(b.abs().max()) + 1e-3 * b.abs()
            check(bool(((a - b).abs() <= bound).all()), f"time-sharded gradient of {n}: {of_max[n]:.3e} of max")
        step_launches[f"{shape[0]}x{shape[1]}"] = launched
    del g0, g1
    torch.cuda.empty_cache()

    # eager against graphed, and ms a step (Adam, as the config trains)
    stacked = {k: torch.stack([v.roll(j, 0) for j in range(TS_GRAPH_STEPS)]) for k, v in batch.items()}
    timing, graphed_launches = {}, {}
    for label, mesh in (("unsharded", None), ("sharded", make_mesh(1, 4))):
        def fresh(seed):
            model = copy.deepcopy(base)
            tx = make_optimizer(cfg)
            return model, tx, TrainState(0, model, tx.init(list(model.parameters())),
                                         torch.Generator(device).manual_seed(seed),
                                         meta["mean_loudness"], meta["std_loudness"])

        model_e, tx_e, state_e = fresh(SEED + 32)
        step = make_train_step(model_e, tx_e, cfg, mesh)
        eager = torch.stack([metrics_row(step(state_e, {k: v[j] for k, v in stacked.items()}))
                             for j in range(TS_GRAPH_STEPS)]).cpu()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for j in range(TS_GRAPH_STEPS):
            step(state_e, {k: v[j] for k, v in stacked.items()})
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) * 1e3 / TS_GRAPH_STEPS
        model_g, tx_g, state_g = fresh(SEED + 32)
        multi = make_train_multi_step(model_g, tx_g, cfg, TS_GRAPH_STEPS, 1, mesh)
        kernels.reset_counts()
        graphed = multi(state_g, stacked).cpu()
        graphed_launches[label] = _launches_and_replays()
        loss_rel = rel_err(graphed[:, 0], eager[:, 0])
        leaf = _leaf_rel(model_g, model_e)
        worst = max(leaf, key=leaf.get)
        # the eager model took TS_GRAPH_STEPS more steps: compare it with a
        # second graphed call
        multi(state_g, stacked)
        torch.cuda.synchronize()
        leaf2 = _leaf_rel(model_g, model_e)
        worst2 = max(leaf2, key=leaf2.get)
        t0 = time.perf_counter()
        multi(state_g, stacked)
        torch.cuda.synchronize()
        graphed_ms = (time.perf_counter() - t0) * 1e3 / TS_GRAPH_STEPS
        timing[label] = (eager_ms, graphed_ms, multi.capture_s, multi.pool_bytes)
        print(f"{label} steps at {TIMESHARDED_CONFIG} ({mesh}): graphed vs eager per-step loss rel "
              f"{loss_rel:.3e}, worst leaf after {2 * TS_GRAPH_STEPS} steps {worst2} rel {leaf2[worst2]:.3e}; "
              f"captured {multi.captured}; eager ms/step {eager_ms:.3f}, graphed ms/step {graphed_ms:.3f} "
              f"(synced call of {TS_GRAPH_STEPS}); capture s {multi.capture_s}, graph pool bytes "
              f"{multi.pool_bytes}; card {card}", flush=True)
        check(loss_rel <= GRAPHED_REL, f"{label}: graphed vs eager loss rel {loss_rel}")
        check(leaf2[worst2] <= GRAPHED_REL, f"{label}: graphed vs eager {worst2} rel {leaf2[worst2]}")
        check(multi.captured == train_launches(1, scales=6 if mesh is None else 0),
              f"{label}: captured launches {multi.captured}")
        del model_e, model_g, multi, step, state_e, state_g, leaf, worst
        torch.cuda.empty_cache()
    (ue, ug, _, _), (se, sg, _, _) = timing["unsharded"], timing["sharded"]
    print(f"time-sharded / unsharded ms per step: eager {se:.3f} / {ue:.3f} = {se / ue:.3f}; graphed "
          f"{sg:.3f} / {ug:.3f} = {sg / ug:.3f}; card {card}", flush=True)
    return {"fit": fit, "step": step_launches, "graphed": graphed_launches["sharded"]}


def phase_trajectory(device, tmp: str, card: str) -> dict:
    """Phase 23: time_sharded_trajectory.py at its defaults (400 Adam steps,
    unsharded and on an in-process data 2 × time 4 mesh, 71 frames padded
    to 80) on the card, held to the artifact's bounds.  Returns its
    launches."""
    kernels.reset_counts()
    t0 = time.perf_counter()
    report = time_sharded_trajectory.run_trajectories(cache_dir=os.path.join(tmp, "trajectory_cache"),
                                                      device=device)
    secs = time.perf_counter() - t0
    launched = _launches_and_replays()
    failed = time_sharded_trajectory.check_bounds(report)
    first, last = report["loss_first_window"], report["loss_last_window"]
    print(f"trajectory ({report['steps']} steps, window {report['window']}): first window unsharded "
          f"{first['loss_unsharded']:.5f} sharded {first['loss_sharded']:.5f}; last window "
          f"{last['loss_unsharded']:.5f} / {last['loss_sharded']:.5f}; largest windowed rel diff "
          f"{max(c['rel_diff'] for c in report['checkpoints']):.3e}; final global param rel L2 "
          f"{report['final_param_global_rel_l2']:.4e}; wall s unsharded {report['wall_s_unsharded']:.2f} "
          f"sharded {report['wall_s_sharded']:.2f} ({secs:.2f} s in all, the corpus included); launches "
          f"{launched}; bounds {'met' if not failed else failed}; card {card}", flush=True)
    check(not failed, f"trajectory bounds missed: {failed}")
    check(launched["oscillator_bwd"] == 2 * report["steps"], f"trajectory launches {launched}")
    return launched


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_data_parallel(device, cache: str, tmp: str, card: str) -> dict:
    """Phase 24: data parallelism across processes on the one card.
    (a) Two ranks over gloo, each stepping on cuda:0, through the train CLI
    (--multihost --backend gloo) at configs/config.yaml (global batch 16,
    8 a rank, Adam) for DP_STEPS steps, checkpointing every step; then each
    step in this process on the global batch [rank 0's rows, rank 1's rows]
    from the run's own state before it: loss within 1e-5, gradient norm
    within 1e-3.  (b) One rank over NCCL: MultiStep (a CUDA graph with the
    gradient all_reduce inside) against MultiStep without a mesh, from one
    state on the same batches: bit for bit.  NCCL cannot put two ranks on
    one card, so two NCCL ranks wait for a machine with several.  Returns
    the NCCL run's launches."""
    import torch.distributed as dist

    cfg = Config.from_yaml(CONFIG)
    cfg.apply_overrides([
        f"preprocess.out_dir={cache}", f"train.steps={DP_STEPS}", "train.val_interval_epochs=0",
        "train.log_interval_epochs=0", "train.checkpoint_every_steps=1", f"train.keep_checkpoints={DP_STEPS}",
        "train.metrics_flush_steps=1",
    ])
    config = os.path.join(tmp, "dp_config.yaml")
    cfg.to_yaml(config)
    env = dict(os.environ, WORLD_SIZE="2", MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
               PYTHONPATH=os.pathsep.join(p for p in (os.getcwd(), os.environ.get("PYTHONPATH")) if p))
    cmd = [sys.executable, "-m", "ddsp_pytorch_tpu_torch.train", "--config", config, "--name", "dp", "--root",
           tmp, "--device", str(device), "--multihost", "--backend", "gloo", "--dist-timeout", "300"]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd, env=dict(env, RANK=str(r)), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=DP_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    secs = time.perf_counter() - t0
    for r, (p, log) in enumerate(zip(procs, logs)):
        print(f"  gloo rank {r} (exit {p.returncode}): " + " | ".join(log.strip().splitlines()[-3:]), flush=True)
    check(all(p.returncode == 0 for p in procs), "a gloo rank failed:\n" + "\n=====\n".join(logs))
    run_dir = os.path.join(tmp, "dp")
    data = Dataset(os.path.join(cache, "train"))
    mean_l, std_l = mean_std_loudness(DataLoader(data, cfg.train.batch, shuffle=False))
    model = load_model(cfg.model.name, cfg.model.kwargs).to(device)
    generator = torch.Generator(device).manual_seed(cfg.train.seed)
    init_params(model, generator)
    tx = make_optimizer(cfg)
    state = TrainState(0, model, tx.init(list(model.parameters())), generator, mean_l, std_l)
    step = make_train_step(model, tx, cfg)
    per_rank = cfg.train.batch // 2
    shards = [DataLoader(data, per_rank, shuffle=True, drop_last=True, seed=cfg.train.seed, num_shards=2,
                         shard_index=i) for i in range(2)]
    run_loss = [v for _, v in read_metrics(run_dir, "loss")]
    run_norm = [v for _, v in read_metrics(run_dir, "grad_norm")]
    check(len(run_loss) == DP_STEPS, f"the gloo run logged {len(run_loss)} losses (rank 0 alone, once a step)")
    k, errs = 0, []
    for epoch in range(DP_STEPS):
        for loader in shards:
            loader.set_epoch(epoch)
        for b0, b1 in zip(*shards):
            k += 1
            if k > DP_STEPS:
                break
            if k > 1:
                saved = torch.load(os.path.join(run_dir, "checkpoints", f"{k - 1}.pt"), map_location="cpu",
                                   weights_only=True)
                state.load_state_dict(saved)
            metrics = step(state, to_device({key: np.concatenate([b0[key], b1[key]]) for key in b0}, device))
            loss, norm = float(metrics["loss"]), float(metrics["grad_norm"])
            errs.append((abs(run_loss[k - 1] - loss) / abs(loss), abs(run_norm[k - 1] - norm) / norm))
    print(f"data parallel over 2 gloo ranks on {device} ({CONFIG}, global batch {cfg.train.batch}, "
          f"{per_rank} a rank, {DP_STEPS} steps, {secs:.2f} s with start-up) vs one process on the global "
          f"batch from the run's own state: per step (loss rel, grad norm rel) "
          + ", ".join(f"({a:.3e}, {b:.3e})" for a, b in errs) + f"; card {card}", flush=True)
    for a, b in errs:
        check(a <= DP_LOSS_REL and b <= DP_GRAD_NORM_REL, f"gloo data parallel vs one process: {a}, {b}")
    del model, state, step
    torch.cuda.empty_cache()

    # (b) NCCL, one rank, the graphed multi-step with its all_reduce inside
    backend = "nccl" if device.type == "cuda" else "gloo"  # gloo: a CPU rehearsal of this phase
    dist.init_process_group(backend, init_method=f"tcp://localhost:{_free_port()}", world_size=1, rank=0)
    try:
        mesh = make_mesh(1, 1, group=dist.group.WORLD)
        loader = DeviceDataLoader(data, cfg.train.batch, shuffle=True, drop_last=True, seed=SEED, device=device)
        idx2d = []
        for epoch in range(TS_GRAPH_STEPS):
            loader.set_epoch(epoch)
            idx2d += list(loader.index_batches())
        idx2d = np.stack(idx2d[:TS_GRAPH_STEPS])
        base = init_params(DDSPDecoder(**_full_kwargs()), torch.Generator().manual_seed(SEED + 50)).to(device)
        meta = read_meta(BUNDLE)
        runs = {}
        for label, m in (("no mesh", None), ("nccl", mesh)):
            model = copy.deepcopy(base)
            tx = make_optimizer(cfg)
            state = TrainState(0, model, tx.init(list(model.parameters())),
                               torch.Generator(device).manual_seed(SEED + 51),
                               meta["mean_loudness"], meta["std_loudness"])
            multi = make_train_multi_step_indexed(model, tx, cfg, TS_GRAPH_STEPS, 1, m)
            kernels.reset_counts()
            rows = multi(state, loader.device_data, idx2d).cpu()
            launched = _launches_and_replays()
            runs[label] = (rows, model, state.generator.get_state(), multi.captured, launched)
        (r0, m0, g0, _, _), (r1, m1, g1, captured, launched) = runs["no mesh"], runs["nccl"]
        bitwise = (torch.equal(r0, r1) and torch.equal(g0, g1)
                   and all(torch.equal(a, b) for a, b in zip(m0.parameters(), m1.parameters())))
        print(f"NCCL world size 1, graphed MultiStep ({TS_GRAPH_STEPS} steps, the all_reduce captured) vs no "
              f"mesh: losses {[round(float(v), 6) for v in r1[:, 0]]}; bitwise equal: {bitwise}; captured "
              f"{captured}; launches {launched}; card {card}", flush=True)
        check(bitwise, "NCCL graphed steps at world size 1 differ from the steps without a mesh")
        check(captured == train_launches(1), f"NCCL graph captured {captured}")
    finally:
        dist.destroy_process_group()
    del runs, base, loader
    torch.cuda.empty_cache()
    return launched


def phase_longform(device, card: str) -> int:
    """Phase 25: the violin bundle renders LONGFORM_VOICES voices of
    LONGFORM_FRAMES frames (60.07 s) of glides through LongFormSynthesizer on
    an in-process time = 4 mesh (decoder whole, the DSP and the 1 s reverb
    on the shards), against the unsharded render from the same generator:
    within LONGFORM_REL_OF_PEAK of its peak; seconds and realtime factor of
    two renders.  Returns the launches of one render."""
    model, meta = load_bundle(BUNDLE, device=device)
    mean, std = meta["mean_loudness"], meta["std_loudness"]
    pitch, loud = glide_controls(LONGFORM_VOICES, LONGFORM_FRAMES, model.block_size, model.sample_rate,
                                 seed=SEED + 40, mean_loudness=mean, std_loudness=std)
    f0 = torch.tensor(pitch[..., None], device=device)
    loudness = torch.tensor(loud[..., None], device=device)
    synth = LongFormSynthesizer(model, make_mesh(1, 4), mean_loudness=mean, std_loudness=std)
    secs = []
    for i in range(2):
        kernels.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        audio = synth.synthesize(f0, loudness, generator=torch.Generator(device).manual_seed(SEED + 41))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        launched = _launches_and_replays()
    with torch.no_grad():
        want = model({"pitch": f0, "loudness": (loudness - mean) / std},
                     generator=torch.Generator(device).manual_seed(SEED + 41))["signal"]
    peak = float(want.abs().max())
    err = float((audio - want).abs().max())
    duration = LONGFORM_FRAMES * model.block_size / model.sample_rate
    print(f"long-form ({LONGFORM_VOICES} voices x {duration:.2f} s, violin bundle, time = 4 mesh, reverb): "
          f"max|sharded-unsharded|={err:.3e} of peak {peak:.4f} ({err / peak:.3e}); render s "
          + ", ".join(f"{s:.3f}" for s in secs)
          + f" = {LONGFORM_VOICES * duration / min(secs):.1f}x realtime (voices x seconds a second); "
          f"launches {launched}; card {card}", flush=True)
    check(audio.shape == want.shape and bool(torch.isfinite(audio).all()), "long-form output")
    check(err <= LONGFORM_REL_OF_PEAK * peak, f"long-form vs unsharded {err / peak} of the peak")
    check(launched == {name: int(name in ("oscillator_fwd", "gru_fwd")) for name in kernels.MODEL_KERNELS},
          f"long-form launches {launched}")
    del model, audio, want
    torch.cuda.empty_cache()
    return launched["oscillator_fwd"]


def _bf16_gap(got, want, ref) -> dict:
    """The gap criterion's ratios (the constants above): mean and max err
    over mean and max gap, and mean |got − ref| over mean gap."""
    got, want, ref = (np.asarray(x, np.float64) for x in (got, want, ref))
    gap, err = np.abs(want - ref), np.abs(got - want)
    return {"mean": float(err.mean() / gap.mean()), "max": float(err.max() / gap.max()),
            "band": float(np.abs(got - ref).mean() / gap.mean()), "gap_mean": float(gap.mean())}


def _check_bf16_gap(r: dict, what: str, mean_bound: float = BF16_GAP_MEAN) -> None:
    check(r["gap_mean"] > 0 and r["mean"] <= mean_bound and r["max"] <= BF16_GAP_MAX
          and BF16_GAP_BAND[0] <= r["band"] <= BF16_GAP_BAND[1], f"{what}: bf16 gap criterion {r}")


def _model_as(model, dtype: str, device):
    """A copy of `model`'s parameters in a model of compute dtype `dtype`."""
    cfg_kw = {"hidden_size": model.hidden_size, "n_harmonic": model.n_harmonic, "n_bands": model.n_bands,
              "sample_rate": model.sample_rate, "block_size": model.block_size,
              "has_reverb": model.has_reverb, "dtype": dtype}
    name = "mfcc-autoencoder" if isinstance(model, DDSPAutoencoder) else "single-inst-decoder"
    other = load_model(name, cfg_kw)
    other.load_state_dict(model.state_dict())
    return other.to(device)


def phase_bf16_step(device, card: str) -> None:
    """Phase 26a: one bf16 train step at configs/config.yaml's full width
    (batch 16 x 375 frames) on the card against the same step on the CPU
    (plain paths), from init_params weights, glides and injected noise:
    the forward's signal by the gap criterion, the loss and the whole
    gradient likewise, the CPU's float32 step the reference; one launch of
    each kernel.  Then the same step with the bf16 reduced-precision
    reduction left on (the models' matmul_precision scope disabled, the
    global flag on): its difference from the scoped step, and a bf16 GEMM
    of the GRU's shapes timed both ways."""
    from ddsp_pytorch_tpu_torch.bench_step_breakdown import timed_loop
    from ddsp_pytorch_tpu_torch.models import decoder as decoder_module
    from ddsp_pytorch_tpu_torch.models import encoder as encoder_module
    from ddsp_pytorch_tpu_torch.training import train as train_module

    cfg = Config.from_yaml(CONFIG)
    kw = dict(cfg.model.kwargs)
    block, sr = kw["block_size"], kw["sample_rate"]
    b, frames = cfg.train.batch, cfg.n_frames
    meta = read_meta(BUNDLE)
    mean, std = meta["mean_loudness"], meta["std_loudness"]
    pitch, loud = glide_controls(b, frames, block, sr, seed=SEED + 30, mean_loudness=mean, std_loudness=std)
    rng = np.random.default_rng(SEED + 31)
    t = np.arange(frames * block) / sr
    sig = 0.3 * np.sin(2 * np.pi * 330.0 * t)[None] + 0.01 * rng.standard_normal((b, t.size))
    noise = rng.uniform(-1.0, 1.0, (b, frames, block)).astype(np.float32)
    batch = {"pitch": pitch[..., None], "loudness": loud[..., None], "sig": sig.astype(np.float32)}
    base = init_params(load_model(cfg.model.name, kw), torch.Generator().manual_seed(SEED))

    def run(model, dev):
        tb = {k: torch.tensor(v, device=dev) for k, v in batch.items()}
        nz = torch.tensor(noise, device=dev)
        f0, ld = tb["pitch"], (tb["loudness"] - mean) / std
        with torch.no_grad():
            signal = model({**tb, "loudness": ld}, noise=nz)["signal"]
            with matmul_precision():  # the NN's stages
                d = model.decoder
                stage = {"f0_mlp": d.f0_mlp(f0), "loudness_mlp": d.loudness_mlp(ld)}
                stage["gru"] = d.gru(torch.cat([stage["f0_mlp"], stage["loudness_mlp"]], -1))[0]
                stage["hidden"] = d(f0, ld)[0]
            stage["controls"] = model.frame_controls(f0, ld)[0]["harmonic_distribution"]
        kernels.reset_counts()
        loss, grads = loss_and_grads(model, tb, mean, std, cfg.train.scales, cfg.train.overlap, noise=nz)
        launched = (_launched("oscillator_fwd"), _launched("oscillator_bwd"))
        names = [n for n, _ in model.named_parameters()]
        check(all(g.dtype == torch.float32 for g in grads), "a bf16 step's gradient is not float32")
        return (signal.cpu().double().numpy(), float(loss),
                {n: g.detach().cpu().double() for n, g in zip(names, grads)},
                {k: v.float().cpu().numpy() for k, v in stage.items()}, launched)

    card_model = _model_as(base, "bfloat16", device)
    t0 = time.perf_counter()
    on_card = run(card_model, device)
    card_s = time.perf_counter() - t0
    launched = on_card[4]
    t0 = time.perf_counter()
    cpu = run(_model_as(base, "bfloat16", "cpu"), "cpu")
    cpu_s = time.perf_counter() - t0
    ref = run(_model_as(base, "float32", "cpu"), "cpu")
    stages = {k: _bf16_gap(on_card[3][k], cpu[3][k], ref[3][k]) for k in ref[3]}
    signal = _bf16_gap(on_card[0], cpu[0], ref[0])
    loss = _bf16_gap([on_card[1]], [cpu[1]], [ref[1]])
    whole, _, _ = _grad_errors(on_card[2], cpu[2])
    grad_gap, _, _ = _grad_errors(cpu[2], ref[2])
    print(f"bf16 train step card vs CPU (configs/config.yaml, batch {b} x {frames} frames, init_params "
          f"weights): loss card={on_card[1]:.7f} cpu bf16={cpu[1]:.7f} cpu f32={ref[1]:.7f}; stage gap ratios "
          f"{stages}; signal {signal}; loss {loss}; whole gradient rel L2 card vs cpu bf16={whole:.3e}, cpu "
          f"bf16 vs f32={grad_gap:.3e} (ratio {whole / grad_gap:.3f}); launches fwd={launched[0]} "
          f"bwd={launched[1]}; host s card={card_s:.2f} cpu={cpu_s:.2f}; card {card}", flush=True)
    check(np.isfinite(on_card[1]) and launched == (1, 1), f"bf16 card step: loss {on_card[1]}, launches {launched}")
    for k in BF16_STAGES_HELD:
        _check_bf16_gap(stages[k], f"bf16 {k} output, card vs CPU")
    # where the card and the CPU part: the same bf16 ops and GEMMs, card vs CPU
    g = torch.Generator().manual_seed(SEED)
    x = (3.0 * torch.randn(200000, generator=g)).to(torch.bfloat16)
    same = {name: float((fn(x) == fn(x.to(device)).cpu()).float().mean())
            for name, fn in (("exp", torch.exp), ("reciprocal", lambda v: torch.reciprocal(v.abs() + 0.5)),
                             ("tanh", torch.tanh), ("mul", lambda v: v * v.flip(0)))}
    for name, (m, k, n) in (("gemm_gru_input", (b * frames, 1024, 1536)), ("gemm_gru_frame", (b, 512, 1536))):
        a = torch.randn((m, k), generator=g).to(torch.bfloat16)
        w = (0.05 * torch.randn((k, n), generator=g)).to(torch.bfloat16)
        with matmul_precision():
            same[name] = float(((a @ w) == (a.to(device) @ w.to(device)).cpu()).float().mean())
    print(f"bf16 card vs CPU, share of equal outputs: {same}; stages held to the gap criterion: "
          f"{BF16_STAGES_HELD}; card {card}", flush=True)
    _check_bf16_gap(signal, "bf16 step signal, card vs CPU", BF16_CARD_MEAN)
    _check_bf16_gap(loss, "bf16 step loss, card vs CPU", BF16_CARD_MEAN)
    check(whole <= STEP_GRAD_REL, f"bf16 step whole gradient card vs CPU rel L2 {whole} > {STEP_GRAD_REL}")

    # the reduced-precision reduction left on: no scope, the global flag on
    def unscoped():
        return contextlib.nullcontext()

    scoped = {m: m.matmul_precision for m in (decoder_module, encoder_module, train_module)}
    matmul = torch.backends.cuda.matmul
    previous = matmul.allow_bf16_reduced_precision_reduction
    try:
        matmul.allow_bf16_reduced_precision_reduction = True
        for m in scoped:
            m.matmul_precision = unscoped
        left_on = run(card_model, device)
    finally:
        for m, f in scoped.items():
            m.matmul_precision = f
        matmul.allow_bf16_reduced_precision_reduction = previous
    on_whole, _, _ = _grad_errors(left_on[2], on_card[2])
    bitwise = (np.array_equal(left_on[0], on_card[0]) and left_on[1] == on_card[1]
               and all(torch.equal(left_on[2][n], on_card[2][n]) for n in on_card[2]))
    gemm = {}
    g = torch.Generator(device).manual_seed(SEED)
    for name, (m, k, n) in (("gru_frame", (b, 512, 1536)), ("gru_input", (b * frames, 1024, 1536)),
                            ("mlp", (b * frames, 512, 512))):
        x = torch.randn((m, k), generator=g, device=device).to(torch.bfloat16)
        w = torch.randn((k, n), generator=g, device=device).to(torch.bfloat16)
        for flag in (False, True, False, True):  # in turns
            matmul.allow_bf16_reduced_precision_reduction = flag
            gemm.setdefault(f"{name}_{'on' if flag else 'off'}_us", []).append(
                1e6 * timed_loop(lambda: x @ w, 50, device))
    matmul.allow_bf16_reduced_precision_reduction = previous
    print(f"bf16 step with allow_bf16_reduced_precision_reduction left on (no scope): bitwise equal to "
          f"the scoped step: {bitwise}; loss {left_on[1]:.7f} vs {on_card[1]:.7f}; whole gradient rel L2 "
          f"{on_whole:.3e}; max|signal diff| {float(np.abs(left_on[0] - on_card[0]).max()):.3e}; bf16 GEMM "
          f"device us (off, on, in turns) {gemm}; card {card}", flush=True)
    del card_model
    torch.cuda.empty_cache()


def phase_bf16_fit(device, cache: str, tmp: str, card: str) -> tuple:
    """Phase 26b, with the kernel counts set to 0 just before it: Trainer.fit
    for N_BF16_STEPS steps at configs/config.yaml with model.kwargs.dtype
    bfloat16 on the violin-rendered cache (as phase 5b): losses finite, the
    loss falls by LOSS_FALL_FACTOR, one forward and one backward launch a
    step (and a forward an eval), float32 parameters.  Returns ((forward,
    backward launches), the run directory)."""
    cfg = Config.from_yaml(CONFIG)
    cfg.apply_overrides([
        f"preprocess.out_dir={cache}", f"train.steps={N_BF16_STEPS}", "model.kwargs.dtype=bfloat16",
        "train.val_interval_epochs=10", "train.log_interval_epochs=10",
        "train.checkpoint_every_steps=0", "train.metrics_flush_steps=10",
    ])
    dm = Datamodule(cfg)
    dm.setup()
    run_dir = os.path.join(tmp, "run_bf16")
    trainer = Trainer(cfg, run_dir, device=device)
    check(trainer.model.compute_dtype == torch.bfloat16, "the bf16 config built a float32 model")
    kernels.reset_counts()
    t0 = time.perf_counter()
    state = trainer.fit(dm)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fwd, bwd = _launched("oscillator_fwd"), _launched("oscillator_bwd")
    trainer.close()
    dtypes = {p.dtype for p in state.model.parameters()} | {t.dtype for t in tree_leaves(state.opt_state)}
    losses = [v for _, v in read_metrics(run_dir, "loss")]
    skipped = [v for _, v in read_metrics(run_dir, "update_skipped")]
    first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    print(f"bf16 training: {state.step} steps (batch {cfg.train.batch} x {cfg.n_frames} frames) in "
          f"{fit_s:.2f} s; loss first5={first5:.5f} last5={last5:.5f} factor={first5 / last5:.4f}; "
          f"launches fwd={fwd} bwd={bwd} eval_forwards={trainer.eval_forwards}; parameter and optimizer "
          f"state dtypes {sorted(map(str, dtypes))}; card {card}", flush=True)
    print("bf16 loss curve: " + " ".join(f"{v:.5f}" for v in losses), flush=True)
    check(state.step == N_BF16_STEPS and len(losses) == N_BF16_STEPS, "bf16 steps run")
    check(all(np.isfinite(losses)) and sum(skipped) == 0, "bf16 run: a loss not finite or a skip")
    check(first5 >= LOSS_FALL_FACTOR * last5,
          f"bf16 run: loss did not fall by {LOSS_FALL_FACTOR}x: first5 {first5} last5 {last5}")
    check(bwd == N_BF16_STEPS and fwd == N_BF16_STEPS + trainer.eval_forwards,
          f"bf16 run launched fwd {fwd}, bwd {bwd} in {N_BF16_STEPS} steps")
    check(torch.bfloat16 not in dtypes and torch.float32 in dtypes, f"bf16 run state dtypes {dtypes}")
    del trainer, state, dm
    torch.cuda.empty_cache()
    return (fwd, bwd), run_dir


def phase_bf16_export_serve(device, run_dir: str, cache: str, tmp: str, card: str) -> int:
    """Phase 26d: export_run of the bf16 run (meta.json says bfloat16), its
    bundle streamed N_BLOCKS blocks on the card against the CPU plain stream
    by the gap criterion (the same parameters streamed in float32 on the CPU
    the reference), one launch a block; then one VoicePool step of two
    voices.  Returns oscillator_fwd's launches while serving."""
    bundle = export_run(run_dir, os.path.join(tmp, "export_bf16"), name="bf16", device=device)
    meta = read_meta(bundle)
    check(meta["model"]["kwargs"].get("dtype") == "bfloat16", f"bf16 bundle meta {meta['model']}")
    gpu = make_streaming_synth(bundle, device=device, noise_deterministic=True)
    cpu = make_streaming_synth(bundle, device="cpu", noise_deterministic=True)
    ref = StreamingSynth(_model_as(cpu.model, "float32", "cpu"), meta["mean_loudness"],
                         meta["std_loudness"], noise_deterministic=True, device="cpu")
    check(gpu.model.compute_dtype == torch.bfloat16 and ref.model.compute_dtype is None, "bf16 bundle models")
    block = gpu.block_size
    pitch, loud = (np.repeat(np.load(os.path.join(cache, "train", f"{name}.npy"))[:1, :N_BLOCKS], block, axis=1)
                   for name in ("pitchs", "loudness"))
    gpu.step_samples(pitch[:, :block], loud[:, :block])  # warm-up on a throwaway state
    gpu.reset()
    kernels.reset_counts()
    streams = {name: [] for name in ("gpu", "cpu", "ref")}
    for i in range(N_BLOCKS):
        sl = slice(i * block, (i + 1) * block)
        for name, synth in (("gpu", gpu), ("cpu", cpu), ("ref", ref)):
            streams[name].append(synth.step_samples(pitch[:, sl], loud[:, sl]).cpu().numpy())
    streamed = _launched("oscillator_fwd")
    got, want, f32 = (np.concatenate(streams[n], axis=-1) for n in ("gpu", "cpu", "ref"))
    gap = _bf16_gap(got, want, f32)
    pool = VoicePool(make_streaming_synth(bundle, batch=2, device=device))
    slots = [pool.acquire(), pool.acquire()]
    before = _launched("oscillator_fwd")
    rows = pool.step({s: (pitch[0, :block:block, None], loud[0, :block:block, None]) for s in slots})
    pooled = _launched("oscillator_fwd") - before
    print(f"bf16 bundle {os.path.basename(bundle)} (meta dtype {meta['model']['kwargs']['dtype']}): "
          f"{N_BLOCKS} blocks card vs CPU gap ratios {gap} (peak {float(np.abs(got).max()):.3e}); "
          f"stream carry dtype {gpu.state.gru.dtype}; launches {streamed}; VoicePool(2) step: "
          f"{pooled} launch, rows {[r.shape for r in rows.values()]}; card {card}", flush=True)
    check(got.shape == (1, N_BLOCKS * block) and bool(np.isfinite(got).all()), "bf16 bundle stream")
    _check_bf16_gap(gap, "bf16 bundle stream, card vs CPU", BF16_CARD_MEAN)
    check(gpu.state.gru.dtype == torch.float32, "the bf16 stream's carry is not float32")
    check(streamed == N_BLOCKS and pooled == 1, f"bf16 serving launched {streamed}, {pooled}")
    check(all(r.shape == (block,) and np.isfinite(r).all() for r in rows.values()), "bf16 pool rows")
    return streamed + pooled


def phase_bf16_autoencoder_step(device, card: str) -> tuple:
    """Phase 26e: one mfcc-autoencoder train step in bf16 at
    configs/autoencoder.yaml's full width (batch 16 x 375 frames) on the
    card, from init_params weights: a finite loss, float32 gradients, one
    launch of each kernel; the float32 step from the same weights beside it.
    Returns (forward, backward launches)."""
    cfg = Config.from_yaml(AE_CONFIG)
    b, frames = cfg.train.batch, cfg.n_frames
    block, sr = cfg.preprocess.block_size, cfg.preprocess.sample_rate
    pitch, loud = glide_controls(b, frames, block, sr, seed=SEED + 40)
    rng = np.random.default_rng(SEED + 41)
    t = np.arange(frames * block) / sr
    batch = {"pitch": torch.tensor(pitch[..., None], device=device),
             "loudness": torch.tensor(loud[..., None], device=device),
             "mfcc": torch.tensor((10.0 * rng.standard_normal((b, frames, 30))).astype(np.float32), device=device),
             "sig": torch.tensor((0.3 * np.sin(2 * np.pi * 330.0 * t)[None]
                                  + 0.01 * rng.standard_normal((b, t.size))).astype(np.float32), device=device)}
    noise = torch.tensor(rng.uniform(-1.0, 1.0, (b, frames, block)).astype(np.float32), device=device)
    base = init_params(load_model(cfg.model.name, cfg.model.kwargs), torch.Generator().manual_seed(SEED))
    out = {}
    for dtype in ("bfloat16", "float32"):
        model = _model_as(base, dtype, device)
        kernels.reset_counts()
        loss, grads = loss_and_grads(model, batch, -7.9, 0.55, cfg.train.scales, cfg.train.overlap, noise=noise)
        out[dtype] = (float(loss), float(global_norm(grads)), all(g.dtype == torch.float32 for g in grads),
                      all(bool(torch.isfinite(g).all()) for g in grads),
                      (_launched("oscillator_fwd"), _launched("oscillator_bwd")))
    print(f"bf16 autoencoder train step ({AE_CONFIG}, batch {b} x {frames} frames): (loss, grad norm, "
          f"grads float32, grads finite, launches) bf16 {out['bfloat16']}, float32 {out['float32']}; "
          f"card {card}", flush=True)
    loss, _, f32, finite, launched = out["bfloat16"]
    check(np.isfinite(loss) and f32 and finite and launched == (1, 1), f"bf16 AE step {out['bfloat16']}")
    return launched


def phase_bf16(device, cache: str, tmp: str, card: str, f32_graphed: dict) -> dict:
    """Phase 26: the bf16 model dtype on the card (26a-e).  Returns the
    launches of its paths for the report."""
    phase_bf16_step(device, card)
    (fit_fwd, fit_bwd), run_dir = phase_bf16_fit(device, cache, tmp, card)
    kernels.reset_counts()
    graphed = phase_graphed_vs_eager(device, cache, card, dtype="bfloat16", unrolls=(1,))
    graphed_counts = {name: n for name, n in _launches_and_replays().items() if name.startswith("oscillator")}
    print(f"ms per graphed step (U = 1) at configs/config.yaml: bfloat16 {graphed[1]['step_ms']:.3f}, "
          f"float32 {f32_graphed[1]['step_ms']:.3f} (phase 6), bf16/f32 "
          f"{graphed[1]['step_ms'] / f32_graphed[1]['step_ms']:.4f}; eager bfloat16 "
          f"{graphed['eager_step_ms']:.3f}, float32 {f32_graphed['eager_step_ms']:.3f}; card {card}", flush=True)
    serving = phase_bf16_export_serve(device, run_dir, cache, tmp, card)
    ae = phase_bf16_autoencoder_step(device, card)
    return {"fit": {"oscillator_fwd": fit_fwd, "oscillator_bwd": fit_bwd}, "graphed": graphed_counts,
            "serving": serving, "autoencoder_step": {"oscillator_fwd": ae[0], "oscillator_bwd": ae[1]}}


def phase_benchmarks(device, card: str) -> None:
    """Phase 27: the repository's benchmark scripts on the port, each line
    with the card's name and power limit: bench_headline's five configs
    (reps cut to BENCH_REPS_SCALE), bench_step_breakdown at
    BREAKDOWN_BATCH with its ceilings and bf16 verdict (BREAKDOWN_ITERS
    iterations a stage), bench_scaling at world size 1."""
    cut = {n: max(1, round(r * BENCH_REPS_SCALE)) for n, r in bench_headline.REPS.items()}
    print(f"bench_headline: reps cut to {BENCH_REPS_SCALE} of the JAX script's {bench_headline.REPS}: {cut}; "
          f"card {card}", flush=True)
    lines = bench_headline.main(["--configs", "1,2,3,4,5", "--reps-scale", str(BENCH_REPS_SCALE)])
    check([x["config"] for x in lines] == [1, 2, 3, 4, 5], "bench_headline lines")
    for x in lines:
        times = [v for k, v in x.items() if k in ("ms", "ms_per_call", "ms_per_step")]
        check(len(times) == 1 and np.isfinite(times[0]) and times[0] > 0, f"bench_headline line {x}")
    check(lines[0]["device"] == "cpu" and all(x["card"] == card for x in lines[1:]), "bench_headline devices")
    check(lines[2]["step"] == lines[3]["step"] == "graphed", "bench_headline's training lines not graphed")
    print(f"bench_step_breakdown: batch {BREAKDOWN_BATCH}, {BREAKDOWN_ITERS} iterations a stage (the JAX "
          f"script's 20 cut); card {card}", flush=True)
    ceilings = bench_step_breakdown.measure_ceilings(device)
    print(json.dumps({"step_breakdown_ceilings": ceilings, "card": card}), flush=True)
    entry = bench_step_breakdown.batch_entry(BREAKDOWN_BATCH, BREAKDOWN_ITERS, device)
    print(json.dumps({"step_breakdown": {str(BREAKDOWN_BATCH): entry}, "card": card}), flush=True)
    print(f"bf16 verdict at batch {BREAKDOWN_BATCH}: full step float32 {entry['stages_ms']['full_step']:.3f} "
          f"ms, bfloat16 {entry['full_step_ms_bf16']:.3f} ms (speed-up {entry['bf16_speedup_full_step']:.4f}); "
          f"GRU stage float32 {entry['stages_ms']['gru_controls']:.3f} ms, bfloat16 {entry['gru_ms_bf16']:.3f} "
          f"ms (speed-up {entry['bf16_speedup_gru']:.4f}); card {card}", flush=True)
    check(all(np.isfinite(v) and v > 0 for v in [*ceilings.values(), *entry["stages_ms"].values(),
                                                 entry["full_step_ms_bf16"], entry["gru_ms_bf16"]]),
          "a step-breakdown number is not finite")
    payload = bench_scaling.main(["--world-sizes", "1"])
    (r,) = payload["results"]
    print(f"bench_scaling: world size 1 ({r['backend']}, {r['step']}) {r['step_ms']:.3f} ms a step, "
          f"{r['samples_per_s']:.1f} samples/s; {payload['note']}; card {card}", flush=True)
    check(r["backend"] == "nccl" and r["efficiency"] == 1.0 and np.isfinite(r["step_ms"]), "bench_scaling")


def _child_launches(path: str) -> dict:
    """{kernel: launches + replays} summed over the child processes that
    appended their counts to `path` (ops/kernels COUNTS_FILE_ENV)."""
    total = {name: 0 for name in kernels.MODEL_KERNELS}
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                for name, c in json.loads(line)["counts"].items():
                    total[name] += c["launches"] + c["replayed"]
    return total


@contextlib.contextmanager
def _counted_children(path: str):
    """Child processes started inside append their kernel counts to `path`
    (emptied first); yields a function that sums them."""
    if os.path.exists(path):
        os.remove(path)
    os.environ[kernels.COUNTS_FILE_ENV] = path
    try:
        yield lambda: _child_launches(path)
    finally:
        del os.environ[kernels.COUNTS_FILE_ENV]


def phase_trainrun(device, card: str, tmp: str) -> dict:
    """Phase 28a: the trainrun rehearsal on the card.  Returns its children's
    launches."""
    root = os.path.join(tmp, "runs")
    with _counted_children(os.path.join(tmp, "trainrun_counts.jsonl")) as launched:
        t0 = time.perf_counter()
        report = trainrun.main(["--device", str(device), "--steps", str(TRAINRUN_STEPS), "--segment-schedule",
                                TRAINRUN_SCHEDULE, "--steps-per-call", str(TRAINRUN_SPC), "--root", root,
                                "--out", os.path.join(tmp, "trainrun.json")])
        secs = time.perf_counter() - t0
        counts = launched()
    run_dir = os.path.join(root, "runs", trainrun.RUN_NAME)
    with open(os.path.join(run_dir, "segments.jsonl")) as f:
        segs = [json.loads(line) for line in f]
    losses = [v for _, v in read_metrics(run_dir, "loss")]
    with open("TRAINRUN_r05.json") as f:
        tpu_keys = set(json.load(f))
    print(json.dumps({"phase": "trainrun_rehearsal", "seconds": round(secs, 3), "card": card, "segments": segs,
                      "per_segment": report["per_segment"], "loss_first10_mean": report["loss_first10_mean"],
                      "loss_last100_mean": report["loss_last100_mean"], "final_val_loss": report["final_val_loss"],
                      "sustained_steps_per_s_train_segments": report["sustained_steps_per_s_train_segments"],
                      "launches_in_children": counts}), flush=True)
    bounds = [0, *np.cumsum([int(n) for n in TRAINRUN_SCHEDULE.split(",")]).tolist()]
    check(all(s["returncode"] == 0 for s in segs) and [s["to_step"] for s in segs] == bounds,
          f"trainrun segments {segs}")
    check(len(losses) == TRAINRUN_STEPS and all(np.isfinite(losses)), "trainrun losses not finite")
    check(np.mean(losses[-20:]) < np.mean(losses[:20]), "trainrun loss did not fall")
    check(np.isfinite(report["final_val_loss"]), "trainrun validation loss")
    check(set(report) == tpu_keys | {"card"} and report["card"] == card, "trainrun report keys")
    for row in report["per_segment"]:
        warm = WARMUP_RUNS * 1  # scan_unroll 1
        check(row["kernel_replayed"] == train_launches(1, row["steps"])
              and row["kernel_launches"] == train_launches(1, warm),
              f"trainrun segment launches {row['kernel_launches']}, replayed {row['kernel_replayed']}")
    return counts


def phase_ceiling(device, card: str, tmp: str) -> dict:
    """Phase 28b: the ceiling sweep on the card (CEILING_CONFIGS, the
    trainrun's corpus and cache reused).  Returns its children's launches."""
    with _counted_children(os.path.join(tmp, "ceiling_counts.jsonl")) as launched:
        t0 = time.perf_counter()
        report = ceiling_probe.main(["--device", str(device), "--configs", CEILING_CONFIGS, "--probe-steps",
                                     str(CEILING_PROBE_STEPS), "--root", os.path.join(tmp, "runs"),
                                     "--out", os.path.join(tmp, "ceiling.json")])
        secs = time.perf_counter() - t0
        counts = launched()
    for row in report["rows"]:
        print(f"ceiling spc={row['steps_per_call']} u={row['unroll']}: {row['status']}, "
              f"{row['steps_per_s_wall']} steps/s over the child's wall clock, "
              f"{row['steps_per_s_train_window']} over its train window (steady {row['steady_ms_per_step']} "
              f"ms a step), capture {row['graph_capture_s']} s, peak {row['max_memory_allocated_bytes']} B, "
              f"SM {row.get('sm_clock_mhz_start')}-{row.get('sm_clock_mhz_end')} MHz, launches "
              f"{row['kernel_launches']}, replayed {row['kernel_replayed']}; card {card}", flush=True)
    print(json.dumps({"phase": "ceiling_sweep", "seconds": round(secs, 3), "prime_wall_s": report["prime_wall_s"],
                      "launches_in_children": counts, "card": card}), flush=True)
    check([(r["steps_per_call"], r["unroll"], r["status"]) for r in report["rows"]]
          == [(spc, u, "ok") for spc, u in ceiling_probe.parse_configs(CEILING_CONFIGS)],
          f"ceiling rows {report['rows']}")
    for row in report["rows"]:
        n = row["measured_steps"]
        check(row["steps_per_s_wall"] > 0 and row["steps_per_s_train_window"] > row["steps_per_s_wall"],
              f"ceiling rates {row}")
        fwd = row["kernel_launches"]["oscillator_fwd"] + row["kernel_replayed"]["oscillator_fwd"]
        bwd = row["kernel_launches"]["oscillator_bwd"] + row["kernel_replayed"]["oscillator_bwd"]
        extra = WARMUP_RUNS * row["unroll"] if row["steps_per_call"] > 1 else 0
        check(fwd == bwd == n + extra, f"ceiling child launches {fwd}, {bwd} for {n} steps")
    return counts


def phase_e2e(device, card: str, tmp: str) -> dict:
    """Phase 28c: the CLI journey on the card.  Returns its children's
    launches."""
    with _counted_children(os.path.join(tmp, "e2e_counts.jsonl")) as launched:
        secs = e2e_smoke.main(["--device", str(device)])
        counts = launched()
    print(json.dumps({"phase": "e2e_journey", "seconds": {k: round(v, 3) for k, v in secs.items()},
                      "launches_in_children": counts, "card": card}), flush=True)
    check(list(secs) == ["preprocess", "train", "export", "transfer", "performance"], "e2e steps")
    return counts


def _crepe_gap(got, want, ref, what: str, card: str) -> dict:
    r = _bf16_gap(got, want, ref)
    bitwise = float((np.asarray(got) == np.asarray(want)).mean())
    print(f"CREPE bf16 {what}: card vs CPU bf16 mean err {r['mean']:.4f} of the mean bf16-f32 gap "
          f"({r['gap_mean']:.3e}), max err {r['max']:.4f} of the max gap, the card {r['band']:.4f} gaps from "
          f"float32, {bitwise:.4f} of the logits bit for bit; card {card}", flush=True)
    _check_bf16_gap(r, f"CREPE bf16 {what}")
    return r


def phase_crepe_bf16(device, card: str) -> None:
    """Phase 28d: CREPE(dtype="bfloat16"), the shipped tiny, on the card
    against the CPU's bf16 plain path, the CPU's float32 the reference: eval
    mode on CREPE_BF16_FRAMES frames of a glide with pink noise, train mode
    on CREPE_BF16_BATCH of them with the same dropout masks (and the running
    statistics it moves)."""
    hop = 160
    x16, _ = _pink_glide(crepe.MODEL_SRATE, (CREPE_BF16_FRAMES - 1) * hop, 31, 110.0, 880.0, -20.0)
    pad = crepe.FRAME_LENGTH // 2
    idx = np.arange(CREPE_BF16_FRAMES)[:, None] * hop + np.arange(crepe.FRAME_LENGTH)[None, :]
    frames = torch.tensor(np.pad(x16, (pad, pad))[idx])
    shipped = crepe.load_crepe(CREPE_PARAMS, device="cpu").state_dict()

    def model(dtype, dev):
        m = crepe.CREPE("tiny", dtype=dtype)
        m.load_state_dict(shipped)
        return m.to(dev)

    gen = torch.Generator().manual_seed(SEED + 28)
    masks = [torch.rand(shape, generator=gen) < 1.0 - crepe.DROPOUT_RATE
             for shape in crepe.CREPE("tiny").block_shapes(CREPE_BF16_BATCH)]
    batch = frames[:CREPE_BF16_BATCH]
    with torch.inference_mode():
        ref = model("float32", "cpu")(frames)
        want = model("bfloat16", "cpu")(frames)
        on_card = model("bfloat16", device)
        got = on_card(frames.to(device)).cpu()
        check(got.dtype == torch.float32 and bool(torch.isfinite(got).all()), "CREPE bf16 logits")
        _crepe_gap(got, want, ref, f"eval, {CREPE_BF16_FRAMES} frames", card)
        runs = {}
        for name, dtype, dev in (("f32", "float32", "cpu"), ("cpu", "bfloat16", "cpu"), ("card", "bfloat16", device)):
            m = model(dtype, dev)
            out = m(batch.to(dev), train=True, dropout_masks=[k.to(dev) for k in masks]).cpu()
            runs[name] = (out, {k: v.cpu() for k, v in m.state_dict().items() if k.endswith(("running_mean",
                                                                                            "running_var"))})
    (ref_t, _), (want_t, stats_cpu), (got_t, stats_card) = runs["f32"], runs["cpu"], runs["card"]
    _crepe_gap(got_t, want_t, ref_t, f"train mode, batch {CREPE_BF16_BATCH}, injected masks", card)
    stats_err = max(float((stats_card[k] - stats_cpu[k]).abs().max() / stats_cpu[k].abs().max()) for k in stats_cpu)
    print(f"CREPE bf16 train mode: running statistics card vs CPU within {stats_err:.3e} of their largest "
          f"magnitude; float32 parameters: {all(p.dtype == torch.float32 for p in on_card.parameters())}; "
          f"card {card}", flush=True)
    check(all(p.dtype == torch.float32 for p in on_card.parameters()), "CREPE bf16 parameters")


def phase_sanitizers(card: str) -> None:
    """Phase 28e: the engine's unit tests built under ThreadSanitizer and
    under AddressSanitizer + UBSan on this host: every test passes and no
    sanitizer report."""
    for sanitize, (_, name, flags) in sorted(runtime.SANITIZERS.items()):
        t0 = time.perf_counter()
        rc, out, run_s = runtime.run_binary(name, timeout=300)
        reports = [r for r in runtime.SANITIZER_REPORTS if r in out]
        print(f"{name} ({' '.join(flags)}): exit {rc}, built and run in {time.perf_counter() - t0:.2f} s "
              f"(run {run_s:.2f} s) on the host of card {card}, reports {reports}: "
              + " | ".join(out.strip().splitlines()[-2:]), flush=True)
        check(rc == 0 and "stream_test: PASS (5 tests)" in out and not reports, f"{name}:\n{out}")


def phase_run_tools(device, card: str) -> dict:
    """Phase 28: the run-level tools (see the module docstring).  Returns
    {path: {kernel: launches}} of its child processes."""
    torch.cuda.empty_cache()  # the children share the card with this process
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="ddsp_chip_smoke_runs_") as tmp:
        launches = {"trainrun": phase_trainrun(device, card, tmp), "ceiling": phase_ceiling(device, card, tmp),
                    "e2e_journey": phase_e2e(device, card, tmp)}
    phase_crepe_bf16(device, card)
    phase_sanitizers(card)
    for path, counts in launches.items():
        check(all(n > 0 for n in counts.values()), f"a kernel was not launched on the {path} path: {counts}")
    print(f"phase 28 (run-level tools) seconds={time.perf_counter() - t0:.1f}; card {card}", flush=True)
    return launches


def _oracle_f64(f0_frames, amp_frames, block: int, sr: int) -> np.ndarray:
    """The literal sample-rate bank in float64 (tests/test_oscillator.py:22-28)."""
    f0 = np.repeat(np.asarray(f0_frames, np.float64), block, axis=1)
    amp = np.repeat(np.asarray(amp_frames, np.float64), block, axis=1)
    omega = np.cumsum(2 * np.pi * f0 / sr, axis=1)
    return (np.sin(omega[..., None] * np.arange(1, amp.shape[-1] + 1)) * amp).sum(-1)


def phase_public_ops(device, card: str) -> int:
    """Phase 29a: upsample, resample, harmonic_synth and amplitude_to_db on
    the card against the same calls on the CPU (harmonic_synth also against
    the float64 oracle), then init_stream_state feeding one
    StreamingSynth.step of the violin bundle (noise on), equal bit for bit
    to a step from fresh_state.  Returns its forward launches."""
    rng = np.random.default_rng(SEED + 29)
    x = torch.tensor(rng.standard_normal((4, 128, 3)).astype(np.float32))
    up = ops.upsample(x.to(device), 512).cpu()
    check(torch.equal(up, ops.upsample(x, 512)), "upsample card vs CPU")
    got, want = ops.resample(x.to(device), 64).cpu(), ops.resample(x, 64)
    res_err = float((got - want).abs().max())
    check(torch.allclose(got, want, rtol=OPS_RESAMPLE_RTOL, atol=OPS_RESAMPLE_ATOL), f"resample card vs CPU {res_err}")
    b, f, k, block, sr = 2, 25, 8, 64, 16000
    f0 = rng.uniform(100, 400, (b, f)).astype(np.float32)
    amp = (rng.random((b, f, k)) / k).astype(np.float32)
    f0_up, amp_up = ops.upsample(torch.tensor(f0)[..., None], block), ops.upsample(torch.tensor(amp), block)
    t0 = time.perf_counter()
    on_card = ops.harmonic_synth(f0_up.to(device), amp_up.to(device), sr)
    _sync(device)
    synth_s = time.perf_counter() - t0
    on_card, on_cpu = on_card.cpu()[..., 0].numpy(), ops.harmonic_synth(f0_up, amp_up, sr)[..., 0].numpy()
    oracle = _oracle_f64(f0, amp, block, sr)
    synth_err = (float(np.abs(on_card - on_cpu).max()), float(np.abs(on_card - oracle).max()))
    check(synth_err[0] <= OPS_ORACLE_ATOL and synth_err[1] <= OPS_ORACLE_ATOL
          and float(np.abs(on_cpu - oracle).max()) <= OPS_ORACLE_ATOL, f"harmonic_synth errors {synth_err}")
    mag = torch.tensor(np.abs(rng.standard_normal((2, 513, 94))).astype(np.float32))
    db_err = float((ops.amplitude_to_db(mag.to(device)).cpu() - ops.amplitude_to_db(mag)).abs().max())
    check(db_err <= OPS_DB_ATOL, f"amplitude_to_db card vs CPU {db_err}")

    synth = make_streaming_synth(BUNDLE, batch=2, seed=29, device=device)
    glide_f0 = np.linspace(220.0, 440.0, 2 * 8, dtype=np.float32).reshape(2, 8, 1)
    loud = np.full((2, 8, 1), -3.0, np.float32)
    kernels.reset_counts()
    synth.state = init_stream_state(synth.model.hidden_size, 2, 29, device=device)
    a = synth.step(glide_f0, loud)
    synth.reset(29)
    b_ = synth.step(glide_f0, loud)
    launches = _launched("oscillator_fwd")
    check(torch.equal(a, b_) and float(a.abs().max()) > 0, "init_stream_state step != fresh_state step")
    print(f"public ops on the card vs the CPU: upsample bit for bit, resample max |err| {res_err:.3e}, "
          f"harmonic_synth (B 2, T 1600, K 8) {synth_err[0]:.3e} from the CPU and {synth_err[1]:.3e} from the "
          f"float64 oracle ({1e3 * synth_s:.3f} ms), amplitude_to_db {db_err:.3e}; init_stream_state's step "
          f"equals fresh_state's bit for bit (peak {float(a.abs().max()):.4f}); forward launches {launches}; "
          f"card {card}", flush=True)
    return launches


def phase_voice_ramp(device, card: str, tmp: str) -> int:
    """Phase 29b: voice_ramp at its defaults (pool 32, V = 1 … 32) and at
    one wider pool (1024; V = 32, 128, 512, 1024), each report printed
    whole.  Returns their forward launches (one a pool step)."""
    kernels.reset_counts()
    reports = {}
    for name, extra in (("defaults", []), ("pool_1024", WIDE_RAMP)):
        t0 = time.perf_counter()
        reports[name] = voice_ramp_cli.main(["--device", str(device), *extra,
                                             "--out", os.path.join(tmp, f"voice_ramp_{name}.json")])
        print(json.dumps({"phase": f"voice_ramp_{name}", "seconds": round(time.perf_counter() - t0, 3),
                          "report": reports[name]}), flush=True)
    launches = _launched("oscillator_fwd")
    with open("pretrained/voice_ramp_cpu.json") as f:
        record = json.load(f)
    steps = 0
    for name, report in reports.items():
        check(set(report) == set(record) | {"card"} and report["card"] == card, f"voice ramp {name} keys")
        check(all(set(r) == set(record["rows"][0]) and r["block_ms_best"] > 0 for r in report["rows"]),
              f"voice ramp {name} rows")
        steps += len(report["rows"]) * (1 + 6)
    check(launches == steps, f"voice ramp: {launches} forward launches for {steps} pool steps")
    return launches


def phase_bench_reference(device, card: str, tmp: str) -> int:
    """Phase 29c: bench_reference on the card, both configs' rows printed.
    Returns the port side's forward launches (one a call)."""
    kernels.reset_counts()
    t0 = time.perf_counter()
    report = bench_reference.main(["--device", str(device), "--out", os.path.join(tmp, "bench_reference.json")])
    launches = _launched("oscillator_fwd")
    with open("REFBENCH_r05.json") as f:
        record = json.load(f)
    for row in report["configs"]:
        print(json.dumps({"phase": "bench_reference", "row": row, "card": card}), flush=True)
    print(f"bench_reference: {time.perf_counter() - t0:.1f} s; forward launches {launches}", flush=True)
    check(set(report) == set(record) | {"card"} and report["card"] == card, "bench_reference keys")
    for row in report["configs"]:
        check(set(row) - {"ours_cuda", "speedup_same_cuda"} == set(record["configs"][0])
              - {"ours_cpu", "speedup_same_cpu"} and row["ours_cuda"]["mean_ms"] > 0
              and row["torch_reference"]["mean_ms"] > 0, f"bench_reference row {row['name']}")
    calls = len(report["configs"]) * (1 + report["n_run"] * report["protocol_runs"])
    check(launches == calls, f"bench_reference: {launches} forward launches for {calls} calls")
    return launches


def phase_last_modules(device, card: str) -> dict:
    """Phase 29: the last modules of the JAX package on the card (see the
    module docstring).  Returns {path: forward launches}."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="ddsp_chip_smoke_last_") as tmp:
        launches = {"init_stream_state": phase_public_ops(device, card),
                    "voice_ramp": phase_voice_ramp(device, card, tmp),
                    "bench_reference": phase_bench_reference(device, card, tmp)}
    check(all(n > 0 for n in launches.values()), f"oscillator_fwd not launched on a phase 29 path: {launches}")
    print(f"phase 29 (the last modules) seconds={time.perf_counter() - t0:.1f}; card {card}", flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    # parity settings: full-precision f32 matmuls and convolutions; bf16
    # GEMMs keep PyTorch's default (reduced-precision split-K reductions
    # allowed), set here so that the models' own scope (models/decoder.py
    # matmul_precision) is what turns it off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
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
        if not log:  # its source built under another name (gru_fwd.cu's probe, roofline_sin)
            continue
        print(f"built {name} in {secs:.2f} s", flush=True)
        check_spills(name, log)

    kernel_ms = {}
    fwd_entry = phase_kernels(device, kernel_ms)
    bwd_entry = phase_bwd_kernel(device, kernel_ms)
    gru_entries = phase_gru_kernels(device)
    stft_entries = phase_stft_loss_kernels(device)
    adam_entries = phase_adam_kernel(device)
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
        f32_graphed = phase_graphed_vs_eager(device, cache, card)
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
    with tempfile.TemporaryDirectory(prefix="ddsp_chip_smoke_evidence_") as tmp:
        accuracy_fwd = phase_accuracy(device, tmp)
        oof = phase_oof(device, card, tmp)
        check(all(n > 0 for n in oof.values()), "a kernel was not launched on the train_oof path")
        sigmund = phase_sigmund(device, tmp)
        check(all(n > 0 for n in sigmund.values()), "a kernel was not launched on the sigmund path")
        phase_crepe_training(device, card, tmp)
        phase_sweep(device, tmp)
    with tempfile.TemporaryDirectory(prefix="ddsp_chip_smoke_parallel_") as tmp:
        cache = os.path.join(tmp, "cache")
        write_cache(cache, device)
        sharded = phase_time_sharded(device, cache, tmp, card)
        trajectory = phase_trajectory(device, tmp, card)
        nccl = phase_data_parallel(device, cache, tmp, card)
    longform_fwd = phase_longform(device, card)
    with tempfile.TemporaryDirectory(prefix="ddsp_chip_smoke_bf16_") as tmp:
        cache = os.path.join(tmp, "cache")
        write_cache(cache, device)
        bf16 = phase_bf16(device, cache, tmp, card, f32_graphed)
    check(all(n > 0 for path in ("fit", "graphed", "autoencoder_step") for n in bf16[path].values())
          and bf16["serving"] > 0, "a kernel was not launched on a bf16 path")
    phase_benchmarks(device, card)
    tools = phase_run_tools(device, card)
    last = phase_last_modules(device, card)
    check(all((n > 0) != name.startswith("stft_") for name, n in sharded["fit"].items()),
          f"the time-sharded path launched {sharded['fit']}: each oscillator and GRU kernel, and no kernel of "
          "the fused loss (its loss is its own)")
    check(all(n > 0 for n in nccl.values()) and longform_fwd > 0,
          "a kernel was not launched on the NCCL data-parallel or long-form path")
    # launches: the forward's on this slice's main path (phase 29); the
    # backward's on the newest path that trains (phase 28's trainrun children)
    fwd_entry["launches"] = sum(last.values())
    fwd_entry["launches_by_path"] = {"serving": serving_fwd, "training": train_fwd,
                                     "training_graphed": graphed["oscillator_fwd"],
                                     "serving_exported": exported_fwd, "serving_pool": pool_fwd,
                                     "serving_autoencoder": ae_fwd, "synthetic": synthetic_fwd,
                                     "training_autoencoder": ae_train["oscillator_fwd"],
                                     "timbre_transfer": transfer_fwd, "headline": headline_fwd,
                                     "drift_soak": drift_fwd, "runtime_host": host_fwd,
                                     "pitch_accuracy": accuracy_fwd, "train_oof": oof["oscillator_fwd"],
                                     "train_sigmund": sigmund["oscillator_fwd"],
                                     "time_sharded_fit": sharded["fit"]["oscillator_fwd"],
                                     "time_sharded_graphed": sharded["graphed"]["oscillator_fwd"],
                                     "time_sharded_trajectory": trajectory["oscillator_fwd"],
                                     "data_parallel_nccl_graphed": nccl["oscillator_fwd"],
                                     "longform": longform_fwd, "training_bf16": bf16["fit"]["oscillator_fwd"],
                                     "training_bf16_graphed": bf16["graphed"]["oscillator_fwd"],
                                     "serving_bf16": bf16["serving"],
                                     "training_autoencoder_bf16": bf16["autoencoder_step"]["oscillator_fwd"],
                                     **{path: c["oscillator_fwd"] for path, c in tools.items()}, **last}
    bwd_entry["launches"] = tools["trainrun"]["oscillator_bwd"]
    bwd_entry["launches_by_path"] = {"serving": 0, "training": train_bwd,
                                     "training_graphed": graphed["oscillator_bwd"],
                                     "serving_exported": 0, "serving_pool": 0, "serving_autoencoder": 0,
                                     "synthetic": 0, "training_autoencoder": ae_train["oscillator_bwd"],
                                     "timbre_transfer": 0, "headline": 0, "drift_soak": 0, "runtime_host": 0,
                                     "pitch_accuracy": 0, "train_oof": oof["oscillator_bwd"],
                                     "train_sigmund": sigmund["oscillator_bwd"],
                                     "time_sharded_fit": sharded["fit"]["oscillator_bwd"],
                                     "time_sharded_graphed": sharded["graphed"]["oscillator_bwd"],
                                     "time_sharded_trajectory": trajectory["oscillator_bwd"],
                                     "data_parallel_nccl_graphed": nccl["oscillator_bwd"], "longform": 0,
                                     "training_bf16": bf16["fit"]["oscillator_bwd"],
                                     "training_bf16_graphed": bf16["graphed"]["oscillator_bwd"],
                                     "serving_bf16": 0,
                                     "training_autoencoder_bf16": bf16["autoencoder_step"]["oscillator_bwd"],
                                     **{path: c["oscillator_bwd"] for path, c in tools.items()},
                                     **{path: 0 for path in last}}

    print(json.dumps({"kernels": [fwd_entry, bwd_entry, *probe_entries, *gru_entries, *stft_entries,
                                  *adam_entries]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
