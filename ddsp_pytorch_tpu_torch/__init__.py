"""ddsp_pytorch_tpu_torch — the PyTorch/CUDA port of ddsp_pytorch_tpu.

The JAX package `ddsp_pytorch_tpu` is the reference; this package restates
it in PyTorch for an NVIDIA Hopper GPU, slice by slice (ROADMAP.md):

  bundle.py     flax msgpack + meta.json bundle reader and writer
  weights.py    flax parameter tree ↔ this package's state_dict
  ops/          L0 DSP core: oscillator bank (hand-written CUDA kernels on
                CUDA tensors, plain PyTorch on CPU tensors), FIR noise,
                FFTs, MFCCs, loudness, YIN pitch
  models/       L1+L2 HarmonicSynth / FilteredNoise / Reverb, GRU decoder,
                MFCC encoder and autoencoder (float32 or a bf16 NN); the
                CREPE pitch tracker and its fusion with YIN (crepe.py)
  data/         feature cache loaders, synthetic corpus, preprocessing,
                sigmund-wav ingestion, NSynth views, the out-of-family
                fixture corpus and its pitch scoring (fixtures.py)
  training/     loss, optimizer, checkpoints, the Trainer (CUDA graphs),
                media reports, profiling, the time-sharded step
  parallel/     the ('data', 'time') mesh in process or across
                torch.distributed processes, time-sharded DSP ops, the
                gradient reduction, long-form synthesis
  streaming/    L6a exact-state block streaming, the VoicePool
  export.py     trained run → bundle → model → stream session
  inference.py  offline timbre transfer of a recording through a bundle
  serve.py      socket server, wire-compatible with ddsp_pytorch_tpu.serve
  train.py, preprocess.py, train_pretrained.py, transfer.py,
  nsynth_inst_split.py, train_oof.py, train_sigmund.py, train_crepe.py,
  pitch_accuracy.py, tune_hybrid_pitch.py, time_sharded_trajectory.py: the CLIs
  bench.py, bench_headline.py, bench_step_breakdown.py, bench_scaling.py,
  profile_*.py, kernel_bench.py, bench_roofline.py: the measurements
  trainrun.py, ceiling_probe.py, e2e_smoke.py, ci.py: the run-level tools
  (a sustained run, the steps_per_call × unroll sweep, the CLI journey,
  the one-command verification)

It imports torch, numpy and the standard library only — never jax, flax,
msgpack, yaml or ddsp_pytorch_tpu.  Entry points take an explicit `device`
(default "cuda") and raise when CUDA is missing; nothing falls back to the
CPU unless the caller asks for it.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; raises if it names CUDA and there is none.

    Only "cpu" and "cuda" devices are supported.  There is deliberately no
    fallback: a caller that wants the CPU path passes device="cpu".
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} requested but torch.cuda.is_available()"
                " is False; pass device='cpu' to run the plain PyTorch path"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r} (cpu or cuda)")
    return dev
