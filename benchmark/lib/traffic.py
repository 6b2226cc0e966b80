"""What a streaming client sends, as a function of the seed alone.

A session plays one exponential glide from f_a to f_b over `glide_s`
seconds, with a loudness that swells slowly around its own level, and
(for an autoencoder session) the input audio of that glide: three
harmonics under the loudness envelope, with the glide's closed-form phase.
Every value is an elementwise function of the sample's time, so block i of
a session is the same wherever and however often it is computed: the load
generator makes it when it sends, the reference when it judges.
"""

from __future__ import annotations

import math
from dataclasses import asdict, dataclass

import numpy as np

F_MIN, F_MAX = 80.0, 1000.0  # Hz: the glide's ends lie between these
MIN_LOG_SPAN = 0.2  # |ln(f_b / f_a)| at least this, so the phase's closed form is defined


@dataclass
class Session:
    index: int
    offset_s: float  # start within the first period
    f_a: float
    f_b: float
    level_db: float
    swell_db: float
    swell_s: float
    swell_phase: float


def sessions(seed: int, n: int, period_s: float) -> list:
    """The `n` sessions of a run with seed `seed`: every seed draws the same
    kinds of glide and the same spread of start offsets."""
    rng = np.random.default_rng([int(seed) % 2**64, 7])
    out = []
    for i in range(n):
        f_a = math.exp(rng.uniform(math.log(F_MIN), math.log(F_MAX)))
        while True:
            f_b = math.exp(rng.uniform(math.log(F_MIN), math.log(F_MAX)))
            if abs(math.log(f_b / f_a)) >= MIN_LOG_SPAN:
                break
        out.append(Session(
            index=i,
            offset_s=float(rng.uniform(0.0, period_s)),
            f_a=f_a,
            f_b=f_b,
            level_db=float(rng.uniform(-45.0, -20.0)),
            swell_db=float(rng.uniform(3.0, 15.0)),
            swell_s=float(rng.uniform(1.0, 5.0)),
            swell_phase=float(rng.uniform(0.0, 2 * math.pi)),
        ))
    return out


def to_dict(s: Session) -> dict:
    return asdict(s)


def block(s: Session, i: int, block_size: int, sample_rate: int, glide_s: float,
          with_audio: bool):
    """Block i of session s: (pitch, loudness[, audio]), each (block_size,)
    float32."""
    t = (i * block_size + np.arange(block_size, dtype=np.float64)) / sample_rate
    log_r = math.log(s.f_b / s.f_a)
    growth = np.exp(log_r * t / glide_s)
    pitch = s.f_a * growth
    loud = s.level_db + s.swell_db * np.sin(2 * math.pi * t / s.swell_s + s.swell_phase)
    out = (pitch.astype(np.float32), loud.astype(np.float32))
    if with_audio:
        phase = np.remainder(2 * math.pi * s.f_a * glide_s / log_r * (growth - 1.0), 2 * math.pi)
        tone = (np.sin(phase) + 0.5 * np.sin(2 * phase) + 0.25 * np.sin(3 * phase)) / 1.75
        out += ((10.0 ** (loud / 20.0) * tone).astype(np.float32),)
    return out
