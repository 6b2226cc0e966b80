"""Out-of-family audio fixtures: waveforms the DDSP model does not share.

Port of ddsp_pytorch_tpu/data/fixtures.py:1-401.  The corpus is made by
mechanisms other than an additive sine bank (Karplus-Strong plucks, FM
brass, a sawtooth through a resonant formant), each note with its exact
per-sample f0, and written as ordinary wavs (what preprocessing reads)
beside a truth/ sidecar.  The degradations (coloured noise at a fixed SNR,
a synthetic small-room impulse response, a mic chain) and the raw pitch
accuracy scoring are here too.

This is host numpy code, made once before training.  The JAX module's
scipy calls are restated in numpy here: `lfilter` (a direct-form IIR in
float64, as scipy computes it), `butter_highpass2` (scipy's second-order
Butterworth high-pass, in closed form) and `fftconvolve` (numpy's real FFT
at the next 5-smooth length).  Every draw comes from the same
`np.random.default_rng` sequence in the same order as in the JAX module,
so one seed gives the same corpus.
"""

from __future__ import annotations

import functools
import json
import math
import os

import numpy as np

from ddsp_pytorch_tpu_torch.utils.audio_io import save_wav
from ddsp_pytorch_tpu_torch.utils.units import midi_to_hz

# samples a block of lfilter's blocked recurrence
_IIR_BLOCK = 256


# ------------------------------------------------------ scipy, in numpy


@functools.lru_cache(maxsize=32)
def _ar_responses(a: tuple, length: int) -> tuple:
    """The recursive part 1/A(z) of an IIR over `length` samples: (T
    (length, length) lower-triangular Toeplitz of its impulse response, G
    (length, p): column j the output from y[−1−j] = 1 and no input).
    Read-only arrays."""
    p = len(a) - 1
    h = np.zeros(length)
    g = np.zeros((length, p))
    for n in range(length):
        h[n] = (1.0 if n == 0 else 0.0) - sum(a[k] * h[n - k] for k in range(1, p + 1) if n >= k)
        for j in range(p):
            acc = 0.0
            for k in range(1, p + 1):
                m = n - k
                if m >= 0:
                    acc -= a[k] * g[m, j]
                elif m == -1 - j:
                    acc -= a[k]
            g[n, j] = acc
    idx = np.arange(length)
    lag = idx[:, None] - idx[None, :]
    toeplitz = np.where(lag >= 0, h[np.clip(lag, 0, length - 1)], 0.0)
    toeplitz.flags.writeable = False
    g.flags.writeable = False
    return toeplitz, g


def lfilter(b, a, x, y_init=None) -> np.ndarray:
    """scipy.signal.lfilter(b, a, x) in float64: y[n] = (Σ_k b_k x[n−k] −
    Σ_{k≥1} a_k y[n−k]) / a_0, the input zero before it starts and the
    output's past `y_init` = (y[−1], …, y[−p]) (default zeros).

    The feed-forward part is one convolution.  The recursion runs in
    blocks of _IIR_BLOCK samples: a block's output is its zero-state
    response (a product with the impulse response's Toeplitz matrix, all
    blocks at once) plus the response to the last outputs of the block
    before (one small product a block)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64) / a[0]
    a = a / a[0]
    x = np.asarray(x, np.float64)
    n, p = x.shape[0], a.shape[0] - 1
    v = np.convolve(x, b)[:n]
    if p == 0 or n == 0:
        return v
    toeplitz, g = _ar_responses(tuple(a.tolist()), _IIR_BLOCK)
    n_blocks = -(-n // _IIR_BLOCK)
    padded = np.zeros(n_blocks * _IIR_BLOCK)
    padded[:n] = v
    zero_state = padded.reshape(n_blocks, _IIR_BLOCK) @ toeplitz.T
    state = np.zeros(p) if y_init is None else np.asarray(y_init, np.float64)
    for i in range(n_blocks):
        zero_state[i] += g @ state
        state = zero_state[i, ::-1][:p]
    return zero_state.reshape(-1)[:n]


def butter_highpass2(wn: float) -> tuple:
    """scipy.signal.butter(2, wn, "highpass") → (b, a): the analog
    second-order Butterworth, pre-warped and mapped by the bilinear
    transform, in closed form (wn a fraction of Nyquist)."""
    k = math.tan(math.pi * wn / 2.0)
    norm = 1.0 + math.sqrt(2.0) * k + k * k
    b = np.array([1.0, -2.0, 1.0]) / norm
    a = np.array([1.0, 2.0 * (k * k - 1.0) / norm, (1.0 - math.sqrt(2.0) * k + k * k) / norm])
    return b, a


def _next_fast_len(n: int) -> int:
    """The smallest 5-smooth integer ≥ n (an FFT length pocketfft is fast at)."""
    best = 1 << max(0, (n - 1).bit_length())
    p5 = 1
    while p5 < best:
        p35 = p5
        while p35 < best:
            q = p35
            while q < n:
                q *= 2
            best = min(best, q)
            p35 *= 3
        p5 *= 5
    return best


def fftconvolve(x, h) -> np.ndarray:
    """scipy.signal.fftconvolve(x, h) ("full", length len(x) + len(h) − 1)
    in float64, by numpy's real FFT at the next 5-smooth length."""
    x = np.asarray(x, np.float64)
    h = np.asarray(h, np.float64)
    n = x.shape[0] + h.shape[0] - 1
    size = _next_fast_len(n)
    return np.fft.irfft(np.fft.rfft(x, size) * np.fft.rfft(h, size), size)[:n]


# --------------------------------------------------------------- synthesis


def karplus_strong(target_f0: float, n_samples: int, sr: int, rng, decay: float = 0.998) -> tuple:
    """Plucked string: y[n] = decay · (y[n−N] + y[n−N−1]) / 2, period by
    period (fixtures.py:44-66).  The averaging adds half a sample of delay,
    so the returned exact f0 is sr / (N + 0.5)."""
    n_delay = max(2, int(round(sr / target_f0 - 0.5)))
    f0_true = sr / (n_delay + 0.5)
    row = rng.uniform(-1.0, 1.0, n_delay)
    rows = [row]
    total = n_delay
    while total < n_samples:
        prev = rows[-1]
        row = decay * 0.5 * (prev + np.roll(prev, 1))
        rows.append(row)
        total += n_delay
    sig = np.concatenate(rows)[:n_samples]
    return sig.astype(np.float32), f0_true


def fm_brass(f0: float, n_samples: int, sr: int, rng, vibrato_cents: float = 8.0) -> tuple:
    """Brass-like FM at carrier:modulator 1:1, sin(φ + I(t)·sin φ), the
    index opening with the amplitude (fixtures.py:69-87).  Returns the
    per-sample f0 track, vibrato included."""
    t = np.arange(n_samples) / sr
    vib = 2.0 ** (vibrato_cents / 1200.0 * np.sin(2 * np.pi * 5.5 * t))
    f0_t = f0 * vib
    phase = 2 * np.pi * np.cumsum(f0_t) / sr
    attack = 1.0 - np.exp(-t * 30.0)
    release = np.exp(-np.maximum(t - (t[-1] - 0.15), 0.0) * 25.0)
    env = attack * release
    index = 0.5 + 4.0 * env
    sig = env * np.sin(phase + index * np.sin(phase))
    return sig.astype(np.float32), f0_t.astype(np.float32)


def bowed_saw(f0: float, n_samples: int, sr: int, rng, glide_semitones: float = 0.0) -> tuple:
    """A sawtooth (with an optional glide) through a resonant formant
    biquad, plus a breathy noise attack (fixtures.py:90-120)."""
    t = np.arange(n_samples) / sr
    f0_t = f0 * 2.0 ** (glide_semitones / 12.0 * t / max(t[-1], 1e-9))
    phase = np.cumsum(f0_t) / sr
    saw = 2.0 * (phase - np.floor(phase + 0.5))

    # resonant formant biquad around 3.5 · f0 (clipped below Nyquist)
    fc = min(3.5 * f0, 0.4 * sr)
    q = 2.0
    w0 = 2 * np.pi * fc / sr
    alpha = np.sin(w0) / (2 * q)
    b = [alpha, 0.0, -alpha]
    a = [1 + alpha, -2 * np.cos(w0), 1 - alpha]
    body = lfilter(b, a, saw)
    body = body / (np.max(np.abs(body)) + 1e-9)

    attack_len = int(0.03 * sr)
    noise = np.zeros(n_samples)
    noise[:attack_len] = rng.standard_normal(attack_len) * np.linspace(0.6, 0.0, attack_len)
    env = (1.0 - np.exp(-t * 40.0)) * np.exp(-np.maximum(t - (t[-1] - 0.1), 0.0) * 30.0)
    sig = env * (0.8 * body + noise)
    return sig.astype(np.float32), f0_t.astype(np.float32)


FAMILIES = ("pluck", "fm_brass", "bowed")


def render_note(family: str, f0: float, n_samples: int, sr: int, rng):
    """→ (audio (n,), f0_track (n,) the true per-sample fundamental)."""
    if family == "pluck":
        sig, f0_true = karplus_strong(f0, n_samples, sr, rng)
        return sig, np.full(n_samples, f0_true, np.float32)
    if family == "fm_brass":
        return fm_brass(f0, n_samples, sr, rng)
    if family == "bowed":
        glide = rng.uniform(-2.0, 2.0)
        return bowed_saw(f0, n_samples, sr, rng, glide_semitones=glide)
    raise ValueError(f"unknown family {family!r}")


# ----------------------------------------------------------------- corpus


def make_oof_corpus(
    out_dir: str,
    *,
    sample_rate: int = 48000,
    note_seconds: float = 2.0,
    n_train: int = 12,
    n_validation: int = 3,
    families=FAMILIES,
    midi_range=(45, 76),
    seed: int = 0,
    degrade_fn=None,
) -> dict:
    """Write an out-of-family wav corpus and its ground truth
    (fixtures.py:129-193); returns the meta dict.

    degrade_fn: an optional (sig, sr) → sig (make_degrader) applied after
    the truth is taken from the clean note, so the truth stays clean.

    Layout (what preprocessing reads):
      out_dir/{train,validation}/<family>_<i>.wav
      out_dir/truth/<partition>/<stem>.npz   f0 (n,) per-sample Hz,
                                             voiced (n,) bool
      out_dir/truth/meta.json
    """
    rng = np.random.default_rng(seed)
    n = int(note_seconds * sample_rate)
    meta = {
        "sample_rate": sample_rate,
        "note_seconds": note_seconds,
        "families": list(families),
        "seed": seed,
        "files": {},
    }
    for partition, count in (("train", n_train), ("validation", n_validation)):
        wav_dir = os.path.join(out_dir, partition)
        truth_dir = os.path.join(out_dir, "truth", partition)
        os.makedirs(wav_dir, exist_ok=True)
        os.makedirs(truth_dir, exist_ok=True)
        for i in range(count):
            family = families[i % len(families)]
            midi = rng.uniform(*midi_range)
            f0 = float(midi_to_hz(midi))
            sig, f0_track = render_note(family, f0, n, sample_rate, rng)
            peak = np.max(np.abs(sig)) + 1e-9
            sig = 0.7 * sig / peak
            # voiced where the note sounds (an energy gate)
            frame = max(1, sample_rate // 100)
            energy = np.convolve(sig**2, np.ones(frame) / frame, mode="same")
            voiced = energy > 1e-4
            if degrade_fn is not None:
                sig = degrade_fn(sig, sample_rate)
            stem = f"{family}_{i:02d}"
            save_wav(os.path.join(wav_dir, stem + ".wav"), sig, sample_rate)
            np.savez(os.path.join(truth_dir, stem + ".npz"), f0=f0_track, voiced=voiced)
            meta["files"][f"{partition}/{stem}"] = {"family": family, "midi": float(midi)}
    with open(os.path.join(out_dir, "truth", "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return meta


# ----------------------------------------------------------- degradation


def colored_noise(n: int, rng, color: str = "pink") -> np.ndarray:
    """Unit-variance noise: 'white', or 'pink' by 1/√f shaping of its
    spectrum."""
    w = rng.standard_normal(n)
    if color == "white":
        out = w
    elif color == "pink":
        spec = np.fft.rfft(w)
        f = np.fft.rfftfreq(n)
        f[0] = f[1] if n > 1 else 1.0
        spec = spec / np.sqrt(f)
        spec[0] = 0.0
        out = np.fft.irfft(spec, n)
    else:
        raise ValueError(f"unknown noise color {color!r}")
    return (out / (np.std(out) + 1e-12)).astype(np.float32)


def add_noise_snr(sig: np.ndarray, snr_db: float, rng, color: str = "pink") -> np.ndarray:
    """Additive noise at a fixed SNR (dB) against the signal's power."""
    p_sig = float(np.mean(np.square(sig))) + 1e-12
    p_noise = p_sig / (10.0 ** (snr_db / 10.0))
    noise = colored_noise(len(sig), rng, color) * np.sqrt(p_noise)
    return (sig + noise).astype(np.float32)


def room_impulse_response(sr: int, rng, rt60: float = 0.3, direct_to_reverb_db: float = 6.0) -> np.ndarray:
    """A synthetic small-room IR (fixtures.py:252-274): a unit direct tap,
    3-8 sparse early reflections within 5-40 ms, and a Gaussian tail with
    an exponential RT60 decay, its energy `direct_to_reverb_db` below the
    direct path."""
    length = int(rt60 * 1.5 * sr)
    t = np.arange(length) / sr
    ir = np.zeros(length, np.float32)
    ir[0] = 1.0
    n_early = int(rng.integers(3, 9))
    for _ in range(n_early):
        delay = rng.uniform(0.005, 0.040)
        i = int(delay * sr)
        if i < length:
            ir[i] += rng.choice([-1.0, 1.0]) * rng.uniform(0.2, 0.6) * np.exp(-delay * 50.0)
    tail = rng.standard_normal(length) * np.exp(-t * (6.908 / rt60))
    tail[: int(0.005 * sr)] = 0.0  # the tail starts after the direct sound
    tail_gain = np.sqrt(10.0 ** (-direct_to_reverb_db / 10.0) / (np.sum(tail**2) + 1e-12))
    return (ir + tail * tail_gain).astype(np.float32)


def apply_reverb(sig: np.ndarray, ir: np.ndarray) -> np.ndarray:
    return fftconvolve(sig, ir)[: len(sig)].astype(np.float32)


def _biquad_peaking(sr: int, fc: float, gain_db: float, q: float = 1.0):
    """RBJ peaking-EQ biquad (b, a) coefficients."""
    a_lin = 10.0 ** (gain_db / 40.0)
    w0 = 2 * np.pi * fc / sr
    alpha = np.sin(w0) / (2 * q)
    b = [1 + alpha * a_lin, -2 * np.cos(w0), 1 - alpha * a_lin]
    a = [1 + alpha / a_lin, -2 * np.cos(w0), 1 - alpha / a_lin]
    return b, a


def mic_chain(sig: np.ndarray, sr: int, *, hp_hz: float = 80.0, presence_hz: float = 4000.0,
              presence_db: float = 6.0, drive: float = 3.0) -> np.ndarray:
    """Mic and preamp colouring (fixtures.py:292-310): a second-order
    Butterworth high-pass, a presence-peak EQ and peak-preserving tanh soft
    clipping.  Not level-neutral: make_degrader renormalizes."""
    b, a = butter_highpass2(hp_hz / (sr / 2))
    out = lfilter(b, a, sig)
    pb, pa = _biquad_peaking(sr, min(presence_hz, 0.45 * sr), presence_db)
    out = lfilter(pb, pa, out)
    peak = np.max(np.abs(out)) + 1e-9
    out = np.tanh(drive * out / peak) * peak / np.tanh(drive)
    return out.astype(np.float32)


def make_degrader(*, snr_db=None, noise_color: str = "pink", rt60=None, mic: bool = False,
                  seed: int = 1234):
    """A degradation (sig, sr) → sig: reverb → mic chain → additive noise,
    then renormalized to a 0.7 peak; draws from its own rng."""
    rng = np.random.default_rng(seed)

    def fn(sig: np.ndarray, sr: int) -> np.ndarray:
        out = np.asarray(sig, np.float32)
        if rt60 is not None:
            out = apply_reverb(out, room_impulse_response(sr, rng, rt60))
        if mic:
            out = mic_chain(out, sr)
        if snr_db is not None:
            out = add_noise_snr(out, snr_db, rng, noise_color)
        peak = np.max(np.abs(out)) + 1e-9
        return (0.7 * out / peak).astype(np.float32)

    return fn


# Named degradation conditions of the robustness report
# (pitch_accuracy.py --degraded) and the degraded-corpus training
# (train_oof.py --degrade).
DEGRADATIONS = {
    "clean": dict(),
    "snr20": dict(snr_db=20.0),
    "snr10": dict(snr_db=10.0),
    "snr0": dict(snr_db=0.0),
    "reverb": dict(rt60=0.3),
    "mic": dict(mic=True),
    "full_chain": dict(rt60=0.3, mic=True, snr_db=10.0),
}


# ------------------------------------------------------------ RPA scoring


def cents_error(est_hz: np.ndarray, true_hz: np.ndarray) -> np.ndarray:
    est = np.maximum(np.asarray(est_hz, np.float64), 1e-6)
    true = np.maximum(np.asarray(true_hz, np.float64), 1e-6)
    return 1200.0 * np.log2(est / true)


def summarize_cents(abs_err: np.ndarray, threshold_cents: float = 50.0) -> dict:
    """RPA and the mean and median |cents| of absolute cent errors; an
    empty array gives RPA 0 and null errors."""
    abs_err = np.asarray(abs_err, np.float64)
    if abs_err.size == 0:
        return {"rpa": 0.0, "mean_abs_cents": None, "median_abs_cents": None, "n_frames": 0}
    return {
        "rpa": float(np.mean(abs_err <= threshold_cents)),
        "mean_abs_cents": float(np.mean(abs_err)),
        "median_abs_cents": float(np.median(abs_err)),
        "n_frames": int(abs_err.size),
    }


def raw_pitch_accuracy(est_hz: np.ndarray, true_hz: np.ndarray, voiced: np.ndarray,
                       threshold_cents: float = 50.0) -> dict:
    """RPA over the voiced frames: the share within ±threshold cents, with
    the mean and median |cents|."""
    est = np.asarray(est_hz, np.float64)[voiced]
    true = np.asarray(true_hz, np.float64)[voiced]
    return summarize_cents(np.abs(cents_error(est, true)), threshold_cents)


def frame_truth(f0_track: np.ndarray, voiced: np.ndarray, block_size: int, n_frames: int) -> tuple:
    """Per-sample truth → the frame-rate truth of extract_pitch's grid (one
    value a block): the median f0, voiced where ≥ 80 % of the samples are."""
    f0_f = np.empty(n_frames, np.float64)
    v_f = np.empty(n_frames, bool)
    for k in range(n_frames):
        seg = slice(k * block_size, (k + 1) * block_size)
        f0_f[k] = np.median(f0_track[seg])
        v_f[k] = np.mean(voiced[seg]) >= 0.8
    return f0_f, v_f
