"""The card's measured FP32 FMA and accurate-sin rates, and the oscillator
kernels' instruction-mix bound from them.

    python -m ddsp_pytorch_tpu_torch.bench_roofline [--out FILE]

The counterpart of scripts/bench_roofline.py's `measure_vpu_rates_pallas`
and `add_vpu_model` (`:211-331`).  Two parts:

  * the probes (ops/roofline.py, kernel ops/kernels/roofline_probe.cu) on
    the script's input, 256 tiles of 32 × 512 float32: CUDA events around
    PROBE_ITERS launches of each, queued behind a GPU sleep after a warm-up,
    at every block size of roofline.BLOCK_SIZES (each checked equal to the
    default's output); the fastest is the probe's rate.  FMA/s = elements ×
    (2·256 + 3) / time, FP32 TFLOP/s = 2 × FMA/s against the published 67
    TFLOP/s, sinf/s = elements × 32 / time; each beside its own bound.  The
    fma probe's is its operations.  The sin probe's is its FP32
    instructions, counted on the fast path of its SASS (`cuobjdump`; each
    accurate sinf is ~17 of them), over the SMs' FP32 lanes at the highest
    SM clock polled below.  The fma probe runs for CLOCK_WINDOW_S while a
    thread polls nvidia-smi: the SM clock and power draw under its load (67 TFLOP/s is 132 SMs × 128
    lanes × 2 flops at 1.98 GHz);
  * for each oscillator kernel at the main path's shapes (R = 1 and 2, the
    served rows of one and two voices; 1024 and 2048, pools of the voice
    ramp; 3000 and 6000, the training rows; K = 64, S = 512), its device
    time and the script's instruction-mix model: the forward does 2
    transcendentals and 2K FMAs a sample, the backward 4 and 5K
    (`:318-325`); ideal time = transcendentals / (sinf/s) + FMAs / (FMA/s),
    and its share of the measured time.  The FP32 operations bound of
    kernel_bench.py stands beside it, not in its place.  The times are this
    module's own (`time_oscillator`), or a caller's who timed the same
    kernels at the same shapes already (chip_smoke.py passes its phase 2's).

Prints one JSON object with the card's name and power limit, and writes it
to --out if given.  Needs a CUDA card.  No serving or training path calls
the probes.
"""

from __future__ import annotations

import argparse
import collections
import json
import re

import numpy as np
import torch

from ddsp_pytorch_tpu_torch.kernel_bench import (
    PEAK_FP32_FLOPS,
    PEAK_HBM_BYTES,
    bound,
    card_line,
    clocks_under_load,
    oscillator_bound,
    oscillator_bwd_bound,
    oscillator_inputs,
    sleep_cycles_per_ms,
    time_ms,
)
from ddsp_pytorch_tpu_torch.ops import roofline

OSCILLATOR_SHAPES = ((1, 64, 512), (2, 64, 512), (1024, 64, 512), (2048, 64, 512),
                     (3000, 64, 512), (6000, 64, 512))
PROBE_ITERS = 50
# FP32 lanes an SM of an H100 (67 TFLOP/s = 132 SMs × 128 × 2 × 1.98 GHz)
LANES_PER_SM = 128
# SASS opcodes counted as FP32 instructions: arithmetic, compare and select,
# and the float ↔ int conversions of sinf's range reduction
FP32_OPCODES = frozenset({"FADD", "FMUL", "FFMA", "FSEL", "FSET", "FSETP", "FMNMX", "FRND", "F2I", "I2F",
                          "I2FP"})
# one SASS instruction: /*addr*/, an optional predicate, the opcode, operands
_SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
CLOCK_WINDOW_S = 2.0  # seconds of fma probes while nvidia-smi is polled


def fma_probe_bound(n: int):
    """(bound_ms, bound_by) of the fma probe on n elements: 8 bytes each,
    2 flops an FMA."""
    return bound(8 * n, 2 * roofline.FMA_PER_ELEMENT * n)


def sass_fast_path(text: str) -> collections.Counter:
    """Opcode counts (the mnemonic before its first '.') of a kernel
    function's SASS (`kernels.sass`) along its fast path: every
    instruction, except those a forward conditional branch skips over when
    the skipped region holds a loop (a backward branch).  In the sin probe
    each accurate sinf has such a region, its Payne-Hanek reduction for
    |x| ≥ 105615, which the probe's inputs (all below 2) never take."""
    ins = [(int(m.group(1), 16), bool(m.group(2)), m.group(3).split(".")[0], m.group(4))
           for m in _SASS_LINE.finditer(text)]
    index = {addr: i for i, (addr, _, _, _) in enumerate(ins)}

    def target(i):
        m = re.search(r"0x([0-9a-f]+)", ins[i][3])
        return int(m.group(1), 16) if m and ins[i][2] == "BRA" else None

    counts = collections.Counter()
    i = 0
    while i < len(ins):
        addr, predicated, op, _ = ins[i]
        to = target(i)
        if predicated and to is not None and to > addr and to in index:
            j = index[to]
            if any(target(k) is not None and target(k) <= ins[k][0] for k in range(i + 1, j)):
                i = j
                continue
        counts[op] += 1
        i += 1
    return counts


def fp32_instructions(counts: collections.Counter) -> int:
    """The FP32 instructions among SASS opcode counts (FP32_OPCODES)."""
    return sum(n for op, n in counts.items() if op in FP32_OPCODES)


def sin_probe_bound(n: int, fp32_per_element: int, sms: int, sm_mhz: float):
    """(bound_ms, bound_by) of the sin probe on n elements: the larger of its
    8 bytes an element over the HBM rate and its FP32 instructions
    (`fp32_per_element`, counted on the fast path of its SASS) over the
    card's FP32 issue rate, sms × LANES_PER_SM lanes at `sm_mhz`."""
    t_bytes = 8 * n / PEAK_HBM_BYTES
    t_ops = fp32_per_element * n / (sms * LANES_PER_SM * sm_mhz * 1e6)
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def sin_probe_sass(device) -> dict:
    """The sin probe's fast-path SASS counts: its FP32 instructions an
    element and, less the chain's own adds and folds, a sinf."""
    from ddsp_pytorch_tpu_torch.ops import kernels

    text = [t for fn, t in kernels.sass("roofline_sin").items() if "roofline_sin_kernel" in fn]
    if len(text) != 1:
        raise RuntimeError("the sin probe's function was not found in the SASS")
    counts = sass_fast_path(text[0])
    fp32 = fp32_instructions(counts)
    return {"fast_path_opcodes": dict(counts), "fp32_per_element": fp32,
            "fp32_per_sinf": (fp32 - roofline.SIN_OTHER_PER_ELEMENT) / roofline.SIN_PER_ELEMENT,
            "sms": torch.cuda.get_device_properties(device).multi_processor_count}


def _sweep(probe, x, cycles_per_ms: float) -> dict:
    """{threads a block: device ms} of one probe; raises if a block size
    changes its output."""
    want = probe(x)
    out = {}
    for threads in roofline.BLOCK_SIZES:
        if not torch.equal(probe(x, threads=threads), want):
            raise RuntimeError(f"{probe.__name__}: blocks of {threads} change the output")
        out[threads], _ = time_ms(lambda: probe(x, threads=threads), PROBE_ITERS, cycles_per_ms)
    return out


def measure_probe_rates(device, cycles_per_ms: float) -> dict:
    """Time both probes on the script's input at every block size; the
    rates are the fastest's."""
    x = roofline.probe_input(device=device)
    n = x.numel()
    fma_sweep = _sweep(roofline.fma_chain, x, cycles_per_ms)
    sin_sweep = _sweep(roofline.sin_chain, x, cycles_per_ms)
    fma_threads = min(fma_sweep, key=fma_sweep.get)
    sin_threads = min(sin_sweep, key=sin_sweep.get)
    fma_ms, sin_ms = fma_sweep[fma_threads], sin_sweep[sin_threads]
    clocks = clocks_under_load(lambda: roofline.fma_chain(x, threads=fma_threads), CLOCK_WINDOW_S)
    fma_per_s = n * roofline.FMA_PER_ELEMENT / (fma_ms * 1e-3)
    sin_per_s = n * roofline.SIN_PER_ELEMENT / (sin_ms * 1e-3)
    fma_bound_ms, _ = fma_probe_bound(n)
    sin_sass = sin_probe_sass(device)
    # the highest SM clock seen under load: the fastest the card ran
    sin_bound_ms, sin_bound_by = sin_probe_bound(n, sin_sass["fp32_per_element"], sin_sass["sms"],
                                                 clocks["sm_mhz_max"])
    return {
        "elements": n,
        "fma_ops_per_elem": roofline.FMA_PER_ELEMENT,
        "sin_ops_per_elem": roofline.SIN_PER_ELEMENT,
        "fma_ms_by_threads": fma_sweep,
        "fma_threads": fma_threads,
        "fma_ms": fma_ms,
        "fma_bound_ms": fma_bound_ms,
        "fma_elems_per_s": fma_per_s,
        "fma_tflops": 2.0 * fma_per_s / 1e12,
        "fma_share_of_fp32_peak": 2.0 * fma_per_s / PEAK_FP32_FLOPS,
        "sin_ms_by_threads": sin_sweep,
        "sin_threads": sin_threads,
        "sin_ms": sin_ms,
        "sin_bound_ms": sin_bound_ms,
        "sin_bound_by": sin_bound_by,
        "sin_share_of_bound": sin_bound_ms / sin_ms,
        "sin_sass": sin_sass,
        "sin_elems_per_s": sin_per_s,
        "fp32_peak_tflops": PEAK_FP32_FLOPS / 1e12,
        "clocks_under_fma_load": clocks,
        "method": "CUDA events around back-to-back launches queued behind a GPU sleep",
    }


def instruction_mix_ms(mode: str, rows: int, k: int, s: int, rates: dict) -> float:
    """The script's ideal time (add_vpu_model, `:307-331`) of one launch:
    transcendentals at the measured sin rate plus FMAs at the measured FMA
    rate."""
    samples = rows * s
    n_trans, n_fma = (2.0 * samples, 2.0 * samples * k) if mode == "fwd" else (
        4.0 * samples, 5.0 * samples * k)
    return 1e3 * (n_trans / rates["sin_elems_per_s"] + n_fma / rates["fma_elems_per_s"])


def time_oscillator(device, cycles_per_ms: float) -> dict:
    """Each oscillator kernel's device ms at OSCILLATOR_SHAPES, keyed
    (kernel name, rows, k, s)."""
    from ddsp_pytorch_tpu_torch.ops import oscillator as osc

    rng = np.random.default_rng(0)
    out = {}
    for rows, k, s in OSCILLATOR_SHAPES:
        phi, omega, amp = (torch.tensor(a, device=device) for a in oscillator_inputs(rng, rows, k))
        g = torch.tensor(rng.standard_normal((rows, s)).astype(np.float32), device=device)
        out["oscillator_fwd", rows, k, s], _ = time_ms(
            lambda: osc.oscillator_bank(phi, omega, amp, s), 200, cycles_per_ms)
        out["oscillator_bwd", rows, k, s], _ = time_ms(
            lambda: osc.oscillator_bank_bwd(phi, omega, amp, g, s), 200, cycles_per_ms)
    return out


def oscillator_rows(rates: dict, kernel_ms: dict) -> list:
    """Each oscillator kernel's device time at OSCILLATOR_SHAPES (from
    `kernel_ms`, keyed as time_oscillator keys it) beside its
    instruction-mix ideal and its FP32 operations bound."""
    rows_out = []
    for rows, k, s in OSCILLATOR_SHAPES:
        for mode, name, (bound_ms, bound_by) in (
                ("fwd", "oscillator_fwd", oscillator_bound(rows, k, s)),
                ("bwd", "oscillator_bwd", oscillator_bwd_bound(rows, k, s))):
            ms = kernel_ms[name, rows, k, s]
            ideal = instruction_mix_ms(mode, rows, k, s, rates)
            rows_out.append({
                "kernel": name, "rows": rows, "k": k, "s": s, "ms": ms,
                "instruction_mix_ms": ideal, "share_of_instruction_mix": ideal / ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "share_of_bound": bound_ms / ms,
            })
    return rows_out


def run(device, kernel_ms=None) -> dict:
    """Both parts on `device`; the result the CLI prints.  `kernel_ms`:
    the oscillator kernels' times at OSCILLATOR_SHAPES where the caller
    has them, else they are timed here."""
    cycles_per_ms = sleep_cycles_per_ms()
    rates = measure_probe_rates(device, cycles_per_ms)
    if kernel_ms is None:
        kernel_ms = time_oscillator(device, cycles_per_ms)
    return {
        "card": card_line(),
        "torch": torch.__version__,
        "rates": rates,
        "oscillator": oscillator_rows(rates, kernel_ms),
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_roofline: needs a CUDA card")
    result = run(torch.device("cuda", 0))
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    return result


if __name__ == "__main__":
    main()
