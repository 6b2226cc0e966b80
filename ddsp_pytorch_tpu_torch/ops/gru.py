"""The GRU's recurrence — the hand-written forward and backward kernels.

The recurrence of models/decoder.py `GRU` (gate order [r, z, n]), given
the input projection x_proj = x·W_ihᵀ + b_ih (B, F, 3H) of all frames:

  hp  = h_{t−1}·W_hhᵀ + b_hh
  r   = σ(x_r + hp_r),  z = σ(x_z + hp_z),  n = tanh(x_n + r·hp_n)
  h_t = (1 − z)·n + z·h_{t−1}

`gru_fwd` and `gru_bwd` are the two dispatch points: a CPU tensor goes to
the plain PyTorch version (`gru_fwd_plain`, the GRU's float loop, which
also returns what the backward reads; `gru_bwd_plain`, the hand-derived
backward), a float32 CUDA tensor launches the kernel
(`ops/kernels/gru_fwd.cu`, `gru_bwd.cu`: one persistent launch each for
all frames, where the loop launched ~36 kernels a frame forward and
back).  Nothing falls back.  `GRURecurrence` joins the two as one
autograd function; its backward adds dW_hh and db_hh as one plain product
and one sum over all frames.  `gru_recurrence`, which `GRU.forward` calls
without a compute dtype, is the one place that chooses between the
kernels and the loop (`kernel_takes`).  The JAX GRU is a `lax.scan`
(ddsp_pytorch_tpu/models/decoder.py), so these kernels replace no Pallas
kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ddsp_pytorch_tpu_torch.ops import kernels

# the kernels keep W_hh (3H × H float32) in one 16-block cluster's
# registers: 192 floats a thread at H = 512
MAX_KERNEL_HIDDEN = 512
# A cluster carries at most 8 batch rows and an H100 holds 7 clusters at
# once, so above 56 rows the kernel runs in waves, each reloading W_hh,
# while the loop's one (B, H)·(H, 3H) product a frame grows efficient.
# Measured on an H100 (PERF.md), the kernel is the faster up to
# B = 128·F rows and up to B = 512; larger batches take the loop.
KERNEL_ROWS_A_FRAME, KERNEL_MAX_BATCH = 128, 512
# the planes of the forward's saved activations, (5, B, F, H)
SAVED = ("r", "z", "n", "hp_n", "h_prev")
# (rows a cluster, clusters) each kernel chose at its last launch
plans = {"gru_fwd": None, "gru_bwd": None}


def kernel_takes(x_proj: torch.Tensor, hidden: int) -> bool:
    """Whether the kernels run this recurrence: x_proj (B, F, 3H) float32
    on a CUDA device, H ≤ MAX_KERNEL_HIDDEN and B ≤ min(KERNEL_ROWS_A_FRAME
    · F, KERNEL_MAX_BATCH).  Anything else (the CPU, float64, the bf16
    compute dtype, a larger H, a wide batch of few frames) is the loop's."""
    b, f = x_proj.shape[:2]
    return (x_proj.is_cuda and x_proj.dtype == torch.float32 and hidden <= MAX_KERNEL_HIDDEN
            and b <= min(KERNEL_ROWS_A_FRAME * f, KERNEL_MAX_BATCH))


def gru_fwd_plain(x_proj: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                  h0: Optional[torch.Tensor] = None, save: bool = True):
    """Plain PyTorch version of the forward kernel, and the GRU's float
    loop: x_proj (B, F, 3H), w_hh (3H, H), b_hh (3H), h0 (B, H) or None
    (zeros) → (out (B, F, H), h_final (B, H), saved (5, B, F, H): r, z, n,
    hp_n and h_{t−1} of each frame, or None where not `save`)."""
    b, _, _ = x_proj.shape
    h = h0 if h0 is not None else torch.zeros((b, w_hh.shape[1]), dtype=x_proj.dtype,
                                              device=x_proj.device)
    w_hh_t = w_hh.T
    outputs, saved = [], []
    for x_t in x_proj.unbind(1):
        h_proj = h @ w_hh_t + b_hh
        xr, xz, xn = x_t.chunk(3, dim=-1)
        hr, hz, hn = h_proj.chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        if save:
            saved.append(torch.stack([r, z, n, hn, h]))
        h = (1.0 - z) * n + z * h
        outputs.append(h)
    return torch.stack(outputs, dim=1), h, torch.stack(saved, dim=2) if save else None


def gru_bwd_plain(dout: torch.Tensor, dh_final: Optional[torch.Tensor], saved: torch.Tensor,
                  w_hh: torch.Tensor):
    """Plain PyTorch version of the backward kernel: the output cotangent
    dout (B, F, H), the final state's dh_final (B, H) or None (zeros), the
    forward's saved (5, B, F, H) and w_hh (3H, H) → (d(x_proj) (B, F, 3H),
    d(hp) (B, F, 3H), the initial state's cotangent (B, H)).  The
    hand-derived chain of gru_bwd.cu, frame by frame from the last."""
    r, z, n, hn, h_prev = saved.unbind(0)
    carry = dh_final if dh_final is not None else torch.zeros_like(dout[:, 0])
    frames = dout.shape[1]
    dxp, dhp = [None] * frames, [None] * frames
    for t in reversed(range(frames)):
        r_t, z_t, n_t, hn_t = r[:, t], z[:, t], n[:, t], hn[:, t]
        dh = dout[:, t] + carry
        dn = dh * (1.0 - z_t)
        dz = dh * (h_prev[:, t] - n_t)
        da_n = dn * (1.0 - n_t * n_t)
        dhn = da_n * r_t
        da_r = (da_n * hn_t) * (r_t * (1.0 - r_t))
        da_z = dz * (z_t * (1.0 - z_t))
        dxp[t] = torch.cat([da_r, da_z, da_n], dim=-1)
        dhp[t] = torch.cat([da_r, da_z, dhn], dim=-1)
        carry = dhp[t] @ w_hh + dh * z_t
    return torch.stack(dxp, dim=1), torch.stack(dhp, dim=1), carry


def gru_fwd(x_proj: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
            h0: Optional[torch.Tensor] = None, save: bool = True):
    """The recurrence's forward: x_proj (B, F, 3H), w_hh (3H, H), b_hh (3H),
    h0 (B, H) or None (zeros), all of one type, contiguous on one device →
    (out (B, F, H), h_final (B, H), saved (5, B, F, H), or None where not
    `save`).

    CPU tensors run the plain version (float64 too); float32 CUDA tensors
    launch the kernel `gru_fwd`."""
    if x_proj.dim() != 3 or w_hh.dim() != 2 or w_hh.shape[0] != 3 * w_hh.shape[1]:
        raise ValueError(f"need x_proj (B, F, 3H), w_hh (3H, H); got {tuple(x_proj.shape)}, "
                         f"{tuple(w_hh.shape)}")
    b, f, _ = x_proj.shape
    hidden = w_hh.shape[1]
    if x_proj.shape[2] != 3 * hidden or b_hh.shape != (3 * hidden,) or f < 1:
        raise ValueError(f"need x_proj (B, F ≥ 1, {3 * hidden}), b_hh ({3 * hidden},); got "
                         f"{tuple(x_proj.shape)}, {tuple(b_hh.shape)}")
    if h0 is not None and h0.shape != (b, hidden):
        raise ValueError(f"need h0 ({b}, {hidden}); got {tuple(h0.shape)}")
    kernels.check_operands({"x_proj": x_proj, "w_hh": w_hh, "b_hh": b_hh, "h0": h0})
    if x_proj.device.type == "cpu":
        return gru_fwd_plain(x_proj, w_hh, b_hh, h0, save)
    if hidden > MAX_KERNEL_HIDDEN:
        raise ValueError(f"the GRU kernels take H ≤ {MAX_KERNEL_HIDDEN}, got {hidden}")
    out = torch.empty((b, f, hidden), dtype=torch.float32, device=x_proj.device)
    h_final = torch.empty((b, hidden), dtype=torch.float32, device=x_proj.device)
    saved = (torch.empty((len(SAVED), b, f, hidden), dtype=torch.float32, device=x_proj.device)
             if save else None)
    if b == 0:
        return out, h_final, saved
    plan = (ctypes.c_int * 2)()
    kernels.launch("gru_fwd", x_proj, w_hh, b_hh, h0, out, h_final, saved, b, f, hidden, plan)
    plans["gru_fwd"] = tuple(plan)
    return out, h_final, saved


def gru_bwd(dout: torch.Tensor, dh_final: Optional[torch.Tensor], saved: torch.Tensor,
            w_hh: torch.Tensor):
    """The recurrence's backward: dout (B, F, H), dh_final (B, H) or None
    (zeros), the forward's saved (5, B, F, H) and w_hh (3H, H), all of one
    type, contiguous on one device → (d(x_proj) (B, F, 3H), d(hp) (B, F,
    3H), the initial state's cotangent (B, H)).

    CPU tensors run the plain version (float64 too); float32 CUDA tensors
    launch the kernel `gru_bwd`."""
    if dout.dim() != 3 or saved.shape != (len(SAVED), *dout.shape):
        raise ValueError(f"need dout (B, F, H), saved (5, B, F, H); got {tuple(dout.shape)}, "
                         f"{tuple(saved.shape)}")
    b, f, hidden = dout.shape
    if w_hh.shape != (3 * hidden, hidden) or f < 1:
        raise ValueError(f"need w_hh ({3 * hidden}, {hidden}) and F ≥ 1; got {tuple(w_hh.shape)}, F = {f}")
    if dh_final is not None and dh_final.shape != (b, hidden):
        raise ValueError(f"need dh_final ({b}, {hidden}); got {tuple(dh_final.shape)}")
    kernels.check_operands({"dout": dout, "dh_final": dh_final, "saved": saved, "w_hh": w_hh})
    if dout.device.type == "cpu":
        return gru_bwd_plain(dout, dh_final, saved, w_hh)
    if hidden > MAX_KERNEL_HIDDEN:
        raise ValueError(f"the GRU kernels take H ≤ {MAX_KERNEL_HIDDEN}, got {hidden}")
    dxp = torch.empty((b, f, 3 * hidden), dtype=torch.float32, device=dout.device)
    dhp = torch.empty((b, f, 3 * hidden), dtype=torch.float32, device=dout.device)
    dh0 = torch.empty((b, hidden), dtype=torch.float32, device=dout.device)
    if b == 0:
        return dxp, dhp, dh0
    plan = (ctypes.c_int * 2)()
    kernels.launch("gru_bwd", dout, dh_final, saved, w_hh, dxp, dhp, dh0, b, f, hidden, plan)
    plans["gru_bwd"] = tuple(plan)
    return dxp, dhp, dh0


class GRURecurrence(torch.autograd.Function):
    """The recurrence with its analytic backward: `gru_fwd` forward (saving
    r, z, n, hp_n and h_{t−1}), `gru_bwd` backward, then dW_hh = Σ d(hp)ᵀ·
    h_{t−1} and db_hh = Σ d(hp) over all B·F rows (the kernels on float32
    CUDA tensors, the plain versions on CPU tensors).  Inputs x_proj
    (B, F, 3H), w_hh (3H, H), b_hh (3H), h0 (B, H) or None → (out (B, F, H),
    h_final (B, H))."""

    @staticmethod
    def forward(ctx, x_proj, w_hh, b_hh, h0):
        out, h_final, saved = gru_fwd(x_proj, w_hh, b_hh, h0)
        ctx.save_for_backward(w_hh, saved)
        ctx.set_materialize_grads(False)  # an unused final state's cotangent stays None
        return out, h_final

    @staticmethod
    def backward(ctx, dout, dh_final):
        w_hh, saved = ctx.saved_tensors
        hidden = w_hh.shape[1]
        # the cotangents can arrive non-contiguous from the slices and
        # concatenations after the GRU
        dout = torch.zeros_like(saved[0]) if dout is None else dout.contiguous()
        dh_final = None if dh_final is None else dh_final.contiguous()
        dxp, dhp, dh0 = gru_bwd(dout, dh_final, saved, w_hh)
        d = dhp.reshape(-1, 3 * hidden)
        dw_hh = d.T @ saved[SAVED.index("h_prev")].reshape(-1, hidden)
        return dxp, dw_hh, d.sum(0), dh0 if ctx.needs_input_grad[3] else None


def gru_recurrence(x_proj: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                   h0: Optional[torch.Tensor] = None):
    """(out (B, F, H), h_final (B, H)) of the recurrence, the one choice
    between the kernels and the loop.  Where `kernel_takes`: through
    `GRURecurrence` where a gradient is wanted, else one `gru_fwd` that
    saves nothing.  Everywhere else (the CPU, float64, a larger H, a wide
    batch of few frames): the loop, `gru_fwd_plain` under autograd, saving
    nothing."""
    if not kernel_takes(x_proj, w_hh.shape[1]):
        return gru_fwd_plain(x_proj, w_hh, b_hh, h0, save=False)[:2]
    h0 = h0.contiguous() if h0 is not None else None
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x_proj, w_hh, b_hh, h0)):
        return GRURecurrence.apply(x_proj, w_hh, b_hh, h0)
    out, h_final, _ = gru_fwd(x_proj, w_hh, b_hh, h0, save=False)
    return out, h_final
