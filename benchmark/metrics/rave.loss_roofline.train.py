"""Share (%) of its bound that RAVE's form of the loss's hand-written
passes reached in the traced call: the bytes the norms and the
loss-and-gradient kernels read and write a step (lib/rave_flops.py
`rave_loss_bytes`) at 3.35 TB/s, over their device time a step, the
kernels found by name (`stft_rave_norms_kernel`,
`stft_rave_loss_grad_kernel`, ops/kernels/stft_loss.cu).  None where none
ran."""

from benchmark.lib import rave_flops
from benchmark.lib.flops import PEAK_HBM_BYTES


def read(run):
    if run.trace is None or run.trace.device.type != "cuda":
        return None
    kernels = [k for name in rave_flops.LOSS_KERNELS for k in run.trace.kernels(name)]
    if not kernels:
        return None
    device_s = sum(e - s for _, s, e in kernels) / 1e9 / run.layer["traced_steps"]
    tc = run.cfg["train"]
    nbytes = rave_flops.rave_loss_bytes(run.cfg["model"], tc, tc["batch"], run.cfg["preprocess"]["signal_length"])
    return 100.0 * nbytes / PEAK_HBM_BYTES / device_s
