"""Share (%) of their bound the CREPE step's products reached in the
traced group: the six convolutions and the classifier, forward, input and
weight gradients (lib/crepe_flops.py `conv_bound_s`, each operator the
larger of its operations at 67 TFLOP/s and its bytes at 3.35 TB/s), over
the device time a step of the kernels that `aten::cudnn_convolution` and
`aten::convolution_backward` launched (lib/op_trace.py: matched from the
kernel to its launch, never by kernel name).  None where none matched."""

from benchmark.lib import crepe_flops


def read(run):
    if run.trace is None or run.trace.device.type != "cuda":
        return None
    kernels = run.trace.launched_by(crepe_flops.CONV_OPS)
    if not kernels:
        return None
    device_s = sum(e - s for _, s, e in kernels) / 1e9 / run.layer["traced_steps"]
    return 100.0 * crepe_flops.conv_bound_s(run.cfg["model"], run.cfg["train"]["batch"]) / device_s
