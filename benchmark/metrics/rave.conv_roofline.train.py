"""Share (%) of their bound RAVE's convolutions reached: the PQMF's
analysis and syntheses, the encoder's and the generator's convolutions,
forward, input and weight gradients (lib/rave_flops.py `conv_bound_s`,
each operator the larger of its operations at 67 TFLOP/s and its bytes at
3.35 TB/s), over the device time a step of the kernels that
`aten::cudnn_convolution`, `aten::cudnn_convolution_transpose` and
`aten::convolution_backward` launched (lib/op_trace.py: matched from the
kernel to its launch, never by kernel name) in the kind's eager run of the
step's bodies after the window (a graph replay's kernels carry no link to
their operators).  None where no such run or kernel is found."""

from benchmark.lib import rave_flops


def read(run):
    tracer = run.layer.get("eager_trace")
    if tracer is None:
        return None
    kernels = tracer.launched_by(rave_flops.CONV_OPS)
    if not kernels:
        return None
    device_s = sum(e - s for _, s, e in kernels) / 1e9
    tc = run.cfg["train"]
    return 100.0 * rave_flops.conv_bound_s(run.cfg["model"], tc["batch"],
                                           run.cfg["preprocess"]["signal_length"]) / device_s
