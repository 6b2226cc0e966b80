"""Share (%) of the card's float32 peak: the operations one step needs
(lib/flops.py train_step_flops) over the traced run's untraced step time."""

from benchmark.lib import flops


def read(run):
    ops = sum(flops.train_step_flops(run.cfg).values())
    return 100.0 * ops / run.layer["step_s"] / flops.PEAK_FP32_FLOPS
