"""Share (%) of the card's float32 peak: the operations one RAVE phase-1
step needs (lib/rave_flops.py `train_step_flops`: the convolutions'
products, the PQMF's and the loss's FFTs) over the traced run's untraced
step time."""

from benchmark.lib import rave_flops
from benchmark.lib.flops import PEAK_FP32_FLOPS


def read(run):
    # another model's run holds no RAVE step to count (the harness's tests
    # read every train_step_ms reader on a new decoder cell)
    if run.cfg["model"].get("name") != "rave-v1":
        return None
    ops = sum(rave_flops.train_step_flops(run.cfg).values())
    return 100.0 * ops / run.layer["step_s"] / PEAK_FP32_FLOPS
