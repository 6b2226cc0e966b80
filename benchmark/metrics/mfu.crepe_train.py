"""Share (%) of the card's float32 peak: the operations one CREPE step
needs (lib/crepe_flops.py `train_step_flops`: the products and the
synthesis's FFTs) over the traced run's untraced step time."""

from benchmark.lib import crepe_flops
from benchmark.lib.flops import PEAK_FP32_FLOPS


def read(run):
    # another model's run holds no CREPE step to count (the harness's tests
    # read every train_step_ms reader on a new decoder cell)
    if run.cfg["model"].get("name") != "crepe":
        return None
    ops = sum(crepe_flops.train_step_flops(run.cfg).values())
    return 100.0 * ops / run.layer["step_s"] / PEAK_FP32_FLOPS
