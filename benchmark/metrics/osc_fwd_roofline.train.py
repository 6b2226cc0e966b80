"""Share (%) of its bound the forward oscillator kernel reached in the
traced call, at the step's rows (batch × frames)."""

from benchmark.lib import flops
from benchmark.lib.layer import roofline_pct


def read(run):
    return roofline_pct(run, "oscillator_fwd", run.layer["rows"], flops.oscillator_fwd_cost)
