"""Share (%) of the traced call with no operation on the device."""

from benchmark.lib.layer import idle_pct


def read(run):
    return idle_pct(run)
