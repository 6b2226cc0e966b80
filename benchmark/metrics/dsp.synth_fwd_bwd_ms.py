"""Device ms a step of the synths and the reverb, forward and backward,
inside the real train step: the step-mark phases `synth_fwd` +
`synth_bwd` (training/profiling.py); the median over the window's calls
after the traced one."""

from benchmark.lib.calls import median, phase_ms


def read(run):
    return median(run, lambda r: phase_ms(r, "synth_fwd", "synth_bwd"))
