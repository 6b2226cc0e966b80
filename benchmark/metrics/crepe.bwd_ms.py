"""Device ms a step of the CREPE step's backward (`autograd.grad` over
every parameter): the step-mark phase `backward` (train_crepe.py
`CrepeTrainer`); the median over the window's read steps after the traced
group."""

from benchmark.lib.calls import median, phase_ms


def read(run):
    return median(run, lambda r: phase_ms(r, "backward"))
