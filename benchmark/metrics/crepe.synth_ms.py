"""Device ms a step of the CREPE step's batch synthesis (its draws and
`synth_batch`): the step-mark phase `synth` (train_crepe.py `CrepeTrainer`,
training/profiling.py `CREPE_PHASES`); the median over the window's steps
after the traced group whose marks were read (the last of each group,
which the loss's pull lets finish)."""

from benchmark.lib.calls import median, phase_ms


def read(run):
    return median(run, lambda r: phase_ms(r, "synth"))
