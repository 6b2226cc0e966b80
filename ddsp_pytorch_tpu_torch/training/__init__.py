"""L4 — training: spectral loss, optimizers, train state and checkpoints,
the train/eval steps and the Trainer (port of ddsp_pytorch_tpu.training,
one device)."""

from ddsp_pytorch_tpu_torch.training.loss import (  # noqa: F401
    multiscale_spec_loss,
    spectral_loss_from_signals,
)
from ddsp_pytorch_tpu_torch.training.optim import Optimizer, make_optimizer  # noqa: F401
from ddsp_pytorch_tpu_torch.training.state import Checkpointer, TrainState  # noqa: F401
from ddsp_pytorch_tpu_torch.training.train import (  # noqa: F401
    Trainer,
    apply_gradient_update,
    loss_and_grads,
    make_eval_step,
    make_train_step,
)
