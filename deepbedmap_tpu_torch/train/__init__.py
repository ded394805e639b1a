"""Training subsystem of the port: the train state and Adam (``state``), the
D+G train and eval steps (``steps``), the epoch loop and ``fit``
(``loop``), and checkpoints: the port's own train state and the Chainer-npz
weight import and export (``checkpoint``)."""

from deepbedmap_tpu_torch.train.state import GANState, create_gan_state  # noqa: F401
from deepbedmap_tpu_torch.train.steps import (  # noqa: F401
    StepMetrics,
    make_eval_step,
    make_train_step,
)
from deepbedmap_tpu_torch.train.loop import fit, train_epoch  # noqa: F401
