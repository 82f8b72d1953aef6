"""Training: the loss family, the LR schedule and the train step."""

from pangu_tpu_torch.train.step import (  # noqa: F401
    Batch,
    loss_fn,
    make_eval_step,
    make_forward,
    make_optimizer,
    make_train_step,
)
