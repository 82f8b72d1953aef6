"""Training: the loss family, the LR schedule, the train step, checkpoints,
the Trainer and LoRA."""

from pangu_tpu_torch.train.step import (  # noqa: F401
    Batch,
    TrainState,
    loss_fn,
    make_eval_step,
    make_forward,
    make_optimizer,
    make_train_step,
)
