"""Forecast step, rollout and the rollout engines of the port
(``aggregate`` imports pandas and is imported on its own)."""

from pangu_tpu_torch.rollout.autoregressive import make_forecast_step, rollout  # noqa: F401
from pangu_tpu_torch.rollout.engines import (  # noqa: F401
    ModelBundle,
    hierarchical_forecast,
    iterative_eval,
    multi_output_rollout,
    single_output_eval,
)
