"""Forecast step and rollout for the port."""

from pangu_tpu_torch.rollout.autoregressive import make_forecast_step, rollout  # noqa: F401
