"""The Pangu-Weather model in PyTorch."""

from pangu_tpu_torch.model.pangu import PanguModel  # noqa: F401
