"""The Pangu-Weather model in PyTorch, and FuXi's (``model.fuxi``, imported
where it is first named, so that Pangu's paths never load it)."""

from pangu_tpu_torch.model.pangu import PanguModel  # noqa: F401

_FUXI = ("FuxiConfig", "FuxiConstants", "FuxiModel", "fuxi_short", "fuxi_tiny")


def __getattr__(name: str):
    if name in _FUXI:
        from pangu_tpu_torch.model import fuxi

        return getattr(fuxi, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
