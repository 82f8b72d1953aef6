"""The Pangu-Weather model in PyTorch, and FuXi's and Aurora's
(``model.fuxi``, ``model.aurora``, each imported where it is first named, so
that Pangu's paths never load them)."""

from pangu_tpu_torch.model.pangu import PanguModel  # noqa: F401

_FUXI = ("FuxiConfig", "FuxiConstants", "FuxiModel", "fuxi_short", "fuxi_tiny")
_AURORA = ("AuroraConfig", "AuroraConstants", "AuroraModel", "aurora_pretrained", "aurora_tiny")


def __getattr__(name: str):
    if name in _FUXI:
        from pangu_tpu_torch.model import fuxi

        return getattr(fuxi, name)
    if name in _AURORA:
        from pangu_tpu_torch.model import aurora

        return getattr(aurora, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
