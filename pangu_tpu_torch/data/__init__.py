"""Data stores, the date-range dataset and the batch loader of the port."""

from pangu_tpu_torch.data.dataset import (  # noqa: F401
    BatchLoader,
    Era5Dataset,
    NetCDFStore,
    NpyStore,
    PtStore,
    SyntheticStore,
    make_loader,
    make_store,
)
