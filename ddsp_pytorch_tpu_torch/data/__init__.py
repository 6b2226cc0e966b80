"""Feature cache and loaders (port of ddsp_pytorch_tpu.data, the part the
training path reads)."""

from ddsp_pytorch_tpu_torch.data.dataset import (  # noqa: F401
    DataLoader,
    Datamodule,
    DeviceDataLoader,
    Dataset,
    dict_collate,
)
