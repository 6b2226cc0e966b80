"""Feature cache, loaders, the synthetic corpus, preprocessing (with the
hybrid, crepe and yin pitch trackers), sigmund-wav ingestion, NSynth views
and the out-of-family fixtures (port of ddsp_pytorch_tpu.data; fixtures.py
is imported by its module path)."""

from ddsp_pytorch_tpu_torch.data.dataset import (  # noqa: F401
    DataLoader,
    Datamodule,
    DeviceDataLoader,
    Dataset,
    dict_collate,
)
from ddsp_pytorch_tpu_torch.data.preprocess import get_files, preprocess, preprocess_folder  # noqa: F401
from ddsp_pytorch_tpu_torch.data.synthetic import INSTRUMENTS, make_synthetic_dataset  # noqa: F401
