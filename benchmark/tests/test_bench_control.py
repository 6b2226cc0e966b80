"""The control comes out not correct, on the card only, at the cell's own
size.  Served cell: the plain reference in the program's place with TF32
products (one precision below the configuration's float32), over a shorter
stream than the window.  Training cells: the program's own bf16 NN (model
dtype bfloat16), the lower-precision path it has, through the same numbers
`correct` compares (TF32 moves the training loss by 2–5× float32's own
rounding only, under any limit that sound runs keep: PERF.md gives the
readings)."""

import pytest
import torch

from benchmark import harness


def _cell(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    return harness.load_cell(harness.benchmark_spec(), name)[1:]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["decoder.train_b16", "autoencoder.train_b16"])
def test_the_programs_bf16_path_fails_a_training_limit(cell):
    cfg, c = _cell(cell)
    from benchmark.tools.control import train_readings

    numbers = train_readings(cfg, c["params"], 3, torch.device("cuda", 0))["program_bf16"]
    assert not all(numbers[k] <= lim for k, lim in c["limits"].items()), numbers
