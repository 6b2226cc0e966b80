"""The port's voice ramp (ddsp_pytorch_tpu_torch/voice_ramp.py, the
counterpart of scripts/voice_ramp.py) on the CPU at a tiny width: the
report has the keys of the JAX script's record pretrained/voice_ramp_cpu.json
plus `card`, each row the record's row keys, and the entry point defaults to
the card.  Times taken here are CPU host times and mean nothing for the card."""

import json
import math
import os

import pytest
import torch

from ddsp_pytorch_tpu_torch import voice_ramp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--hidden", "16", "--harmonics", "8", "--pool", "2", "--ramp", "1,2", "--n-run", "1"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs six test workers on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_report_has_the_jax_records_keys(tmp_path, capsys):
    out = tmp_path / "ramp.json"
    report = voice_ramp.main(["--device", "cpu", *TINY, "--out", str(out)])
    with open(os.path.join(REPO, "pretrained", "voice_ramp_cpu.json")) as f:
        record = json.load(f)
    assert set(report) == set(record) | {"card"}
    assert report["card"] is None and report["platform"] == {"platform": "cpu", "device_kind": "cpu"}
    assert set(report["platform"]) == set(record["platform"])
    assert (report["pool"], report["block_samples"], report["block_ms"], report["engine_budget_ms"]) == \
        (2, 4096, record["block_ms"], record["engine_budget_ms"])
    assert report["voice"] == "8 harmonics, hidden 16, 48000 Hz"
    assert [r["voices"] for r in report["rows"]] == [1, 2]
    for row in report["rows"]:
        assert set(row) == set(record["rows"][0])
        assert math.isfinite(row["block_ms_best"]) and 0 < row["block_ms_best"] <= row["block_ms_mean"]
        assert row["realtime_ok"] == (row["block_ms_best"] <= report["block_ms"])
    with open(out) as f:
        assert json.load(f) == report
    printed = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(x) for x in printed[:2]] == report["rows"] and printed[-1] == f"wrote {out}"


def test_ramp_beyond_the_pool_is_refused():
    with pytest.raises(ValueError, match="--pool"):
        voice_ramp.main(["--device", "cpu", "--pool", "2", "--ramp", "1,4", "--hidden", "16"])


def test_entry_point_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where CUDA is missing")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        voice_ramp.main(TINY)
