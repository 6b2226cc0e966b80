"""The RAVE training kind at a tiny size on the CPU (the card's check
skipped): a sound run ends correct from the benchmark's own weights and
crops, and each of the four compared numbers catches a fault planted in
the program under it; the harness finds the new cell's files by name and
reports it train_step_ms, setup_s and the per-layer metrics that read its
step; lib/rave_flops.py's counts against a count by hand; the weights'
names and shapes are the program's."""

import json
import os
import shutil
import time

import pytest
import torch

from benchmark import harness
from benchmark.harness import HERE
from benchmark.lib import rave_flops, rave_weights

CPU = torch.device("cpu")
CELL = "rave.train_b8"
# float32 at the tiny size on the CPU, three seeds: loss ≤ 1.9e-7, update ≤ 1.4e-2, stats ≤ 1.3e-6;
# grad (the median leaf's) ≤ 3.2e-4 over three other seeds, the halved gradient 0.41
LIMITS = {"loss_gap": 1e-5, "grad_gap": 1e-2, "update_gap": 0.1, "stats_gap": 1e-4}
NEW_METRICS = {"rave.encode_ms", "rave.decode_ms", "rave.loss_ms", "rave.bwd_ms", "rave.conv_roofline.train",
               "mfu.rave_train", "rave.loss_roofline.train"}
METRICS = NEW_METRICS | {"trainer.optimizer_ms", "device_idle_pct.train", "trainer.launch_ms", "trainer.graph_nodes"}
TINY = {"n_band": 4, "pqmf_taps": 95, "capacity": 4, "latent_size": 8, "ratios": [2, 2], "noise_ratios": [2, 2],
        "loudness_n_fft": 256, "loudness_hop": 64}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tiny_cfg():
    cfg = harness.load_json(os.path.join(HERE, "configs", "rave-v1.json"))
    cfg["model"].update(TINY)
    cfg["preprocess"]["signal_length"] = 1024
    cfg["train"].update(scales=[128, 64], batch=2)
    cfg["assumed"]["steps_per_call"] = 4
    return cfg


def _tiny(root):
    """A benchmark folder holding the cell at the tiny size."""
    os.makedirs(os.path.join(root, "configs"))
    os.makedirs(os.path.join(root, "workloads"))
    shutil.copytree(os.path.join(HERE, "metrics"), os.path.join(root, "metrics"))
    with open(os.path.join(root, "configs", "rave-v1.json"), "w") as f:
        json.dump(_tiny_cfg(), f)
    cell = harness.load_json(os.path.join(HERE, "workloads", CELL + ".json"))
    cell.update(params=dict(cell["params"], settle_s=0.0, corpus_items=6), limits=LIMITS)
    with open(os.path.join(root, "workloads", CELL + ".json"), "w") as f:
        json.dump(cell, f)
    return root


def _run(tmp_path, trace=False, seed=2**33 + 25):
    d = _tiny(str(tmp_path / "b"))
    return harness.run_cell(harness.benchmark_spec(), CELL, seed, 0.2, trace, CPU, time.monotonic(), bench_dir=d)


def test_the_cells_files_are_found_by_name():
    spec = harness.benchmark_spec()
    entry, cfg, cell = harness.load_cell(spec, CELL)
    assert entry["chips"] == 1 and cell["kind"] == "rave_train" and cfg["model"]["capacity"] == 64
    assert harness.load_kind(cell["kind"]).run
    assert set(cell["limits"]) == {"loss_gap", "grad_gap", "update_gap", "stats_gap"}
    for m in NEW_METRICS:
        assert os.path.exists(os.path.join(HERE, "metrics", m + ".py"))


def test_metrics_for_gives_the_cell_its_own_metrics():
    spec = harness.benchmark_spec()
    assert [m["name"] for m in harness.metrics_for(spec, CELL, "end_to_end")] == ["train_step_ms", "setup_s"]
    assert {m["name"] for m in harness.metrics_for(spec, CELL, "per_layer")} == METRICS
    for other in ("decoder.train_b16", "autoencoder.train_b16", "crepe.train_b256"):
        assert not NEW_METRICS & {m["name"] for m in harness.metrics_for(spec, other, "per_layer")}


def test_the_weights_are_the_programs_names_and_shapes():
    from ddsp_pytorch_tpu_torch.models import load_model
    from benchmark.kinds.rave_train import PROGRAM_KEYS

    cfg = _tiny_cfg()
    model = load_model("rave-v1", {k: cfg["model"][k] for k in PROGRAM_KEYS})
    weights = rave_weights.make_weights(cfg, 5, CPU)
    model.load_state_dict(weights, strict=True)
    assert {k: tuple(v.shape) for k, v in weights.items()} == {k: tuple(v.shape) for k, v in model.state_dict().items()}
    full = harness.load_json(os.path.join(HERE, "configs", "rave-v1.json"))
    spec = rave_weights.param_spec(full["model"])
    assert sum(int(torch.Size(s).numel()) for n, s, k, _ in spec if k not in ("count",) and ".running_" not in n) \
        == full["model"]["parameters"]


def test_a_sound_run_is_correct_and_reports_its_line(tmp_path):
    run = _run(tmp_path, trace=True)
    assert run.correct, run.checks
    assert run.attempted > 0 and run.failed == 0
    line = harness.result_line(harness.benchmark_spec(), CELL, run, True, "cpu", bench_dir=str(tmp_path / "b"))
    # off a card the readers of the step marks and the kernels find nothing; the
    # host-clock share reads, and the shared idle reader finds no device operation
    assert set(line["metrics"]) == {"mfu.rave_train", "device_idle_pct.train"} and list(line)[-1] == "checks"
    plain = harness.result_line(harness.benchmark_spec(), CELL, run, False, "cpu", bench_dir=str(tmp_path / "b"))
    assert set(plain["metrics"]) == {"train_step_ms", "setup_s"}


def _planted(monkeypatch, fault):
    from ddsp_pytorch_tpu_torch.training import loss as loss_mod
    from ddsp_pytorch_tpu_torch.training import train as train_mod

    if fault == "ddsp_distance":  # RAVE's linear term replaced by DDSP's mean L1
        from ddsp_pytorch_tpu_torch.ops import multiscale_fft

        def distance(x, y, scales, overlap):
            t = y.shape[-1]
            ori = multiscale_fft(x.reshape(-1, t), scales, overlap)
            rec = multiscale_fft(y.reshape(-1, t), scales, overlap)
            return loss_mod.multiscale_spec_loss(ori, rec)

        monkeypatch.setattr(loss_mod, "rave_distance", distance)
    elif fault == "halved_gradient":  # the distance's value kept, its gradient halved
        real_distance = loss_mod.rave_distance

        def halved(x, y, scales, overlap):
            d = real_distance(x, y, scales, overlap)
            return 0.5 * d + 0.5 * d.detach()

        monkeypatch.setattr(loss_mod, "rave_distance", halved)
    elif fault == "state_unchanged":  # the update written nowhere
        real = train_mod._update_in_place

        def update(state, tx, loss, grads):
            saved = [p.detach().clone() for p in state.params()]
            out = real(state, tx, loss, grads)
            with torch.no_grad():
                for p, s in zip(state.params(), saved):
                    p.copy_(s)
            return out

        monkeypatch.setattr(train_mod, "_update_in_place", update)
    elif fault == "batchnorm_momentum":  # running statistics at PyTorch's momentum halved
        from ddsp_pytorch_tpu_torch.models import rave as rave_mod

        real_init = rave_mod.Encoder.__init__

        def init(self, *args, **kwargs):
            real_init(self, *args, **kwargs)
            for norm in self.norms:
                norm.momentum = 0.05

        monkeypatch.setattr(rave_mod.Encoder, "__init__", init)


@pytest.mark.parametrize("fault,check", [("ddsp_distance", "loss_gap"), ("halved_gradient", "grad_gap"),
                                         ("state_unchanged", "update_gap"), ("batchnorm_momentum", "stats_gap")])
def test_each_compared_number_catches_its_fault(tmp_path, monkeypatch, fault, check):
    _planted(monkeypatch, fault)
    run = _run(tmp_path)
    value, limit = run.checks[check]
    assert value > limit and not run.correct, run.checks


def test_flops_by_hand_at_a_tiny_size():
    """M 2, C 1, latent 1, one ratio of 2, loud stride 1, 3 taps, crops of 8
    (bands of 4, 2 latent frames), batch 1."""
    m = {"n_band": 2, "capacity": 1, "latent_size": 1, "ratios": [2], "loud_stride": 1, "pqmf_taps": 3}
    costs = dict((name, (ops, nbytes)) for name, ops, nbytes in rave_flops.conv_costs(m, 1, 8))
    # analysis: 2 outputs of 4 samples, 3 taps each; x 8, kernel 6, y 8 floats
    assert costs["pqmf.analysis.forward"] == (2 * 2 * 4 * 3, 4 * (8 + 6 + 8))
    # encoder conv_in 2 → 1, width 7 over 4 samples; no input gradient
    assert costs["encoder.conv_in.forward"][0] == 2 * 1 * 2 * 7 * 4 and "encoder.conv_in.input_grad" not in costs
    # the strided conv 1 → 2, width 5, stride 2: 2 outputs
    assert costs["encoder.convs.0.input_grad"][0] == 2 * 2 * 1 * 5 * 2
    # conv_out 2 → 2 in 2 groups (1 input each), width 5, over 2 frames
    assert costs["encoder.conv_out.weight_grad"][0] == 2 * 2 * 1 * 5 * 2
    # the generator's transposed conv 2 → 1, width 4, over its 2 input frames
    assert costs["decoder.ups.0.forward"] == (2 * 2 * 1 * 4 * 2, 4 * (2 * 2 + 1 * 4 + 2 * 1 * 4 + 1))
    # the reconstruction's synthesis: 2 bands of 4 → 8 samples, 3 taps; forward and input gradient only
    assert costs["pqmf.synthesis.reconstruction.input_grad"][0] == 2 * 2 * 1 * 3 * 4
    assert "pqmf.synthesis.target.input_grad" not in costs and "pqmf.synthesis.reconstruction.weight_grad" not in costs
    names = [n for n, *_ in rave_flops.layers(m, 8)]
    assert len(names) == 1 + 3 + 1 + 1 + 6 + 2 + 2 and len(costs) == 1 + 2 + 3 * 2 + 3 + 3 * 7 + 3 * 2 + 1 + 2
    # the loss's transforms: bands 2 rows of 4, full band 1 row of 8, scale 4 hop 1
    tc = {"scales": [4], "overlap": 0.75}
    assert rave_flops.loss_fft_flops(m, tc, 1, 8) == 3 * (2 * 5 + 1 * 9) * 2.5 * 4 * 2
    # both passes of RAVE's form: 2 spectra read twice, the gradient written once, the partials
    count_b, count_f = 2 * 5 * 3, 1 * 9 * 3
    assert rave_flops.rave_loss_bytes(m, tc, 1, 8) == sum(5 * c * 8 + 5 * 8 for c in (count_b, count_f))


def test_the_published_step_is_144_gflop():
    cfg = harness.load_json(os.path.join(HERE, "configs", "rave-v1.json"))
    assert round(rave_flops.forward_macs(cfg["model"], 65536) / 1e9, 2) == 3.0
    parts = rave_flops.train_step_flops(cfg)
    assert 143e9 < parts["products"] < 145e9 and parts["pqmf"] < 2e9 and parts["loss_fft"] < 2e9
