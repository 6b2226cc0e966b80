"""Operation and byte counts against values worked out by hand."""

import math

from benchmark.lib import flops


def test_oscillator_costs():
    # R=2 rows, K=3 harmonics, S=4 samples
    assert flops.oscillator_fwd_cost(2, 3, 4) == (4 * 2 * 5 + 4 * 2 * 4, 4 * 2 * 4 * 3)
    assert flops.oscillator_bwd_cost(2, 3, 4) == (4 * 2 * (4 + 6 + 4), 8 * 2 * 4 * 3)


def test_bound_takes_the_larger_time():
    t, by = flops.bound_s(3.35e12, 1.0)
    assert math.isclose(t, 1.0) and by == "bytes"
    t, by = flops.bound_s(1.0, 67e12)
    assert math.isclose(t, 1.0) and by == "operations"


def test_rfft_flops():
    assert flops.rfft_flops(8) == 2.5 * 8 * 3


def test_nn_flops_per_frame_by_hand():
    dec = {"name": "single-inst-decoder", "hidden_size": 2, "n_harmonic": 1, "n_bands": 3}
    # mlp(1): 2·1·2 + 2·(2·2·2) = 20, twice; mlp(h+2=4): 2·4·2 + 16 = 32
    # gru: 2·4·6 + 2·2·6 = 72; projections 2·2·2 + 2·2·3 = 20
    assert flops.nn_flops_per_frame(dec) == 20 + 20 + 32 + 72 + 20
    ae = dict(dec, name="mfcc-autoencoder")
    # gru input 3h = 6: 2·6·6 = 72 (not 48); z mlp(16): 2·16·2 + 16 = 80;
    # encoder gru 2·30·6 + 2·2·6 = 384, dense 2·2·16 = 64
    assert flops.nn_flops_per_frame(ae) == 20 + 20 + 32 + 72 + 24 + 20 + 80 + 384 + 64


def test_train_step_flops_parts():
    cfg = {"model": {"name": "single-inst-decoder", "hidden_size": 2, "n_harmonic": 1, "n_bands": 3,
                     "block_size": 4, "has_reverb": False},
           "train": {"batch": 1, "scales": [8], "overlap": 0.75},
           "preprocess": {"signal_length": 8}}
    parts = flops.train_step_flops(cfg)
    rows = 2
    assert parts["nn"] == 3 * 164 * rows
    assert parts["oscillator"] == 4 * rows * 4 * 1 + 8 * rows * 4 * 1
    # hop 2: 1 + 8 // 2 = 5 frames of an 8-point transform, three passes
    assert parts["loss_stft"] == 3 * 5 * 60
    conv, design = flops.rfft_flops(8), flops.rfft_flops(4)
    assert parts["noise_fft"] == rows * (2 * design + 5 * conv)
    assert "reverb_fft" not in parts
