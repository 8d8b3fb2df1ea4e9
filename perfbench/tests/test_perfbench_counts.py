"""The operation and byte counts against hand counts at the cells'
shapes."""

import numpy as np
import pytest

from perfbench import harness
from perfbench.yardstick import counts
from perfbench.yardstick.peaks import PEAK_HBM_BYTES_S

LSTM = harness.load_json(harness.PKG / "configs" / "lstm_flagship.json")
WD = harness.load_json(harness.PKG / "configs" / "wide_deep_100m.json")


def test_lstm_training_step():
    # layer 1: 2 (11 + 512) 2048; layer 2: 2 (512 + 512) 2048
    per_step = 2 * 523 * 2048 + 2 * 1024 * 2048
    assert counts.lstm_flops_per_step(11, 512, 2) == per_step == 6_336_512
    fam = harness.load_part("families", "lstm")
    step = fam.train_flops_per_sample(LSTM) * 2048
    assert step == 3 * 2048 * (64 * per_step + 2 * 512 * 7)
    assert step == pytest.approx(2.4917e12, rel=1e-4)


def test_k1_k2_at_the_training_shape():
    nbytes, flops = counts.k1_call("bfloat16", 2048, 64, 512, True)
    tbh = 64 * 2048 * 512
    assert nbytes == 2 * (10 * tbh + 512 * 2048) + 16 * 512 == 1_344_282_624
    assert flops == 2 * tbh * 2048
    nbytes, flops = counts.k2_call("bfloat16", 2048, 64, 512)
    assert flops == 541_165_879_296
    assert nbytes == 2 * (11 * tbh + 2 * 512 * 2048) + 2 * 16 * 512
    least = counts.least_seconds(nbytes, flops, "bfloat16")
    assert least == pytest.approx(541_165_879_296 / 989e12)


def test_k1_serving_bucket():
    nbytes, flops = counts.k1_call("float32", 128, 64, 512, False)
    tbh = 64 * 128 * 512
    assert flops == 17_179_869_184
    assert nbytes == 4 * (5 * tbh + 512 * 2048) + 16 * 512
    assert counts.least_seconds(nbytes, flops, "float32") == \
        pytest.approx(flops / 67e12)


def test_wide_deep_rows():
    deep = 2 * (1760 * 2048 + 2048 * 1024 + 1024 * 512 + 512 * 7)
    assert counts.wide_deep_flops_per_row(WD) == deep + 2 * 1040 * 7
    fam = harness.load_part("families", "wide_deep")
    assert fam.train_flops_per_sample(WD) * 8192 == pytest.approx(
        3.0655e11, rel=1e-4)


def test_k4_bounds_by_hand():
    # two rows, two positions, vocabulary 4, width 3; ids 1 and 1 repeat
    # in position 0, one id is out of range
    ids = np.array([[1, 2], [1, 9]])
    (fwd, adds), (dw, adds_b) = counts.k4_calls(ids, 4, 3, "bfloat16")
    assert adds == adds_b == 3 * 3
    # K4a: ids (4 B each), rows (0,1) and (1,2): 2 distinct x 3 x 2 B,
    # out 2 x 3 x 4 B
    assert fwd == 4 * 4 + 2 * 3 * 2 + 2 * 3 * 4
    # K4b: ids, dH 2 x 3 x 2 B, dense block 2 x 4 x 3 x 2 B
    assert dw == 4 * 4 + 2 * 3 * 2 + 2 * 4 * 3 * 2


def test_k4_at_the_cell_shape():
    fam = harness.load_part("families", "wide_deep")
    x, _ = fam.batches(WD, {"batch": 8192, "pool_batches": 1}, 5)[0]
    ids = fam.pair_ids(x, 64)
    assert ids.shape == (8192, 21) and ids.min() >= 0 and ids.max() < 4096
    (fwd, _), (dw, _) = counts.k4_calls(ids, 4096, 1040, "bfloat16")
    # the dense block of K4b alone is 21 x 4096 x 1040 bf16
    assert dw > 21 * 4096 * 1040 * 2
    assert dw / PEAK_HBM_BYTES_S == pytest.approx(5.9e-5, rel=0.05)
    assert 0 < fwd / PEAK_HBM_BYTES_S < 5e-5
