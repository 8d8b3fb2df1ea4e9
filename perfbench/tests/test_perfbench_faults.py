"""``correct`` comes out false with the timed path broken underneath, and
under the control; a sound run reads far below a broken one. Every run
here is a whole harness run (set-up, window, comparison) at a tiny size
on the CPU, judged by the cells' own limits."""

import pytest

from perfbench import faults, harness
from perfbench.tests.helpers import tiny_run

TRAIN = ["lstm.train.b2048", "widedeep.train.b8192"]
SERVE = ["lstm.serve.p95"]
CASES = ([(c, "unchanged") for c in TRAIN]
         + [(c, "half_batch") for c in TRAIN + SERVE]
         + [(c, "altered") for c in TRAIN + SERVE])


def _kind(cell):
    return "serve" if cell in SERVE else "train"


def _over(result):
    return [n for n, c in result["checks"].items()
            if c["limit"] is not None and c["value"] > c["limit"]]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_planted_fault_is_not_correct(cell, fault):
    args = () if fault == "unchanged" else (_kind(cell),)
    with faults.FAULTS[fault](*args):
        broken = tiny_run(cell)
    assert broken["correct"] is False
    assert _over(broken), broken["checks"]


@pytest.mark.parametrize("cell", TRAIN + SERVE)
def test_a_sound_run_reads_below_a_broken_one(cell):
    sound = tiny_run(cell)
    with faults.altered(_kind(cell)):
        broken = tiny_run(cell)
    worst = max(c["value"] / c["limit"] for c in sound["checks"].values())
    assert worst < max(c["value"] / c["limit"]
                       for c in broken["checks"].values())


@pytest.mark.parametrize("cell", TRAIN + SERVE)
def test_the_control_is_not_correct(cell):
    """The control (the reference in the precision below the configured
    one) fails one of the cell's numbers."""
    from perfbench.tests.helpers import TINY

    ctx = harness.make_context(cell, 4242, 0.3, False, device="cpu",
                               overrides=TINY[cell], pending=True)
    drv = harness.load_part("drivers", ctx.traffic["driver"]).Driver(ctx)
    ctx.work = drv.window(0.3)
    rounding = "tf32" if cell in SERVE else "fp8"
    ok, checks = harness.judge(drv.control(rounding),
                               harness.limits_of(cell))
    assert ok is False, checks


@pytest.mark.chip
@pytest.mark.parametrize("cell", TRAIN + SERVE)
def test_the_control_on_the_card(card, cell):
    """The control at the cell's own size on the card, three seeds."""
    rounding = "tf32" if cell in SERVE else "fp8"
    for seed in (101, 102, 103):
        ctx = harness.make_context(cell, seed, 1.0, False, pending=True)
        drv = harness.load_part("drivers", ctx.traffic["driver"]).Driver(ctx)
        ctx.work = drv.window(1.0)
        ok, checks = harness.judge(drv.control(rounding),
                                   harness.limits_of(cell))
        assert ok is False, checks
