"""The arrival generator: byte-identical for a seed, the same work for
every seed; latency runs from the due time."""

import threading
import time
from concurrent.futures import Future
from contextlib import nullcontext
from types import SimpleNamespace

import numpy as np
import pytest

from perfbench.yardstick import arrivals


def test_same_seed_same_bytes():
    a = arrivals.schedule(2**33 + 5, 10.0, 500.0, (17, 64))
    b = arrivals.schedule(2**33 + 5, 10.0, 500.0, (17, 64))
    assert a[0].tobytes() == b[0].tobytes()
    assert a[1].tobytes() == b[1].tobytes()


def test_every_seed_offers_the_same_work():
    runs = [arrivals.schedule(s, 10.0, 500.0, (17, 64)) for s in (1, 2, 3)]
    for due, size in runs:
        assert len(due) == 5000
        assert np.all(np.diff(due) >= 0)
        assert 0 < due[0] and due[-1] == pytest.approx(10.0)
        assert sorted(size.tolist()) == sorted(runs[0][1].tolist())
        gaps = np.sort(np.diff(np.concatenate([[0.0], due])))
        ref = np.sort(np.diff(np.concatenate([[0.0], runs[0][0]])))
        assert np.allclose(gaps, ref)
    assert not np.array_equal(runs[0][0], runs[1][0])
    assert not np.array_equal(runs[0][1], runs[1][1])
    assert set(runs[0][1].tolist()) == set(range(17, 65))


def test_rate_segments():
    # 1 s at 100/s then 1 s at 300/s, repeated over 4 s: 800 requests
    due, _ = arrivals.schedule(9, 4.0, [[1.0, 100.0], [1.0, 300.0]],
                               (1, 2))
    assert len(due) == 800
    first = np.sum(due < 1.0)
    second = np.sum((due >= 1.0) & (due < 2.0))
    assert first == pytest.approx(100, abs=35)
    assert second == pytest.approx(300, abs=60)


class _StallingEngine:
    """Answers at once, except that the first submit blocks the
    submitting thread for ``stall`` seconds."""

    def __init__(self, stall: float):
        self.stall, self.calls = stall, 0

    def submit(self, x):
        self.calls += 1
        if self.calls == 1:
            time.sleep(self.stall)
        f = Future()
        threading.Timer(0.001, f.set_result, (np.zeros(7, np.float32),)
                        ).start()
        return f

    def stats(self):
        return {"batches": 0, "sequences": 0}

    def close(self):
        pass


def test_latency_runs_from_the_due_time():
    from perfbench.drivers.serve_open import Driver

    drv = Driver.__new__(Driver)
    drv.ctx = SimpleNamespace(window_span=nullcontext)
    drv.eng = _StallingEngine(0.2)
    drv.jsonl = None
    drv.setup_parts = {}
    # 20 requests due in the first 10 ms: all wait out the first's stall
    drv.due = np.linspace(0.0005, 0.01, 20)
    drv.lens = np.full(20, 4)
    drv.histories = np.zeros((1, 4, 11), np.float32)
    drv.replies = [None] * 20
    work = drv.window(0.3)
    # from submission every request took ~1 ms; from its due time the
    # median one waited out the stall
    assert work["notes"]["tails"]["p50_ms"] > 150
    assert work["end_to_end"]["serve_p95_ms"] > 180
    assert work["failed"] == 0
