"""The port's workload traces and open-loop replay (obs/workload.py,
obs/replay.py, the ``replay`` and ``trace-export`` CLIs) against the JAX
package's: the seeded generators write byte-identical files, a trace
written by either package reads in the other, malformed and newer traces
are refused with the same messages, a seeded trace replays through both
packages' small engines to the same outputs within the NN pin, and
capture → export gives the same trace. Each behaviour mirrors a test of
tests/test_replay.py."""

import json

import jax
import numpy as np
import pytest
import torch

from euromillioner_tpu.models.lstm import build_lstm as jax_build_lstm
from euromillioner_tpu.obs import replay as jax_replay
from euromillioner_tpu.obs import workload as jax_workload
from euromillioner_tpu.serve import RecurrentBackend as JaxBackend
from euromillioner_tpu.serve import StepScheduler as JaxStepScheduler
from euromillioner_tpu.utils.errors import ServeError as JaxServeError
from euromillioner_tpu_torch import cli
from euromillioner_tpu_torch.models.convert import params_from_jax
from euromillioner_tpu_torch.models.lstm import build_lstm
from euromillioner_tpu_torch.obs import workload
from euromillioner_tpu_torch.obs.replay import payload_for, replay_trace
from euromillioner_tpu_torch.resilience import FaultPlan, FaultSpec, inject
from euromillioner_tpu_torch.serve.continuous import (RecurrentBackend,
                                                      StepScheduler)
from euromillioner_tpu_torch.utils.errors import ServeError

torch.set_num_threads(2)

FEAT = 11
WAIT = 60
# port vs JAX, f32 on both sides: the JAX package's NN trajectory pin
RTOL, ATOL = 1e-5, 1e-6
# a short trace: the replays below keep to a few seconds of wall
SHORT = dict(duration_s=1.0)


@pytest.fixture(scope="module")
def lstm():
    jm = jax_build_lstm(hidden=8, num_layers=2, out_dim=7, fused="off")
    params, _ = jm.init(jax.random.PRNGKey(0), (64, FEAT))
    tm = build_lstm(8, 2, 7, device="cpu")
    tm.load_state_dict(params_from_jax(jax.device_get(params), "cpu"))
    return (JaxBackend(jm, params, feat_dim=FEAT, compute_dtype=np.float32),
            RecurrentBackend(tm, feat_dim=FEAT, compute_dtype=torch.float32))


# -- the trace format ---------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("name", ["poisson_burst", "diurnal", "flash_crowd"])
def test_generators_write_byte_identical_files(tmp_path, name, seed):
    port = workload.write_trace(str(tmp_path / "port.jsonl"),
                                workload.generate(name, seed=seed))
    ref = jax_workload.write_trace(str(tmp_path / "jax.jsonl"),
                                   jax_workload.generate(name, seed=seed))
    got = open(port, "rb").read()
    assert got == open(ref, "rb").read()
    assert len(got.splitlines()) > 10


def test_a_trace_of_either_package_reads_in_the_other(tmp_path):
    a = workload.write_trace(str(tmp_path / "a.jsonl"),
                             workload.generate("flash_crowd", seed=3))
    b = jax_workload.write_trace(str(tmp_path / "b.jsonl"),
                                 jax_workload.generate("diurnal", seed=3))
    for path in (a, b):
        mine, theirs = workload.read_trace(path), jax_workload.read_trace(path)
        assert mine.meta == theirs.meta
        assert [vars(e) for e in mine.events] == [vars(e)
                                                  for e in theirs.events]
        assert mine.class_mix() == theirs.class_mix()


@pytest.mark.parametrize("lines", [
    ['{"trace_version": 2, "name": "x"}'],
    ['{"name": "no header"}'],
    ['{"trace_version": 1}', "not json"],
    ['{"trace_version": 1}', "[1, 2]"],
    ['{"trace_version": 1}', '{"t": -1, "class": "a", "family": "lstm", '
                             '"steps": 2}'],
    ['{"trace_version": 1}', '{"t": 0.1, "class": "", "family": "lstm", '
                             '"steps": 2}'],
    ['{"trace_version": 1}', '{"t": 0.1, "class": "a", "family": "lstm", '
                             '"steps": 2, "rows": 3}'],
    ['{"trace_version": 1}', '{"t": 0.1, "class": "a", "family": "lstm", '
                             '"steps": 2, "deadline_ms": -4}'],
    [],
], ids=["newer", "no_header", "bad_json", "not_object", "negative_t",
        "blank_class", "rows_and_steps", "negative_deadline", "empty"])
def test_bad_traces_are_refused_with_the_jax_messages(tmp_path, lines):
    path = tmp_path / "bad.jsonl"
    path.write_text("\n".join(lines) + ("\n" if lines else ""))
    with pytest.raises(ServeError) as mine:
        workload.read_trace(str(path))
    with pytest.raises(JaxServeError) as theirs:
        jax_workload.read_trace(str(path))
    assert str(mine.value) == str(theirs.value)


# -- replay against both packages' engines ----------------------------------

def test_a_seeded_trace_replays_to_the_jax_outputs(lstm):
    trace = workload.generate("poisson_burst", seed=0, **SHORT)
    jtrace = jax_workload.generate("poisson_burst", seed=0, **SHORT)
    jb, pb = lstm
    with StepScheduler(pb, max_slots=4, step_block=2, warmup=False,
                       slo_ms=(50, 2000)) as eng:
        for ev in trace.events[:3]:  # the payloads are the JAX package's
            assert np.array_equal(payload_for(ev, eng),
                                  jax_replay.payload_for(ev, eng))
        got = replay_trace(eng, trace, speed=4.0, collect=True,
                           timeout_s=WAIT)
    with JaxStepScheduler(jb, max_slots=4, step_block=2, warmup=False,
                          slo_ms=(50, 2000)) as jeng:
        want = jax_replay.replay_trace(jeng, jtrace, speed=4.0,
                                       collect=True, timeout_s=WAIT)
    assert got["errors"] == want["errors"] == 0
    assert got["completed"] == want["completed"] == len(trace.events)
    for g, w in zip(got["outputs"], want["outputs"]):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    assert set(got) == set(want)
    assert set(got["classes"]) == set(want["classes"])
    for cls in got["classes"]:
        assert set(got["classes"][cls]) == set(want["classes"][cls])
    assert set(got["engines"]["lstm"]) == set(want["engines"]["lstm"])
    assert set(got["engines"]["lstm"]["slo"]) == {"interactive", "bulk"}


def test_a_rerun_is_bit_identical_and_fifo_strips_the_classes(lstm):
    trace = workload.generate("flash_crowd", seed=1, **SHORT)
    runs = []
    for fifo in (False, False, True):
        with StepScheduler(lstm[1], max_slots=4, step_block=2,
                           warmup=False) as eng:
            runs.append(replay_trace(eng, trace, speed=4.0, fifo=fifo,
                                     collect=True, timeout_s=WAIT))
            if fifo:
                classes = eng.stats()["classes"]
    assert all(np.array_equal(a, b) for a, b in zip(runs[0]["outputs"],
                                                     runs[1]["outputs"]))
    assert runs[2]["fifo"] and classes["bulk"]["completed"] == 0


def test_replay_faults_fail_only_their_events(lstm):
    trace = workload.generate("poisson_burst", seed=2, **SHORT)
    plan = FaultPlan([FaultSpec("serve.replay", raises=RuntimeError,
                                hits=(2, 5))])
    with inject(plan):
        with StepScheduler(lstm[1], max_slots=4, step_block=2,
                           warmup=False) as eng:
            rep = replay_trace(eng, trace, speed=4.0, collect=True,
                               timeout_s=WAIT)
            st = eng.stats()
    n = len(trace.events)
    assert rep["errors"] == 2 and rep["submitted"] == n - 2
    assert rep["completed"] == n - 2 and st["failed"] == 0
    assert rep["outputs"][1] is None and rep["outputs"][4] is None


def test_bad_replay_arguments_are_refused(lstm):
    trace = workload.generate("diurnal", seed=0, **SHORT)
    with pytest.raises(ServeError, match="speed must be > 0"):
        replay_trace(object(), trace, speed=0.0)
    with pytest.raises(ServeError, match="no engine serves"):
        replay_trace({"nn": object()}, trace)


# -- capture, export and the CLIs --------------------------------------------

def test_capture_then_export_gives_the_same_events(tmp_path, lstm):
    cap = str(tmp_path / "cap.jsonl")
    rng = np.random.default_rng(4)
    lens = [3, 7, 2, 9]
    with StepScheduler(lstm[1], max_slots=2, step_block=2, warmup=False,
                       capture_path=cap) as eng:
        for i, n in enumerate(lens):
            eng.submit(rng.normal(size=(n, FEAT)).astype(np.float32),
                       cls=("interactive", "bulk")[i % 2],
                       max_wait_s=0.5 if i == 0 else None).result(WAIT)
    captured = workload.read_trace(cap)
    assert [e.steps for e in captured.events] == lens
    assert [e.cls for e in captured.events] == ["interactive", "bulk"] * 2
    assert captured.events[0].deadline_ms == 500.0
    out, jout = str(tmp_path / "out.jsonl"), str(tmp_path / "jout.jsonl")
    assert workload.export_trace(cap, out) == len(lens)
    assert jax_workload.export_trace(cap, jout) == len(lens)
    with open(out) as a, open(jout) as b:
        assert a.read().replace(out, "") == b.read().replace(jout, "")
    exported = workload.read_trace(out)
    assert exported.events[0].t == 0.0
    assert [(e.cls, e.steps, e.seed) for e in exported.events] == [
        (e.cls, e.steps, e.seed) for e in captured.events]


def test_replay_smoke_and_trace_export_through_the_cli(tmp_path, capsys):
    out = str(tmp_path / "t.jsonl")
    assert cli.main(["replay", "--smoke", "--generate", "diurnal",
                     "--seed", "1", "--out", out, "--speed", "8",
                     "--device", "cpu", "serve.scheduler=continuous",
                     "serve.obs.slo_ms=50,2000"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["errors"] == 0 and report["completed"] == report["events"]
    assert report["generator"] == "diurnal"
    assert workload.read_trace(out).meta["seed"] == 1
    exp = str(tmp_path / "e.jsonl")
    assert cli.main(["trace-export", "--jsonl", out, "--out", exp]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary == {"events": report["events"], "out": exp}
    assert cli.main(["replay", "--smoke", "--device", "cpu"]) == 2
    assert cli.main(["obs-top", "--once"]) == 2
