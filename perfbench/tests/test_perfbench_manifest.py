"""BENCHMARK.json keeps to its contract and every part it names loads by
name."""

import json
import re

import pytest

from perfbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
WITH_PENDING = harness.load_bench(pending=True)
CELLS = [w["name"] for w in BENCH["workloads"]]
ALL_CELLS = [w["name"] for w in WITH_PENDING["workloads"]]
LAYER_METRICS = [m["name"] for m in WITH_PENDING["per_layer"]]


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    runs = 2 + 14 * 24
    assert (runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200) <= 43200


@pytest.mark.parametrize("bench", [BENCH, WITH_PENDING],
                         ids=["committed", "with_pending"])
def test_names_units_and_keys(bench):
    cells = [w["name"] for w in bench["workloads"]]
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] not in names
        names.add(c["name"])
        assert c["file"].startswith("perfbench/")
        assert (harness.ROOT / c["file"]).is_file()
        assert c["reduced"] == []
        assert harness.load_json(harness.ROOT / c["file"])["source"] == \
            c["source"]
    assert len(cells) == len(set(cells))
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert w["config"] in names and 1 <= len(w["why"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert names == {w["config"] for w in bench["workloads"]}
    metric_names = [m["name"] for m in bench["end_to_end"]
                    + bench["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    setup = next(m for m in bench["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] == 0.25


@pytest.mark.parametrize("cell", ALL_CELLS)
def test_each_cell_reports_what_it_must(cell):
    ctx = harness.make_context(cell, 1, 1.0, False, device="cpu",
                               pending=True)
    e2e = {m["name"] for m in harness.end_to_end_names(ctx)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = harness.per_layer_names(ctx)
    assert layer
    for m in WITH_PENDING["per_layer"]:
        if cell in m.get("workloads", []):
            assert m["moves"] in e2e


@pytest.mark.parametrize("cell", ALL_CELLS)
def test_parts_load_by_name(cell):
    ctx = harness.make_context(cell, 1, 1.0, False, device="cpu",
                               pending=True)
    driver = harness.load_part("drivers", ctx.traffic["driver"])
    assert hasattr(driver, "Driver")
    fam = harness.load_part("families", ctx.config["family"])
    assert callable(fam.build_model) and callable(fam.weights)
    limits = harness.limits_of(cell)
    assert limits, f"no limits for {cell}"
    for name, limit in limits.items():
        assert limit > 0, name


@pytest.mark.parametrize("metric", LAYER_METRICS)
def test_each_reader_loads(metric):
    assert callable(harness.load_part("metrics", metric).read)


def test_a_pending_cell_is_not_run():
    """A cell kept under ``pending/`` is refused by the benchmark's runs."""
    pending = set(ALL_CELLS) - set(CELLS)
    assert pending
    for cell in pending:
        with pytest.raises(harness.Refused) as e:
            harness.make_context(cell, 1, 1.0, False, device="cpu")
        assert e.value.code == 3


def test_limits_files_hold_their_readings():
    for cell in ALL_CELLS:
        doc = harness.load_json(harness.PKG / "limits" / f"{cell}.json")
        for name, limit in doc["limits"].items():
            lower, upper = doc["readings"][name]["lower"], \
                doc["readings"][name]["upper"]
            assert lower < limit < upper, (cell, name)


def test_a_later_cell_is_added_by_files_alone(tmp_path):
    """A configuration, a traffic mix and a cell added as entries and
    files are found without a change to the harness."""
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "lstm.train.b64", "config":
                               "lstm_flagship", "traffic": "train_b2048",
                               "chips": 1, "why": "x"})
    ctx = harness.make_context("lstm.train.b64", 1, 1.0, False,
                               device="cpu", bench=bench,
                               overrides={"traffic": {"batch": 64}})
    assert ctx.traffic["batch"] == 64 and ctx.config["hidden"] == 512
