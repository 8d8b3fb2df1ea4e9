"""Find a cell's parts by name, run it, judge it, print the result.

A run: the driver named by the traffic file sets the cell up (build,
weights from the seed, warm-up, a training cell's first steps), measures
one window, and hands back its work; the harness reads the memory peak,
checks that no JAX module was loaded, lets the driver free the program's
state and compare the timed path's outputs with the plain reference,
then prints the result line.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import subprocess
import sys
import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "euromillioner_tpu")
PROGRAM = "euromillioner_tpu_torch"


class Refused(Exception):
    """A run that prints no result; ``code`` is its exit code."""

    def __init__(self, code: int, why: str):
        super().__init__(why)
        self.code = code


def load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def load_part(kind: str, name: str):
    """The module ``perfbench/<kind>/<name>.py``, by file (names may hold
    dots)."""
    path = PKG / kind / f"{name}.py"
    if not path.is_file():
        raise Refused(3, f"no {kind} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"perfbench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


@dataclass
class Context:
    """What the driver and the metric readers see of one run."""

    bench: dict
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    work: dict = field(default_factory=dict)
    device_trace: object = None
    leaves: dict | None = None

    def window_span(self):
        """The span that delimits the window in a traced run."""
        if not self.trace:
            return nullcontext()
        from torch.profiler import record_function

        from perfbench.yardstick.trace import WINDOW_SPAN
        return record_function(WINDOW_SPAN)


def load_bench(pending: bool = False) -> dict:
    """``BENCHMARK.json``; with ``pending``, also each cell kept whole under
    ``pending/`` (its entry, its metrics' entries and a configuration no
    other cell uses) until it can be measured. The benchmark's own runs
    never run a pending cell."""
    bench = load_json(ROOT / "BENCHMARK.json")
    if pending:
        for path in sorted((PKG / "pending").glob("*.json")):
            part = load_json(path)
            for key in ("configs", "workloads", "end_to_end", "per_layer"):
                bench[key] = bench[key] + part.get(key, [])
    return bench


def make_context(workload: str, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", overrides: dict | None = None,
                 bench: dict | None = None,
                 pending: bool = False) -> Context:
    bench = bench or load_bench(pending)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise Refused(3, f"no workload {workload!r} in BENCHMARK.json "
                         f"({sorted(cells)})")
    cell = cells[workload]
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = load_json(ROOT / conf["file"])
    traffic = load_json(PKG / "traffic" / f"{cell['traffic']}.json")
    for part, over in (overrides or {}).items():
        {"config": config, "traffic": traffic}[part].update(over)
    return Context(bench=bench, cell=cell, config=config, traffic=traffic,
                   seed=seed, seconds=seconds, trace=trace, device=device)


def end_to_end_names(ctx: Context) -> list:
    return [m for m in ctx.bench["end_to_end"]
            if ctx.cell["name"] in m.get("workloads", [ctx.cell["name"]])]


def per_layer_names(ctx: Context) -> list:
    reported = {m["name"] for m in end_to_end_names(ctx)}
    return [m for m in ctx.bench["per_layer"]
            if ctx.cell["name"] in m.get("workloads", [ctx.cell["name"]])
            and m["moves"] in reported]


def limits_of(workload: str) -> dict:
    path = PKG / "limits" / f"{workload}.json"
    return load_json(path)["limits"] if path.is_file() else {}


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {number: {value, limit}}) over the numbers the cell's
    limits list: each at or under its limit. A cell without limits, or a
    listed number the run did not read, is not correct."""
    if not limits:
        return False, {n: {"value": v, "limit": None}
                       for n, v in readings.items()}
    checks, ok = {}, True
    for name, limit in limits.items():
        value = readings.get(name, float("nan"))
        checks[name] = {"value": value, "limit": limit}
        if not value <= limit:
            ok = False
    return ok, checks


def power_limit_w(index: int) -> float | None:
    """Card ``index``'s power limit in watts as ``nvidia-smi`` reads it,
    or None where it cannot be read: the peaks of ``yardstick/peaks.py``
    hold at 700 W."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def device_desc(ctx: Context) -> dict:
    import torch

    if ctx.device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    chips = range(int(ctx.cell["chips"]))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": len(chips),
            "memory_peak_bytes": int(max(
                torch.cuda.max_memory_allocated(d) for d in chips)),
            "power_limit_w": [power_limit_w(d) for d in chips]}


def run_cell(ctx: Context, t_start: float) -> dict:
    """Set up, measure, judge: the result object."""
    t_drv = time.perf_counter()
    drv = load_part("drivers", ctx.traffic["driver"]).Driver(ctx)
    prof = None
    if ctx.trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if ctx.device == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
    work = drv.window(ctx.seconds)
    work.setdefault("notes", {})["before_setup_s"] = t_drv - t_start
    if prof is not None:
        prof.stop()
        from perfbench.yardstick.trace import reduce_profile
        t0 = time.perf_counter()
        ctx.device_trace = reduce_profile(prof)
        work.setdefault("notes", {})["trace_reduce_s"] = (
            time.perf_counter() - t0)
        del prof
        gc.collect()
    ctx.work = work
    setup_s = work["t_window"] - t_start
    device = device_desc(ctx)
    loaded = forbidden_modules()
    if loaded:
        raise Refused(4, f"modules loaded that the benchmark must not "
                         f"load: {loaded}")
    metrics = {}
    if ctx.trace:
        for m in per_layer_names(ctx):
            value = load_part("metrics", m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dt = ctx.device_trace
        if dt is not None:
            device["busy_s"] = dt.busy_s
            device["window_s"] = dt.window_s
    else:
        for m in end_to_end_names(ctx):
            value = (setup_s if m["name"] == "setup_s"
                     else work["end_to_end"].get(m["name"]))
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    readings = drv.check()
    ctx.leaves = getattr(drv, "leaves", None)
    correct, checks = judge(readings, limits_of(ctx.cell["name"]))
    failed = int(work.get("failed", 0))
    result = {"correct": bool(correct and failed == 0),
              "attempted": int(work["attempted"]), "failed": failed,
              "metrics": metrics, "device": device}
    if ctx.trace and ctx.device_trace is not None:
        result["breakdown"] = {
            "device_ops": ctx.device_trace.top_ops(10),
            "idle_gaps": ctx.device_trace.idle_gaps(10)}
    result["notes"] = {**work.get("notes", {}), "readings": readings}
    result["checks"] = checks
    return result


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def require_cards(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise Refused(2, "CUDA is not available")
    if torch.cuda.device_count() < chips:
        raise Refused(2, f"the cell needs {chips} cards, "
                         f"{torch.cuda.device_count()} present")


def require_program() -> None:
    """The program under test has to come from this checkout."""
    try:
        import euromillioner_tpu_torch as prog
    except ImportError as e:
        raise Refused(3, f"the checkout lacks {PROGRAM}: {e}") from e
    if ROOT not in Path(prog.__file__).resolve().parents:
        raise Refused(3, f"{PROGRAM} comes from {prog.__file__}, not from "
                         f"the checkout at {ROOT}")


def main(argv, t_start: float) -> int:
    args = parse(argv)
    try:
        ctx = make_context(args.workload, args.seed, args.seconds,
                           bool(args.trace))
        require_cards(int(ctx.cell["chips"]))
        require_program()
        result = run_cell(ctx, t_start)
    except Refused as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return e.code
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
