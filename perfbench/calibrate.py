"""The readings that a cell's correctness limits are set from, in one
process (the benchmark's own runs never run this):

    python3 perfbench/calibrate.py --workload <name> --seconds <s> \\
        --seeds 1,2,... [--control fp8|tf32 --control-seeds ...] \\
        [--fault half_batch --fault-seeds ...]

- the program's numbers on each of ``--seeds`` (its ordinary run, with a
  window of ``--seconds``);
- the control's on each of ``--control-seeds``: the plain reference
  under the named rounding put in the program's place;
- a fault's on each of ``--fault-seeds``: the program with the fault of
  ``faults.py`` planted for the whole run.

One JSON line a run on standard output; with ``--out`` the lines also go
to that file.
"""

import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import argparse  # noqa: E402

import torch  # noqa: E402

from perfbench import faults, harness  # noqa: E402


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def _free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--seeds", default="")
    p.add_argument("--control", default=None)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault", default=None)
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    out = open(args.out, "a", encoding="utf-8") if args.out else None
    card = (torch.cuda.get_device_name(0) if args.device == "cuda"
            else "cpu")

    def emit(rec):
        rec.update(workload=args.workload, card=card)
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def context(seed):
        return harness.make_context(args.workload, seed, args.seconds,
                                    False, device=args.device, pending=True)

    for seed in _seeds(args.seeds):
        t = time.perf_counter()
        ctx = context(seed)
        r = harness.run_cell(ctx, t)
        emit({"kind": "program", "seed": seed, "leaves": ctx.leaves,
              "readings": r["notes"]["readings"],
              "metrics": {k: m["value"] for k, m in r["metrics"].items()},
              "failed": r["failed"], "notes": r["notes"],
              "memory_peak_bytes": r["device"]["memory_peak_bytes"]})
        _free()
    for seed in _seeds(args.control_seeds):
        ctx = context(seed)
        drv = harness.load_part("drivers", ctx.traffic["driver"]).Driver(ctx)
        ctx.work = drv.window(args.seconds)
        readings = drv.control(args.control)
        emit({"kind": f"control:{args.control}", "seed": seed,
              "readings": readings, "leaves": getattr(drv, "leaves", None)})
        del drv
        _free()
    for seed in _seeds(args.fault_seeds):
        ctx = context(seed)
        kind = "serve" if ctx.traffic["driver"] == "serve_open" else "train"
        with faults.FAULTS[args.fault](*(
                () if args.fault == "unchanged" else (kind,))):
            r = harness.run_cell(ctx, time.perf_counter())
        emit({"kind": f"fault:{args.fault}", "seed": seed,
              "readings": r["notes"]["readings"], "leaves": ctx.leaves})
        _free()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
