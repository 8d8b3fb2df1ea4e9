"""Find the highest rate a serving cell's program sustains (its knee):
open-loop windows of the cell's traffic at each rate of ``--rates``, one
process, one JSON line a rate (the benchmark's own runs never run this):

    python3 perfbench/sweep.py --workload <name> --seconds 8 \\
        --rates 1000,2000,3000 [--seed n]

``--workload`` names a cell of ``BENCHMARK.json`` or of ``pending/``. A
rate is sustained where the window answers nearly every request it
offers and the backlog at its close stays a few batches deep.
"""

import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import argparse  # noqa: E402

import torch  # noqa: E402

from perfbench import harness  # noqa: E402


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--rates", required=True)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    for rate in (float(r) for r in args.rates.split(",")):
        ctx = harness.make_context(
            args.workload, args.seed, args.seconds, False,
            device=args.device, overrides={"traffic": {"rate_per_s": rate}},
            pending=True)
        drv = harness.load_part("drivers", ctx.traffic["driver"]).Driver(ctx)
        work = drv.window(args.seconds)
        drv.release()
        print(json.dumps({"rate_per_s": rate, **work["end_to_end"],
                          "window_batches": work["window_batches"],
                          "window_sequences": work["window_sequences"],
                          "failed": work["failed"], **work["notes"]}),
              flush=True)
        del drv
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
