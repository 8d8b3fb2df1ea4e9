"""CLI: ``python -m euromillioner_tpu_torch serve ...``.

The JAX package's ``serve`` subcommand for the lstm family, with the same
flags, dotted config overrides and exit codes (the error taxonomy's
``exit_code``; 2 for bad arguments). ``--device`` picks ``cuda`` (the
default) or ``cpu``. Only the in-process ``--smoke N`` front end is ported;
the HTTP server is not yet.
"""

from __future__ import annotations

import argparse
import json
import sys

from euromillioner_tpu_torch.config import Config, apply_overrides, check_ported
from euromillioner_tpu_torch.utils.errors import EuromillionerError, ServeError
from euromillioner_tpu_torch.utils.logging_utils import get_logger

logger = get_logger("cli")


def cmd_serve(args, cfg: Config) -> int:
    """Serve an LSTM checkpoint behind the whole-sequence scheduler;
    ``--smoke N`` pushes N synthetic requests through the in-process
    transport, prints one JSON summary line and exits (0 iff none
    failed)."""
    from euromillioner_tpu_torch.core.precision import resolve_serve_precision
    from euromillioner_tpu_torch.serve import transport
    from euromillioner_tpu_torch.serve.continuous import (
        load_recurrent_backend, make_sequence_engine)

    resolve_serve_precision(cfg.serve.precision)
    check_ported(cfg)
    if not args.smoke:
        raise ServeError("the HTTP transport is not ported yet; run with "
                         "--smoke N")
    backend = load_recurrent_backend(cfg, args.checkpoint,
                                     args.num_features, device=args.device)
    engine = make_sequence_engine(backend, cfg)
    try:
        logger.info(
            "serving %s on %s (scheduler=batch, precision=%s, envelope=%s, "
            "row_buckets=%s, time_buckets=%s)", backend.name, backend.device,
            backend.precision, backend.envelope or "oracle",
            list(engine.row_buckets), list(engine.time_buckets))
        summary = transport.run_smoke(engine, args.smoke)
        print(json.dumps(summary))
        return 0 if summary["failed"] == 0 else 1
    finally:
        engine.close()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m euromillioner_tpu_torch",
        description="PyTorch/CUDA port of the Euromillioner CLI")
    sub = p.add_subparsers(dest="command", required=True)
    sv = sub.add_parser(
        "serve", help="serve an LSTM checkpoint behind the whole-sequence "
                      "scheduler (serve.precision=f32|fused)")
    sv.add_argument("--model-type", default="lstm", choices=["lstm"])
    sv.add_argument("--checkpoint",
                    help="checkpoint dir (latest intact step is used)")
    sv.add_argument("--num-features", type=int, default=0,
                    help="input feature count (default: family standard)")
    sv.add_argument("--smoke", type=int, default=0,
                    help="serve N synthetic in-process requests and exit")
    sv.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="serving device (default: cuda; the CPU runs only "
                         "when asked for)")
    sv.add_argument("overrides", nargs="*", default=[],
                    help="config overrides: section.field=value")
    return p


_COMMANDS = {"serve": cmd_serve}


def main(argv: list[str] | None = None) -> int:
    # parse_known_args so `--serve.precision=fused`-style flags fall
    # through to the override list (apply_overrides strips leading dashes)
    args, unknown = build_parser().parse_known_args(argv)
    try:
        overrides = [o.strip() for o in list(args.overrides) + list(unknown)
                     if o.strip()]
        cfg = apply_overrides(Config(), overrides)
    except (EuromillionerError, ValueError) as e:
        logger.error("bad arguments: %s", e)
        return 2
    try:
        return _COMMANDS[args.command](args, cfg)
    except EuromillionerError as e:
        logger.error("%s: %s", type(e).__name__, e)
        return e.exit_code
    except ValueError as e:
        logger.error("invalid configuration: %s", e)
        return 2


if __name__ == "__main__":
    sys.exit(main())
