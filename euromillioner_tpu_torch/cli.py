"""CLI: ``python -m euromillioner_tpu_torch train|serve ...``.

The JAX package's ``train`` and ``serve`` subcommands for the lstm family,
with the same flags, dotted config overrides and exit codes (the error
taxonomy's ``exit_code``; 2 for bad arguments). ``--device`` picks
``cuda`` (the default) or ``cpu``. ``train`` reads a saved results page
(``--html-file``) or a featurized CSV (``--csv``); fetching the live page
is not ported yet. ``serve`` has only the in-process ``--smoke N`` front
end; the HTTP server is not ported yet.
"""

from __future__ import annotations

import argparse
import json
import sys

from euromillioner_tpu_torch.config import Config, apply_overrides, check_ported
from euromillioner_tpu_torch.utils.errors import (ConfigError,
                                                  EuromillionerError,
                                                  ServeError)
from euromillioner_tpu_torch.utils.logging_utils import get_logger

logger = get_logger("cli")


def _load_datasets(args, cfg: Config):
    """(train, validation) Datasets from --csv or --html-file, with the
    reference's chronological split."""
    from euromillioner_tpu_torch.data.dataset import Dataset, chronological_split
    from euromillioner_tpu_torch.data.pipeline import pipeline_from_html

    if args.csv:
        ds = Dataset.from_csv(args.csv, label_column=cfg.data.label_column)
        return chronological_split(ds, cfg.data.train_percent)
    if args.html_file:
        with open(args.html_file, encoding="utf-8") as fh:
            return pipeline_from_html(fh.read(), cfg.data)
    raise ConfigError("fetching the results page is not ported yet; pass "
                      "--html-file PAGE or --csv FILE")


def cmd_train(args, cfg: Config) -> int:
    """Train the LSTM on sliding windows of the draw history with the
    {train, test} watches, then save the TrainState (``--save`` or
    ``train.checkpoint_dir``)."""
    import torch

    from euromillioner_tpu_torch.core.device import resolve_device
    from euromillioner_tpu_torch.core.precision import from_names
    from euromillioner_tpu_torch.data.dataset import Dataset
    from euromillioner_tpu_torch.models.lstm import make_sequences
    from euromillioner_tpu_torch.models.registry import build_model
    from euromillioner_tpu_torch.train.checkpoint import save_checkpoint
    from euromillioner_tpu_torch.train.optim import from_train_config
    from euromillioner_tpu_torch.train.trainer import Trainer

    device = resolve_device(args.device)
    train_ds, val_ds = _load_datasets(args, cfg)
    cfg.model.name = args.model
    precision = from_names(cfg.model.param_dtype, cfg.model.compute_dtype)
    x, y = make_sequences(train_ds.full_rows(), cfg.model.seq_len)
    xv, yv = make_sequences(val_ds.full_rows(), cfg.model.seq_len)
    train_seq, val_seq = Dataset(x=x, y=y), Dataset(x=xv, y=yv)
    model = build_model(
        cfg.model, in_features=x.shape[-1],
        generator=torch.Generator().manual_seed(cfg.train.seed),
        device=device)
    trainer = Trainer(model, from_train_config(cfg.train), loss="mse",
                      precision=precision,
                      metrics_jsonl=cfg.train.metrics_jsonl or None)
    state = trainer.fit(
        trainer.init_state(), train_seq, epochs=cfg.train.epochs,
        batch_size=cfg.data.batch_size,
        watches={"train": train_seq, "test": val_seq},
        seed=cfg.train.seed, shuffle=cfg.data.shuffle,
        log_every=cfg.train.log_every,
        checkpoint_dir=cfg.train.checkpoint_dir or None,
        checkpoint_every=cfg.train.checkpoint_every)
    if args.save or cfg.train.checkpoint_dir:
        out = save_checkpoint(args.save or cfg.train.checkpoint_dir, state,
                              step=cfg.train.epochs)
        logger.info("saved checkpoint to %s", out)
    return 0


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
    tr = sub.add_parser("train", help="train the LSTM with {train, test} "
                                      "watches and save its TrainState")
    tr.add_argument("--model", default="lstm", choices=["lstm"])
    tr.add_argument("--csv", help="featurized CSV input")
    tr.add_argument("--html-file", help="saved results page")
    tr.add_argument("--save", help="checkpoint output directory")
    tr.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="training device (default: cuda; the CPU runs only "
                         "when asked for)")
    tr.add_argument("overrides", nargs="*", default=[],
                    help="config overrides: section.field=value")
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


_COMMANDS = {"train": cmd_train, "serve": cmd_serve}


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
