"""CLI: ``python -m euromillioner_tpu_torch fetch|train|predict|export|reference|
serve|fleet|replay|trace-export|obs-top|aot``.

The JAX package's subcommands for the ported paths, with the same flags,
dotted config overrides and exit codes (the error taxonomy's
``exit_code``; 2 for bad arguments): ``fetch --html-file`` writes the
featurized CSV; ``train --model gbt|rf|mlp|lstm|wide_deep`` trains a
booster or a random forest (``--save`` writes its model JSON;
``--num-classes C`` makes the forest a classifier), the MLP, the LSTM or
Wide&Deep (``--save`` writes the TrainState); ``train --model lstm
--tbptt`` trains the LSTM by truncated BPTT over the whole draw history;
``predict --model-type gbt|rf`` predicts with a saved model JSON;
``export`` writes a trained mlp, lstm or wide_deep checkpoint as a
torch.export program and ``predict --model-type exported --runtime
torch|native`` runs it through torch or the C++ runner;
``reference`` runs the Main.java pipeline; ``serve --model-type gbt|rf|classic`` serves a model
JSON (``--model-file``) and ``serve --model-type mlp|lstm|wide_deep`` a
checkpoint, the neural families at ``serve.precision=f32|bf16|int8w``
(and ``fused`` for the LSTM). ``--device`` picks ``cuda``
(the default) or ``cpu``. Data comes from a saved results page
(``--html-file``), a featurized CSV (``--csv``) or, for ``fetch``,
``train`` and ``reference``, the page at ``data.url`` (retried with backoff; with
``data.cache_path`` set, the last good rows are kept there and served when
the fetch's retries are exhausted). ``train --distributed`` trains mlp, lstm and wide_deep
data-parallel and grows rf row-sharded over a ``torch.distributed`` group
of one process per device (NCCL on the card, gloo on the CPU): with
``COORDINATOR_ADDRESS``/``NUM_PROCESSES``/``PROCESS_ID`` set this process
is one rank of that group; without them it starts one rank per visible
card, or ``EUROMILLIONER_CPU_DEVICES`` ranks under ``--device cpu``, and
exits non-zero if any rank does. ``serve`` answers HTTP on
``serve.host:serve.port`` (``--scheduler batch|continuous`` picks the
LSTM's scheduler) until SIGTERM or Ctrl-C, or pushes ``--smoke N``
requests through the in-process transport and exits. ``replay`` drives a
workload trace (``--trace`` file or ``--generate`` seeded generator)
open-loop against an engine loaded as ``serve`` loads it, or against tiny
seeded in-process engines (``--smoke``), and prints the attainment report;
``trace-export`` turns a capture file or metrics JSONL into a replay
trace; ``obs-top`` prints one summary line per second from a metrics
JSONL (``--jsonl``), a server's ``/stats`` (``--url``) or several servers'
``/metrics`` (``--fleet``). With ``serve.aot.enabled=true`` ``serve`` runs
its programs compiled ahead of time from the AOT store (``serve.aot.dir``);
``aot prewarm|ls|verify|prune`` fills, lists, checks and prunes that store.
``fleet`` fronts several ``serve`` processes (``--hosts``) with one router
that probes their health, ejects and re-admits them and re-routes their
work (``--smoke N`` over in-process hosts; ``--autoscale`` attaches the
supervisor; ``--release HOST`` lifts a quarantine on a running front end).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

from euromillioner_tpu_torch.config import Config, apply_overrides
from euromillioner_tpu_torch.utils.errors import (EuromillionerError,
                                                  ServeError)
from euromillioner_tpu_torch.utils.logging_utils import get_logger

logger = get_logger("cli")


def _load_html(args) -> str | None:
    if args.html_file:
        with open(args.html_file, encoding="utf-8") as fh:
            return fh.read()
    return None


def _gbt_device(args, cfg: Config) -> None:
    """``--device`` sets where the boosters run (``gbt.device``)."""
    if args.device:
        cfg.gbt.device = args.device


def _load_datasets(args, cfg: Config):
    """(train, validation) Datasets from --csv, --html-file or the page at
    ``data.url`` (with the stale-cache path), with the reference's
    chronological split."""
    from euromillioner_tpu_torch.data.dataset import Dataset, chronological_split
    from euromillioner_tpu_torch.data.pipeline import (pipeline_from_html,
                                                       pipeline_from_url)

    if args.csv:
        ds = Dataset.from_csv(args.csv, label_column=cfg.data.label_column)
        return chronological_split(ds, cfg.data.train_percent)
    html = _load_html(args)
    if html is not None:
        return pipeline_from_html(html, cfg.data)
    return pipeline_from_url(cfg.data)


def cmd_fetch(args, cfg: Config) -> int:
    """Fetch the page at ``data.url`` (or parse a saved one) and write the
    featurized CSV."""
    from euromillioner_tpu_torch.data.csvio import write_csv
    from euromillioner_tpu_torch.data.fetch import fetch_url
    from euromillioner_tpu_torch.data.pipeline import draws_from_html

    html = _load_html(args)
    if html is None:
        html = fetch_url(cfg.data.url)
    rows = draws_from_html(html, cfg.data)
    write_csv(args.output, rows, compat=cfg.data.compat_csv)
    logger.info("wrote %d rows to %s", len(rows), args.output)
    print(args.output)
    return 0


def cmd_train(args, cfg: Config) -> int:
    """Train a booster (``--model gbt``, the default), a random forest or
    a neural family with the {train, test} watches, then save it
    (``--save``); ``--distributed`` over a (data, model, seq) mesh."""
    tbptt = args.model == "lstm" and args.tbptt
    if not args.distributed:
        if tbptt:
            return _train_tbptt(args, cfg)
        return (_train_gbt(args, cfg) if args.model == "gbt"
                else _train_model(args, cfg, None))
    from euromillioner_tpu_torch.core.mesh import MeshSpec

    spec = MeshSpec.from_config(cfg.mesh)
    if tbptt:
        # the JAX CLI builds the mesh (a mesh its devices do not cover
        # fails, exit 15), then trains on one device
        from euromillioner_tpu_torch.core.device import resolve_device
        from euromillioner_tpu_torch.core.mesh import local_device_count

        spec.resolve(local_device_count(resolve_device(args.device)))
        logger.warning("--tbptt trains as one single-device program; "
                       "mesh ignored")
        return _train_tbptt(args, cfg)
    if args.model == "gbt":
        logger.warning(
            "--distributed: gbt trains as one single-device program; "
            "mesh ignored (use rf or a neural family for multi-chip)")
        return _train_gbt(args, cfg)
    if os.environ.get("COORDINATOR_ADDRESS") or args.auto_coordinator:
        return _train_rank(args, cfg, spec)
    return _launch_local_ranks(args, cfg, spec)


def _train_rank(args, cfg: Config, spec, *topology) -> int:
    """This process as one rank of the group (``topology``: coordinator
    address, size, rank; default the environment's): join it, build the
    mesh, train, leave it. Ranks other than 0 log warnings only."""
    from euromillioner_tpu_torch.core.device import resolve_device
    from euromillioner_tpu_torch.core.mesh import build_mesh
    from euromillioner_tpu_torch.dist import bootstrap

    device = resolve_device(args.device)  # no card: fail before the group
    bootstrap.initialize(*topology, auto=args.auto_coordinator,
                         device=device)
    try:
        if not bootstrap.is_primary():
            logging.getLogger("euromillioner_tpu_torch").setLevel(
                logging.WARNING)
        mesh = build_mesh(spec, device=device)
        logger.info("device mesh: %s", mesh.shape)
        return _train_model(args, cfg, mesh)
    finally:
        bootstrap.shutdown()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch_local_ranks(args, cfg: Config, spec) -> int:
    """No coordinator configured: one rank per local device (the visible
    cards, or ``EUROMILLIONER_CPU_DEVICES`` under ``--device cpu``), the
    JAX CLI's "mesh spans this process's devices": ``data·model·seq``
    ranks, which the mesh lays out as ``build_mesh`` does. A group of one
    runs in
    this process; more ranks run as child processes of this command line
    with the group's variables set, joined in ``finally``. The first rank
    to fail ends the run with its exit code (the others are stopped); a
    SIGTERM here is passed on to every rank, which agree to stop at the
    next epoch boundary."""
    from euromillioner_tpu_torch.core.device import resolve_device
    from euromillioner_tpu_torch.core.mesh import local_device_count

    device = resolve_device(args.device)
    n = local_device_count(device)
    spec.resolve(n)  # a mesh that does not cover the devices: exit 15
    logger.info("no coordinator configured: the group spans this host's %d "
                "%s device(s), one rank each; across hosts set "
                "COORDINATOR_ADDRESS/NUM_PROCESSES/PROCESS_ID", n,
                device.type)
    address = f"127.0.0.1:{_free_port()}"
    if n == 1:
        return _train_rank(args, cfg, spec, address, 1, 0)
    root = str(Path(__file__).resolve().parents[1])
    base = dict(os.environ, COORDINATOR_ADDRESS=address,
                NUM_PROCESSES=str(n))
    base["PYTHONPATH"] = os.pathsep.join(
        [root, *filter(None, [base.get("PYTHONPATH")])])
    children: list[subprocess.Popen] = []

    def pass_on(signum, frame):
        for c in children:
            if c.poll() is None:
                c.send_signal(signal.SIGTERM)

    in_main = threading.current_thread() is threading.main_thread()
    prev = signal.signal(signal.SIGTERM, pass_on) if in_main else None
    try:
        for rank in range(n):
            children.append(subprocess.Popen(
                [sys.executable, "-m", "euromillioner_tpu_torch", *args.argv],
                env=dict(base, PROCESS_ID=str(rank), LOCAL_RANK=str(rank))))
        while True:
            codes = [c.poll() for c in children]
            failed = [(r, rc) for r, rc in enumerate(codes) if rc]
            if failed:
                rank, rc = failed[0]
                logger.error("rank %d exited %d; stopping the other ranks",
                             rank, rc)
                return rc
            if all(rc == 0 for rc in codes):
                return 0
            time.sleep(0.1)
    finally:
        for c in children:
            if c.poll() is None:
                c.kill()
            c.wait()
        if in_main:
            signal.signal(signal.SIGTERM, prev)


def _train_model(args, cfg: Config, mesh) -> int:
    """The random forest or a neural family, over ``mesh`` when given."""
    if args.model == "rf":
        return _train_rf(args, cfg, mesh)
    return _train_nn(args, cfg, mesh)


def _train_gbt(args, cfg: Config) -> int:
    from euromillioner_tpu_torch.trees import DMatrix, train
    from euromillioner_tpu_torch.trees.gbt import resolve_train_device

    _gbt_device(args, cfg)
    resolve_train_device(cfg.gbt.device)  # no card: fail before any work
    train_ds, val_ds = _load_datasets(args, cfg)
    dtrain = DMatrix(train_ds.x, train_ds.y)
    dval = DMatrix(val_ds.x, val_ds.y)
    booster = train(cfg.gbt.xgb_params(), dtrain, cfg.gbt.nround,
                    evals={"train": dtrain, "test": dval},
                    fuse_rounds=cfg.gbt.fuse_rounds)
    if args.save:
        booster.save_model(args.save)
        logger.info("saved model to %s", args.save)
    return 0


def _train_rf(args, cfg: Config, mesh) -> int:
    """A random forest on the featurized rows: a classifier with
    ``--num-classes C`` (logs validation accuracy), else a regressor (logs
    validation rmse); row-sharded over ``mesh`` when given, saved by rank
    0."""
    from euromillioner_tpu_torch.core.device import resolve_device
    from euromillioner_tpu_torch.trees import train_classifier, train_regressor

    device = (mesh.device if mesh is not None
              else resolve_device(args.device))  # no card: fail first
    train_ds, val_ds = _load_datasets(args, cfg)
    fc = cfg.forest
    kw = dict(num_trees=fc.num_trees, max_depth=fc.max_depth,
              max_bins=fc.max_bins, feature_subset=fc.feature_subset,
              bootstrap=fc.bootstrap, min_info_gain=fc.min_info_gain,
              seed=fc.seed, hist_method=fc.hist_method, device=device,
              mesh=mesh)
    if args.num_classes:
        model = train_classifier(train_ds.x, train_ds.y, args.num_classes,
                                 **kw)
        acc = (model.predict(val_ds.x) == val_ds.y).mean()
        logger.info("validation accuracy: %.4f", acc)
    else:
        model = train_regressor(train_ds.x, train_ds.y, **kw)
        rmse = float(np.sqrt(np.mean((model.predict(val_ds.x)
                                      - val_ds.y) ** 2)))
        logger.info("validation rmse: %.4f", rmse)
    if args.save and (mesh is None or mesh.rank == 0):
        model.save_model(args.save)
        logger.info("saved model to %s", args.save)
    return 0


def _train_nn(args, cfg: Config, mesh) -> int:
    """Train a neural family with the {train, test} watches, then save the
    TrainState (``--save`` or ``train.checkpoint_dir``): the LSTM on
    sliding windows of the draw history, Wide&Deep on each full 11-column
    row predicting the next draw's balls, the MLP on the 10 label-dropped
    features predicting the label column. Over ``mesh`` when given:
    data-parallel, tensor-parallel over ``model`` per the model's rules,
    and the LSTM sequence-parallel over ``seq`` (every rank saves the
    global leaves)."""
    import torch

    from euromillioner_tpu_torch.core.device import resolve_device
    from euromillioner_tpu_torch.core.precision import from_names
    from euromillioner_tpu_torch.data.dataset import Dataset
    from euromillioner_tpu_torch.models.lstm import make_sequences
    from euromillioner_tpu_torch.models.registry import build_model
    from euromillioner_tpu_torch.train.optim import from_train_config
    from euromillioner_tpu_torch.train.trainer import Trainer

    device = mesh.device if mesh is not None else resolve_device(args.device)
    train_ds, val_ds = _load_datasets(args, cfg)
    cfg.model.name = args.model
    precision = from_names(cfg.model.param_dtype, cfg.model.compute_dtype)
    full, fullv = train_ds.full_rows(), val_ds.full_rows()
    if args.model == "lstm":
        train_ds = Dataset(*make_sequences(full, cfg.model.seq_len))
        val_ds = Dataset(*make_sequences(fullv, cfg.model.seq_len))
    elif args.model == "wide_deep":
        train_ds = Dataset(x=full[:-1], y=full[1:, 4:11])
        val_ds = Dataset(x=fullv[:-1], y=fullv[1:, 4:11])
    # the mlp trains on the split as it is: (N, 10) features, label column
    model = build_model(
        cfg.model, in_features=train_ds.x.shape[-1],
        generator=torch.Generator().manual_seed(cfg.train.seed),
        device=device)
    kw = dict(loss="mse", precision=precision,
              metrics_jsonl=cfg.train.metrics_jsonl or None)
    if mesh is not None:
        from euromillioner_tpu_torch.dist.sharded import DistributedTrainer

        trainer = DistributedTrainer(
            model, from_train_config(cfg.train), mesh=mesh,
            shard_sequence=args.model == "lstm" and mesh.seq > 1, **kw)
    else:
        trainer = Trainer(model, from_train_config(cfg.train), **kw)
    state = trainer.fit(
        trainer.init_state(), train_ds, epochs=cfg.train.epochs,
        batch_size=cfg.data.batch_size,
        watches={"train": train_ds, "test": val_ds},
        seed=cfg.train.seed, shuffle=cfg.data.shuffle,
        log_every=cfg.train.log_every,
        checkpoint_dir=cfg.train.checkpoint_dir or None,
        checkpoint_every=cfg.train.checkpoint_every)
    if args.save or cfg.train.checkpoint_dir:
        out = trainer.save_checkpoint(args.save or cfg.train.checkpoint_dir,
                                      state, step=cfg.train.epochs)
        logger.info("saved checkpoint to %s", out)
    return 0


def _train_tbptt(args, cfg: Config) -> int:
    """``train --model lstm --tbptt``: truncated BPTT over the whole
    chronological draw history (train/tbptt.py) instead of sliding
    windows. State carries across ``train.tbptt_chunk_len``-step chunks;
    the history is folded into ``train.tbptt_lanes`` parallel lanes, its
    oldest steps trimmed to a multiple of the chunk. Inputs in the compute
    dtype, targets and loss in float32; one eval line (and JSONL record)
    per logged epoch; the TrainState is saved every
    ``train.checkpoint_every`` epochs and at the end in the JAX package's
    layout."""
    import torch

    from euromillioner_tpu_torch.core.device import resolve_device
    from euromillioner_tpu_torch.core.precision import from_names
    from euromillioner_tpu_torch.models.lstm import build_tbptt_lstm
    from euromillioner_tpu_torch.nn import losses as L
    from euromillioner_tpu_torch.train.checkpoint import save_checkpoint
    from euromillioner_tpu_torch.train.metrics import eval_line
    from euromillioner_tpu_torch.train.optim import from_train_config
    from euromillioner_tpu_torch.train.tbptt import (apply_with_states,
                                                     fold_history,
                                                     init_states,
                                                     make_tbptt_train_step)
    from euromillioner_tpu_torch.train.trainer import TrainState, epoch_seeds
    from euromillioner_tpu_torch.utils.logging_utils import \
        JsonlMetricsWriter

    device = resolve_device(args.device)
    train_ds, val_ds = _load_datasets(args, cfg)
    precision = from_names(cfg.model.param_dtype, cfg.model.compute_dtype)
    chunk = cfg.train.tbptt_chunk_len
    lanes = cfg.train.tbptt_lanes
    # the whole 11-column featurized table (label column first)
    x, y = fold_history(train_ds.full_rows(), lanes)
    t = (x.shape[1] // chunk) * chunk
    if t == 0:
        raise SystemExit(
            f"history too short: {x.shape[1]} steps/lane < chunk {chunk}")
    if t < x.shape[1]:
        logger.info("trimming %d oldest steps/lane to a multiple of "
                    "chunk_len=%d (tune train.tbptt_chunk_len to keep "
                    "more)", x.shape[1] - t, chunk)

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)

    # drop the OLDEST steps (front), keeping the newest draws
    xt = put(x[:, -t:], precision.compute_dtype)
    yt = put(y[:, -t:], torch.float32)
    xv, yv = fold_history(val_ds.full_rows(), 1)
    xvt = put(xv, precision.compute_dtype)
    yvt = put(yv, torch.float32)

    model = build_tbptt_lstm(
        hidden=cfg.model.lstm_hidden, num_layers=cfg.model.lstm_layers,
        out_dim=y.shape[-1], peepholes=cfg.model.graves_peepholes,
        dropout=cfg.model.dropout, in_features=x.shape[-1],
        generator=torch.Generator().manual_seed(cfg.train.seed),
        device=device)
    params = {k: v.detach().to(precision.param_dtype).clone()
              for k, v in model.named_parameters()}
    optimizer = from_train_config(cfg.train)
    opt_state = optimizer.init(params)
    step = make_tbptt_train_step(model, optimizer, L.mse, chunk_len=chunk)

    def val_loss() -> float:
        with torch.no_grad():
            out, _ = apply_with_states(
                model, params, xvt,
                init_states(model, xvt.shape[0], xvt.dtype))
            return float(L.mse(out.to(torch.float32), yvt))

    ck_dir = args.save or cfg.train.checkpoint_dir
    jsonl = (JsonlMetricsWriter(cfg.train.metrics_jsonl)
             if cfg.train.metrics_jsonl else None)

    def save(step_no: int) -> None:
        out = save_checkpoint(ck_dir, TrainState(
            params=params, opt_state=opt_state,
            step=torch.tensor(step_no, dtype=torch.int32)), step=step_no)
        logger.info("saved checkpoint to %s", out)

    logger.info("tbptt: %d lanes x %d steps, chunk %d (%d chunks/epoch)",
                lanes, t, chunk, t // chunk)
    try:
        for epoch in range(cfg.train.epochs):
            gen = None
            if cfg.model.dropout > 0:
                gen = torch.Generator(device).manual_seed(
                    epoch_seeds(cfg.train.seed + 1, epoch)[1])
            _, _, losses = step(params, opt_state, xt, yt, gen)
            if (epoch % cfg.train.log_every == 0
                    or epoch == cfg.train.epochs - 1):
                results = {"train": {"mse": float(losses.mean())},
                           "test": {"mse": val_loss()}}
                logger.info(eval_line(epoch, results))
                if jsonl:
                    jsonl.write({"round": epoch, **{
                        f"{w}-{m}": v for w, ms in results.items()
                        for m, v in ms.items()}})
            if (ck_dir and cfg.train.checkpoint_every
                    and (epoch + 1) % cfg.train.checkpoint_every == 0):
                save(epoch + 1)
        if ck_dir:
            save(cfg.train.epochs)
    finally:
        if jsonl:
            jsonl.close()
    return 0


def cmd_export(args, cfg: Config) -> int:
    """Export a trained neural checkpoint as a torch.export program
    (core/export.py) runnable by torch OR by the C++ runner — the
    ModelSerializer→native-runtime deployment path of the reference
    stack."""
    import torch

    from euromillioner_tpu_torch.core.export import ModelForward, export_model
    from euromillioner_tpu_torch.models.registry import restore_for_inference

    cfg.model.name = args.model
    model, compute_dtype, in_shape, ck = restore_for_inference(
        cfg, args.checkpoint, args.num_features, device=args.device)
    model.eval()
    example = torch.zeros((args.batch, *in_shape), dtype=torch.float32,
                          device=next(model.parameters()).device)
    export_model(ModelForward(model, compute_dtype), (example,), args.output,
                 meta={"model": args.model, "in_shape": list(in_shape),
                       "batch": args.batch, "checkpoint": ck})
    print(args.output)
    return 0


def cmd_predict(args, cfg: Config) -> int:
    """Predict with a saved GBT or random-forest model JSON, or an export
    directory (``--model-type exported``), on a CSV of featurized rows; one
    value per line (an export's row of outputs on one line)."""
    from euromillioner_tpu_torch.data.csvio import read_csv
    from euromillioner_tpu_torch.trees import (Booster, DMatrix,
                                               RandomForestModel)

    x, _, _ = read_csv(args.csv, label_column=(
        cfg.data.label_column if args.has_label else None))
    if args.model_type == "exported":
        # one line per row: a row's outputs side by side
        for row in _predict_exported(args, x).reshape(len(x), -1):
            print(" ".join(str(v) for v in row))
        return 0
    if args.model_type == "gbt":
        model = Booster.load_model(args.model_file, device=args.device)
        pred = model.predict(DMatrix(x))
    else:
        model = RandomForestModel.load_model(args.model_file,
                                             device=args.device)
        pred = model.predict(x)
    for v in np.asarray(pred).reshape(-1):
        print(v)
    return 0


def _predict_exported(args, x: np.ndarray) -> np.ndarray:
    """Run an export (cmd_export) over CSV rows. The program has a fixed
    batch size; rows are zero-padded to a multiple and run in batches —
    through torch, or through the C++ runner (``--runtime native``)."""
    from euromillioner_tpu_torch.core import export as ex

    n = len(x)
    if n == 0:
        raise SystemExit(f"{args.csv} has no data rows")
    outs = []
    with ex.ExportedRunner(args.model_file, args.runtime,
                           args.device) as run:
        (bshape, _dt), = run.manifest["in_specs"]
        batch = bshape[0]
        feat_shape = tuple(bshape[1:])
        if x.shape[1:] != feat_shape:
            raise SystemExit(
                f"CSV rows have shape {x.shape[1:]}, artifact wants "
                f"{feat_shape} (exported with --num-features?)")
        pad = (-n) % batch
        xp = np.concatenate([x, np.zeros((pad, *x.shape[1:]), x.dtype)])
        for i in range(0, len(xp), batch):
            outs.append(run(xp[i:i + batch].astype(np.float32))[0])
    return np.concatenate(outs)[:n]


def cmd_reference(args, cfg: Config) -> int:
    """The full Main.java-equivalent run (prints the reference's boolean)."""
    from euromillioner_tpu_torch.app import run_reference_pipeline

    _gbt_device(args, cfg)
    run_reference_pipeline(cfg, html=_load_html(args))
    return 0


def cmd_serve(args, cfg: Config) -> int:
    """Serve a saved model: an LSTM checkpoint behind the whole-sequence
    or the step scheduler (``--scheduler``), or a tree or classic model
    JSON (``--model-file``) or an MLP or Wide&Deep checkpoint behind the
    row micro-batching engine (one child engine per extra
    ``serve.profiles`` entry). Answers HTTP on ``serve.host:serve.port``
    until SIGTERM or Ctrl-C, which log the final stats and exit 0; a bind
    failure is a ServeError naming the address. ``--smoke N`` instead
    pushes N synthetic requests through the in-process transport, prints
    one JSON summary line and exits (0 iff none failed)."""
    import signal

    from euromillioner_tpu_torch.core.precision import resolve_serve_precision
    from euromillioner_tpu_torch.serve import transport

    if args.scheduler:
        cfg.serve.scheduler = args.scheduler
    # serve.mesh=(data, model) and serve.precision: validated here
    # (ConfigError, exit 17) before any restore work; (1, 1) builds no
    # mesh. The mesh counts the visible cards (EUROMILLIONER_CPU_DEVICES
    # logical devices under --device cpu)
    from euromillioner_tpu_torch.serve.session import build_serving_mesh

    resolve_serve_precision(cfg.serve.precision)
    mesh = build_serving_mesh(cfg.serve.mesh, device=args.device)
    if mesh is not None:
        logger.info("serving mesh: %s", mesh.shape)
    # the AOT program store (serve.aot.*): warmup loads the recorded
    # ladder from disk instead of compiling it
    from euromillioner_tpu_torch.serve.aotstore import open_store

    aot = open_store(cfg.serve.aot)
    if aot is not None:
        n = len(aot.entries())
        logger.info("serve.aot store at %s (%d entr%s, %.2f MB)", aot.dir,
                    n, "y" if n == 1 else "ies", aot.total_bytes() / 2**20)
    if args.model_type == "lstm":
        from euromillioner_tpu_torch.serve.continuous import (
            load_recurrent_backend, make_sequence_engine)

        backend = load_recurrent_backend(cfg, args.checkpoint,
                                         args.num_features,
                                         device=args.device)
        engine = make_sequence_engine(backend, cfg, aot=aot, mesh=mesh)
    else:
        if cfg.serve.scheduler == "continuous":
            raise ServeError(
                "serve.scheduler=continuous needs a recurrent model "
                "(--model-type lstm); row families batch per request")
        from euromillioner_tpu_torch.serve.engine import make_row_engine
        from euromillioner_tpu_torch.serve.session import load_backend

        backend = load_backend(args.model_type, args.checkpoint, cfg,
                               args.num_features, device=args.device,
                               model_file=args.model_file)
        engine = make_row_engine(backend, cfg, aot=aot, mesh=mesh)
    try:
        prec = engine.precision_desc
        logger.info("serve.precision=%s (pinned max-rel-error envelope: %s; "
                    "serving params %.3f MB)", prec["precision"],
                    prec["envelope"] or "bit-exact f32",
                    prec["serve_param_mb"])
        if args.smoke:
            logger.info("serving %s on %s (%s engine, %s)", backend.name,
                        backend.device, engine.kind,
                        json.dumps(engine.slo_desc))
            summary = transport.run_smoke(engine, args.smoke)
            print(json.dumps(summary))
            return 0 if summary["failed"] == 0 else 1
        host, port = cfg.serve.host, cfg.serve.port
        try:
            server = transport.make_server(engine, host, port)
        except OSError as e:  # address in use, bad host, privileged port
            raise ServeError(f"cannot bind {host}:{port}: {e}")
        _log_banner(backend, engine, cfg)

        def _stop(signum, frame):  # SIGTERM: the same path as Ctrl-C
            raise KeyboardInterrupt

        signal.signal(signal.SIGTERM, _stop)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            logger.info("shutting down; final stats: %s",
                        json.dumps(engine.stats()))
            for profile, child in getattr(engine, "children", {}).items():
                logger.info("final stats of the %s profile: %s", profile,
                            json.dumps(child.stats()))
            from euromillioner_tpu_torch.ops.common import launch_counts

            logger.info("kernel launches: %s", json.dumps(launch_counts()))
        finally:
            server.server_close()
        return 0
    finally:
        engine.close()


def _replay_smoke_engines(families, cfg: Config, device) -> dict:
    """family → a tiny seeded engine on ``device``, one per family of the
    trace (``replay --smoke``: the whole trace → payload → open-loop
    submit → report path with no saved artifacts). ``wide_deep`` gets an
    MLP stand-in on the same row-engine path."""
    import torch

    from euromillioner_tpu_torch.serve.engine import (InferenceEngine,
                                                      obs_kwargs)

    known = ("nn", "mlp", "wide_deep", "gbt", "rf", "classic", "lstm")
    bad = [f for f in families if f not in known]
    if bad:
        raise ServeError(f"replay --smoke has no synthetic backend for "
                         f"families {bad}; known: {list(known)}")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(200, 9)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.float32)
    engines: dict = {}
    obs = obs_kwargs(cfg.serve)
    obs["metrics_jsonl"] = obs["capture_path"] = None
    for fam in families:
        if fam == "lstm":
            from euromillioner_tpu_torch.models.lstm import build_lstm
            from euromillioner_tpu_torch.serve.continuous import (
                RecurrentBackend, make_sequence_engine)

            model = build_lstm(16, 1, 7, fused="off", device=device)
            backend = RecurrentBackend(model, feat_dim=11,
                                       compute_dtype=torch.float32)
            engines[fam] = make_sequence_engine(backend, cfg)
            continue
        if fam in ("nn", "mlp", "wide_deep"):
            from euromillioner_tpu_torch.models.mlp import build_mlp
            from euromillioner_tpu_torch.serve.session import NNBackend

            model = build_mlp((16, 16), 1, in_features=9, device=device)
            backend = NNBackend(model, (9,), compute_dtype=torch.float32)
        elif fam == "gbt":
            from euromillioner_tpu_torch.serve.session import GBTBackend
            from euromillioner_tpu_torch.trees import DMatrix, train

            backend = GBTBackend(train(
                {"objective": "binary:logistic", "max_depth": 2,
                 "device": str(device)},
                DMatrix(x, y), 2, verbose_eval=False))
        elif fam == "rf":
            from euromillioner_tpu_torch.serve.session import RFBackend
            from euromillioner_tpu_torch.trees import train_classifier

            backend = RFBackend(train_classifier(
                x, y.astype(np.int32), 2, num_trees=3, max_depth=3, seed=0,
                device=device))
        else:  # classic
            from euromillioner_tpu_torch.classic import LogisticRegression
            from euromillioner_tpu_torch.serve.session import ClassicBackend

            backend = ClassicBackend(LogisticRegression(
                steps=50, device=device).fit(x, y.astype(np.int32),
                                             num_classes=2))
        engines[fam] = InferenceEngine(
            backend, buckets=(8, 32), max_wait_ms=cfg.serve.max_wait_ms,
            warmup=False, classes=cfg.serve.classes, **obs)
    return engines


def cmd_aot(args, cfg: Config) -> int:
    """``aot``: operate the AOT program store (serve/aotstore.py).
    ``prewarm`` builds the serving engine ``serve`` would build, with the
    store, and lets its warmup compile the whole ladder into it (every
    ``serve.profiles`` entry too); for ``lstm`` the ladder is the step
    scheduler's unless ``serve.scheduler=batch`` is given, which prewarms
    the padded (rows, steps) programs. ``ls`` lists the entries,
    ``verify`` crc- and stamp-checks every blob (quarantining bad ones as
    a serving load would; exit 1 if any), ``prune`` LRU-prunes to a byte
    bound. Each prints one JSON line."""
    from euromillioner_tpu_torch.serve.aotstore import AotStore

    path = args.dir or cfg.serve.aot.dir or os.path.join(os.getcwd(),
                                                          ".aot_store")
    store = AotStore(path, max_bytes=cfg.serve.aot.max_bytes)
    if args.action == "ls":
        print(json.dumps({"dir": store.dir, "bytes": store.total_bytes(),
                          "entries": store.entries()}))
        return 0
    if args.action == "verify":
        rep = store.verify()
        print(json.dumps({"dir": store.dir, **rep}))
        return 0 if not rep["bad"] else 1
    if args.action == "prune":
        cap = (args.max_bytes if args.max_bytes is not None
               else cfg.serve.aot.max_bytes)
        removed = store.prune(cap)
        print(json.dumps({"dir": store.dir, "removed": removed,
                          "bytes": store.total_bytes(), "max_bytes": cap}))
        return 0
    from euromillioner_tpu_torch.core.precision import resolve_serve_precision

    resolve_serve_precision(cfg.serve.precision)
    cfg.serve.warmup = True  # the warmup is what compiles the ladder
    t0 = time.perf_counter()
    if args.model_type == "lstm":
        from euromillioner_tpu_torch.serve.continuous import (
            load_recurrent_backend, make_sequence_engine)

        explicit_batch = any(
            ov.split("=", 1)[0].strip().lstrip("-") == "serve.scheduler"
            and ov.split("=", 1)[1].strip() == "batch"
            for ov in args.overrides if "=" in ov)
        if not explicit_batch:
            cfg.serve.scheduler = "continuous"
        backend = load_recurrent_backend(cfg, args.checkpoint,
                                         args.num_features,
                                         device=args.device)
        make_sequence_engine(backend, cfg, aot=store).close()
    else:
        from euromillioner_tpu_torch.serve.engine import make_row_engine
        from euromillioner_tpu_torch.serve.session import load_backend

        backend = load_backend(args.model_type, args.checkpoint, cfg,
                               args.num_features, device=args.device,
                               model_file=args.model_file)
        make_row_engine(backend, cfg, aot=store).close()
    counts = store.counts()
    if counts["saves"] == 0 and not store.entries():
        raise ServeError(
            f"aot prewarm compiled nothing into {store.dir} — check the "
            "model artifact and the serve.* ladder")
    print(json.dumps({"dir": store.dir, "saved": counts["saves"],
                      "errors": counts["errors"],
                      "entries": len(store.entries()),
                      "bytes": store.total_bytes(),
                      "seconds": round(time.perf_counter() - t0, 3)}))
    return 0


def cmd_replay(args, cfg: Config) -> int:
    """``replay``: drive an engine with a recorded or generated workload
    trace at its arrival times (open loop: the clock never waits for a
    reply) and print the attainment report as one JSON line; exit 1 if
    any event failed. ``--smoke`` replays against tiny seeded in-process
    engines; otherwise the engine loads from what ``serve`` takes."""
    from euromillioner_tpu_torch.core.device import resolve_device
    from euromillioner_tpu_torch.obs.replay import replay_trace
    from euromillioner_tpu_torch.obs.workload import (generate, read_trace,
                                                      write_trace)

    if bool(args.trace) == bool(args.generate):
        raise ValueError("replay needs exactly one of --trace (a "
                         "recorded file) or --generate (a seeded "
                         "generator name)")
    device = resolve_device(args.device)  # no card: fail before any work
    trace = (read_trace(args.trace) if args.trace
             else generate(args.generate, seed=args.seed))
    if args.out:
        write_trace(args.out, trace)
        logger.info("wrote %d-event trace to %s", len(trace.events),
                    args.out)
    if args.scheduler:
        cfg.serve.scheduler = args.scheduler
    if args.smoke:
        engines = _replay_smoke_engines(trace.families, cfg, device)
    elif args.model_type == "lstm":
        from euromillioner_tpu_torch.serve.continuous import (
            load_recurrent_backend, make_sequence_engine)

        backend = load_recurrent_backend(cfg, args.checkpoint,
                                         args.num_features, device=device)
        # one engine for every family of the trace: per-family engines
        # would race for the device and split the report
        eng = make_sequence_engine(backend, cfg)
        engines = {f: eng for f in trace.families}
    else:
        from euromillioner_tpu_torch.serve.engine import make_row_engine
        from euromillioner_tpu_torch.serve.session import load_backend

        backend = load_backend(args.model_type, args.checkpoint, cfg,
                               args.num_features, device=device,
                               model_file=args.model_file)
        eng = make_row_engine(backend, cfg)
        engines = {f: eng for f in trace.families}
    try:
        report = replay_trace(engines, trace, speed=args.speed,
                              fifo=args.fifo, timeout_s=args.timeout_s)
    finally:
        for eng in {id(e): e for e in engines.values()}.values():
            eng.close()
    print(json.dumps(report))
    return 0 if report["errors"] == 0 else 1


def cmd_trace_export(args, cfg: Config) -> int:
    """``trace-export``: the request events of a capture file or metrics
    JSONL as a canonical versioned replay trace."""
    from euromillioner_tpu_torch.obs.workload import export_trace

    n = export_trace(args.jsonl, args.out)
    print(json.dumps({"events": n, "out": args.out}))
    return 0


def cmd_obs_top(args, cfg: Config) -> int:
    """``obs-top``: one summary line per second (rps, p50/p99, SLO
    attainment, occupancy) from a metrics JSONL tail, a polled ``/stats``
    or several servers' ``/metrics``."""
    from euromillioner_tpu_torch.obs import top

    modes = [bool(args.jsonl), bool(args.url), bool(args.fleet)]
    if sum(modes) != 1:
        raise ValueError("obs-top needs exactly one of --jsonl, --url, "
                         "or --fleet")
    if args.jsonl:
        return top.run_jsonl(args.jsonl, follow=not args.once,
                             max_seconds=args.idle_exit_s or None)
    if args.fleet:
        urls = [u.strip() for u in args.fleet.split(",") if u.strip()]
        return top.run_fleet(urls, interval_s=args.interval,
                             iterations=1 if args.once else None)
    return top.run_url(args.url, interval_s=args.interval,
                       iterations=1 if args.once else None)


def _probe_policy(cfg: Config):
    """``serve.fleet.*`` → the router's ProbePolicy (the one mapping the
    fleet command and the tests share)."""
    from euromillioner_tpu_torch.serve.fleet import ProbePolicy

    fl = cfg.serve.fleet
    return ProbePolicy(
        interval_s=fl.probe_interval_ms / 1e3,
        timeout_s=fl.probe_timeout_ms / 1e3,
        retries=fl.probe_retries, jitter_s=fl.probe_jitter_ms / 1e3,
        eject_attainment=fl.eject_attainment,
        eject_class=fl.eject_class,
        eject_breach_probes=fl.eject_breach_probes,
        eject_stale_probes=fl.eject_stale_probes,
        probation_probes=fl.probation_probes)


def _fleet_smoke_hosts(n: int, model_type: str, cfg: Config,
                       device) -> tuple:
    """N tiny in-process hosts on ``device`` sharing one model, weights
    from a seeded ``torch.Generator`` (the ``fleet --smoke`` path: real
    engines, real probes, no sockets). Returns ``(hosts, make_engine)``:
    the factory builds one more engine on the same model, the
    supervisor's ``spawn_fn``."""
    import torch

    from euromillioner_tpu_torch.serve.fleet import FleetHost

    gen = torch.Generator().manual_seed(0)
    if model_type == "lstm":
        from euromillioner_tpu_torch.models.lstm import build_lstm
        from euromillioner_tpu_torch.serve.continuous import (
            RecurrentBackend, StepScheduler)

        backend = RecurrentBackend(
            build_lstm(16, 1, 7, fused="off", generator=gen, device=device),
            feat_dim=11, compute_dtype=torch.float32)

        def make_engine(name: str):
            return StepScheduler(backend, max_slots=8, step_block=4,
                                 classes=cfg.serve.classes,
                                 slo_ms=cfg.serve.obs.slo_ms)
    else:
        from euromillioner_tpu_torch.models.mlp import build_mlp
        from euromillioner_tpu_torch.serve.engine import InferenceEngine
        from euromillioner_tpu_torch.serve.session import NNBackend

        backend = NNBackend(
            build_mlp((16, 16), 1, in_features=9, generator=gen,
                      device=device), (9,), compute_dtype=torch.float32)
        warmed = [False]  # one shared model: warm it once

        def make_engine(name: str):
            eng = InferenceEngine(backend, buckets=(8, 32),
                                  classes=cfg.serve.classes,
                                  slo_ms=cfg.serve.obs.slo_ms,
                                  warmup=not warmed[0])
            warmed[0] = True
            return eng

    hosts = [FleetHost(f"h{i}", make_engine(f"h{i}")) for i in range(n)]
    return hosts, make_engine


def _fleet_router(hosts, cfg: Config, policy):
    """The router over ``hosts`` with the ``serve.fleet.*`` knobs."""
    from euromillioner_tpu_torch.serve.router import FleetRouter

    fl = cfg.serve.fleet
    return FleetRouter(hosts, classes=cfg.serve.classes, policy=policy,
                       slo_ms=cfg.serve.obs.slo_ms,
                       max_route_attempts=fl.max_route_attempts,
                       max_pending=fl.max_pending,
                       migrate_on_eject=fl.migrate.enabled
                       and fl.migrate.eject,
                       migrate_export_timeout_s=fl.migrate.
                       export_timeout_ms / 1e3)


def cmd_fleet(args, cfg: Config) -> int:
    """``fleet``: one front end over N serving hosts (serve/router.py):
    router-owned admission, per-sequence host affinity, SLO-keyed health
    ejection with drain and re-route, recovery probation. ``--hosts`` (or
    ``serve.fleet.hosts``) names ``serve`` processes by URL and the front
    end answers HTTP on ``serve.host:serve.port`` until SIGTERM or
    Ctrl-C; ``--smoke N`` routes N synthetic requests over in-process
    hosts on ``--device`` and exits. ``--autoscale`` attaches the fleet
    supervisor (serve/supervisor.py); ``--release HOST`` lifts a
    crash-loop quarantine on a running front end and exits. The port has
    no compile cache to enable here: eager hosts compile nothing, and
    ``serve.aot`` stores belong to the hosts."""
    import dataclasses

    from euromillioner_tpu_torch.serve import transport
    from euromillioner_tpu_torch.serve.fleet import HttpServeHost
    from euromillioner_tpu_torch.serve.supervisor import (
        FleetSupervisor, policy_from_config)

    if args.release:
        # an operator action against a running front end: no engines
        import urllib.request

        front = (args.front
                 or f"http://{cfg.serve.host}:{cfg.serve.port}").rstrip("/")
        req = urllib.request.Request(
            front + "/admin/release",
            data=json.dumps({"host": args.release}).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=10) as resp:
                body = json.loads(resp.read())
        except Exception as e:  # noqa: BLE001 — the operator gets why
            raise ServeError(f"release failed against {front}: {e}")
        print(json.dumps(body))
        return 0 if body.get("released") else 1

    policy = _probe_policy(cfg)
    fl = cfg.serve.fleet
    sup_policy = policy_from_config(fl.autoscale, fl.migrate)
    want_supervisor = args.autoscale or fl.autoscale.enabled
    if args.autoscale and not sup_policy.autoscale:
        sup_policy = dataclasses.replace(sup_policy, autoscale=True)
    if args.smoke:
        from euromillioner_tpu_torch.core.device import resolve_device

        device = resolve_device(args.device)  # no card: fail first
        hosts, make_engine = _fleet_smoke_hosts(max(1, args.local_hosts),
                                                args.model_type, cfg, device)
        router = supervisor = None
        try:
            router = _fleet_router(hosts, cfg, policy)
            if want_supervisor:
                supervisor = FleetSupervisor(router, make_engine, sup_policy)
            summary = transport.run_smoke(router, args.smoke)
            # the JAX CLI's fleet summary: counts, not replies
            summary.pop("predictions")
            st = router.stats()
            summary["fleet"] = {"hosts": st["hosts"],
                                "rerouted": st["rerouted"],
                                "failed": st["failed"]}
            if supervisor is not None:
                summary["supervisor"] = supervisor.describe()
            print(json.dumps(summary))
            return 0 if summary["failed"] == 0 else 1
        finally:
            if supervisor is not None:
                supervisor.close()
            if router is not None:
                router.close(drain_s=5.0)
            for h in hosts:
                h.engine.close()
    urls = [u for u in ((args.hosts or "").split(",")
                        if args.hosts else fl.hosts) if u]
    if not urls:
        raise ServeError("fleet needs --hosts (or serve.fleet.hosts=) "
                         "backend URLs, or --smoke N for the in-process "
                         "path")
    kind = "sequence" if args.model_type == "lstm" else "rows"
    hosts = [HttpServeHost(f"h{i}", url, kind=kind,
                           timeout_s=fl.probe_timeout_ms / 1e3,
                           request_timeout_s=fl.request_timeout_ms / 1e3)
             for i, url in enumerate(urls)]
    router = supervisor = None
    try:
        router = _fleet_router(hosts, cfg, policy)
        if want_supervisor:
            # HTTP hosts are other processes this front end cannot start:
            # the supervisor watches (dead-host detection, quarantine on
            # /healthz and /metrics) and respawns nothing
            supervisor = FleetSupervisor(router, None, sup_policy)
            logger.info("fleet supervisor attached (watch-only over HTTP "
                        "hosts: lifecycle + quarantine, no spawning)")
        try:
            server = transport.make_server(router, cfg.serve.host,
                                           cfg.serve.port)
        except OSError as e:
            raise ServeError(
                f"cannot bind {cfg.serve.host}:{cfg.serve.port}: {e}")
        logger.info("fleet front end on http://%s:%d over %d host(s): %s "
                    "(probe every %.0f ms, eject on %s attainment < %.2f "
                    "or %d stale probes)", cfg.serve.host,
                    server.server_address[1], len(urls), urls,
                    policy.interval_s * 1e3,
                    policy.eject_class or cfg.serve.classes[0],
                    policy.eject_attainment, policy.eject_stale_probes)

        def _stop(signum, frame):  # SIGTERM: the same path as Ctrl-C
            raise KeyboardInterrupt

        signal.signal(signal.SIGTERM, _stop)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            logger.info("shutting down; final stats: %s",
                        json.dumps(router.stats()))
        finally:
            server.server_close()
        return 0
    finally:
        if supervisor is not None:
            supervisor.close()
        if router is not None:
            router.close(drain_s=5.0)
        for h in hosts:
            h.close()


def _log_banner(backend, engine, cfg: Config) -> None:
    """The JAX CLI's serving line for each engine kind."""
    s = cfg.serve
    where = f"http://{s.host}:{s.port}"
    if engine.kind == "rows":
        logger.info("serving %s on %s (buckets=%s, max_wait=%.1fms, "
                    "inflight=%d)", backend.name, where, list(s.buckets),
                    s.max_wait_ms, s.inflight)
    elif s.scheduler == "continuous":
        pc = s.preempt
        logger.info("serving %s on %s (scheduler=continuous, max_slots=%d, "
                    "step_blocks=%s, classes=%s, inflight=%d, "
                    "precision=%s, preempt=%s, elastic=%s, paging=%s, "
                    "budget=%s)", backend.name, where, s.max_slots,
                    list(engine.step_blocks), list(s.classes), s.inflight,
                    backend.precision, "on" if pc.enabled else "off",
                    f"on[{engine.pool_slots}..{s.max_slots}]"
                    if pc.elastic else "off",
                    "on" if s.paging.enabled else "off",
                    "on" if s.budget.enabled else "off")
    else:
        logger.info("serving %s on %s (scheduler=batch, row_buckets=%s, "
                    "time_buckets=%s, max_wait=%.1fms, inflight=%d)",
                    backend.name, where, list(s.buckets),
                    list(s.seq_buckets), s.max_wait_ms, s.inflight)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m euromillioner_tpu_torch",
        description="PyTorch/CUDA port of the Euromillioner CLI")
    sub = p.add_subparsers(dest="command", required=True)
    device_help = "default: cuda; the CPU runs only when asked for"
    fe = sub.add_parser("fetch", help="fetch (data.url) or parse a saved "
                                      "results page and write the "
                                      "featurized CSV")
    fe.add_argument("--html-file",
                    help="parse a saved page instead of fetching")
    fe.add_argument("--output", default="euromillions.csv")
    tr = sub.add_parser("train", help="train a booster (gbt), a random "
                                      "forest, the MLP, the LSTM or "
                                      "Wide&Deep with {train, test} watches")
    tr.add_argument("--model", default="gbt",
                    choices=["gbt", "rf", "mlp", "lstm", "wide_deep"])
    tr.add_argument("--csv", help="featurized CSV input")
    tr.add_argument("--html-file",
                    help="saved results page (default: fetch data.url)")
    tr.add_argument("--save", help="model JSON (gbt, rf) or checkpoint "
                                   "directory (mlp, lstm, wide_deep)")
    tr.add_argument("--num-classes", type=int, default=0,
                    help="rf: train a classifier with this many classes")
    tr.add_argument("--tbptt", action="store_true",
                    help="lstm: truncated-BPTT over the whole draw history "
                         "(train.tbptt_chunk_len / train.tbptt_lanes)")
    tr.add_argument("--distributed", action="store_true",
                    help="train mlp/lstm/wide_deep data-parallel, rf "
                         "row-sharded, over one rank per device "
                         "(mesh.data=N; gbt trains on one device)")
    tr.add_argument("--auto-coordinator", action="store_true",
                    help="TPU pod metadata discovery; refused here (set "
                         "COORDINATOR_ADDRESS/NUM_PROCESSES/PROCESS_ID)")
    tr.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help=f"training device ({device_help})")
    pr = sub.add_parser("predict", help="predict with a saved model")
    pr.add_argument("--model-type", default="gbt",
                    choices=["gbt", "rf", "exported"])
    pr.add_argument("--model-file", required=True,
                    help="model JSON (gbt, rf) or export dir (exported)")
    pr.add_argument("--csv", required=True)
    pr.add_argument("--has-label", action="store_true",
                    help="the CSV still holds the label column")
    pr.add_argument("--runtime", default="torch", choices=["torch", "native"],
                    help="exported: run the program through torch in this "
                         "process (in place of the JAX package's jax "
                         "runtime: the port has no JAX) or through the C++ "
                         "runner")
    pr.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help=f"prediction device ({device_help}); an export "
                         f"runs on the device it was exported for")
    ex = sub.add_parser(
        "export", help="export a trained NN checkpoint as a torch.export "
                       "program, for predict --model-type exported")
    ex.add_argument("--model", default="mlp",
                    choices=["mlp", "lstm", "wide_deep"])
    ex.add_argument("--checkpoint", required=True,
                    help="checkpoint dir (latest step is used)")
    ex.add_argument("--output", required=True, help="export directory")
    ex.add_argument("--batch", type=int, default=16,
                    help="example batch size baked into the artifact")
    ex.add_argument("--num-features", type=int, default=0,
                    help="input feature count (default: family standard)")
    ex.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help=f"the device the program runs on ({device_help})")
    rf = sub.add_parser("reference",
                        help="run the full Main.java-equivalent pipeline")
    rf.add_argument("--html-file",
                    help="saved results page (default: fetch data.url)")
    rf.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help=f"device of both boosters ({device_help})")
    sv = sub.add_parser(
        "serve", help="serve a GBT, random-forest or classic model JSON "
                      "(f32) or an MLP or Wide&Deep checkpoint "
                      "(serve.precision=f32|bf16|int8w) behind the row "
                      "engine, or an LSTM checkpoint behind a sequence "
                      "scheduler (serve.precision=f32|bf16|fused|int8w), "
                      "over HTTP on serve.host:serve.port")
    sv.add_argument("--model-type", default="gbt",
                    choices=["gbt", "rf", "mlp", "lstm", "wide_deep",
                             "classic"])
    sv.add_argument("--model-file", help="model JSON (gbt, rf, classic)")
    sv.add_argument("--checkpoint",
                    help="checkpoint dir (latest intact step is used)")
    sv.add_argument("--num-features", type=int, default=0,
                    help="input feature count (default: family standard)")
    sv.add_argument("--smoke", type=int, default=0,
                    help="serve N synthetic in-process requests and exit")
    sv.add_argument("--scheduler", choices=["batch", "continuous"],
                    help="lstm: whole-sequence micro-batches or step-level "
                         "continuous batching over a device-resident slot "
                         "pool (overrides serve.scheduler)")
    sv.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="serving device (default: cuda; the CPU runs only "
                         "when asked for)")
    fl = sub.add_parser(
        "fleet", help="front-end router over N serving hosts: admission, "
                      "per-sequence affinity, SLO-keyed health ejection "
                      "with drain/re-route, recovery probation "
                      "(serve.fleet.* knobs)")
    fl.add_argument("--hosts",
                    help="comma-separated backend serve URLs (overrides "
                         "serve.fleet.hosts)")
    fl.add_argument("--model-type", default="mlp", choices=["mlp", "lstm"],
                    help="host family: lstm fleets are sequence-kind "
                         "(whole (steps, F) payloads); also picks the "
                         "--smoke in-process host family")
    fl.add_argument("--local-hosts", type=int, default=2,
                    help="--smoke: number of in-process hosts to build")
    fl.add_argument("--smoke", type=int, default=0,
                    help="route N synthetic requests over in-process "
                         "hosts (no network) and exit")
    fl.add_argument("--autoscale", action="store_true",
                    help="attach the self-healing fleet supervisor with "
                         "autoscaling forced on (serve.fleet.autoscale.* "
                         "knobs): warm respawn of dead hosts, load-derived "
                         "host count, crash-loop quarantine")
    fl.add_argument("--release", metavar="HOST",
                    help="operator action: lift HOST's crash-loop "
                         "quarantine on a running fleet front end "
                         "(POST /admin/release) and exit")
    fl.add_argument("--front", metavar="URL",
                    help="--release: the fleet front end URL (default "
                         "http://serve.host:serve.port)")
    fl.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help=f"--smoke: the hosts' device ({device_help})")
    ot = sub.add_parser(
        "obs-top", help="one-line-per-second serving summary (rps, "
                        "p50/p99 per class, SLO attainment, occupancy) "
                        "from a metrics JSONL tail, a polled /stats "
                        "endpoint, or N servers' /metrics")
    ot.add_argument("--jsonl", help="tail this serve metrics JSONL "
                                    "(serve.metrics_jsonl output)")
    ot.add_argument("--url", help="poll GET <url>/stats instead of "
                                  "tailing a file")
    ot.add_argument("--fleet", help="comma-separated host URLs: poll "
                                    "each GET <url>/metrics and print one "
                                    "per-host attainment line per poll")
    ot.add_argument("--interval", type=float, default=1.0,
                    help="poll interval seconds (--url, --fleet)")
    ot.add_argument("--once", action="store_true",
                    help="render what exists and exit (no tail or poll "
                         "loop)")
    ot.add_argument("--idle-exit-s", type=float, default=0.0,
                    help="tail mode: exit after this many seconds with "
                         "no new records (0 = run until Ctrl-C)")
    rp = sub.add_parser(
        "replay", help="replay a workload trace open-loop against a "
                       "serving engine at its recorded arrival times and "
                       "report per-class latency and SLO attainment")
    rp.add_argument("--trace", help="trace JSONL to replay (generated, "
                                    "captured or trace-export output)")
    rp.add_argument("--generate",
                    help="generate the workload instead: poisson_burst | "
                         "diurnal | flash_crowd")
    rp.add_argument("--seed", type=int, default=0,
                    help="generator seed (same seed = byte-identical "
                         "trace)")
    rp.add_argument("--out", help="also write the trace file here")
    rp.add_argument("--speed", type=float, default=1.0,
                    help="clock scale (2.0 replays twice as fast)")
    rp.add_argument("--fifo", action="store_true",
                    help="strip class tags and explicit deadlines (the "
                         "classless FIFO baseline on identical arrivals)")
    rp.add_argument("--smoke", action="store_true",
                    help="replay against tiny seeded in-process engines "
                         "(no artifacts)")
    rp.add_argument("--model-type", default="gbt",
                    choices=["gbt", "rf", "mlp", "lstm", "wide_deep",
                             "classic"])
    rp.add_argument("--model-file", help="model JSON (gbt, rf, classic)")
    rp.add_argument("--checkpoint",
                    help="checkpoint dir (latest intact step is used)")
    rp.add_argument("--num-features", type=int, default=0,
                    help="input feature count (default: family standard)")
    rp.add_argument("--scheduler", choices=["batch", "continuous"],
                    help="lstm: the sequence scheduler (overrides "
                         "serve.scheduler)")
    rp.add_argument("--timeout-s", type=float, default=300.0,
                    help="post-replay drain timeout per request")
    rp.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help=f"serving device ({device_help})")
    te = sub.add_parser(
        "trace-export", help="extract request events from a capture file "
                             "or metrics JSONL into a canonical "
                             "versioned replay trace")
    te.add_argument("--jsonl", required=True,
                    help="source JSONL (serve.obs.capture_path or "
                         "serve.metrics_jsonl output)")
    te.add_argument("--out", required=True, help="trace output path")
    ao = sub.add_parser(
        "aot", help="AOT program store ops: prewarm a model's whole "
                    "serving ladder into the store, list / crc-verify / "
                    "LRU-prune its entries (serve.aot.* knobs)")
    ao.add_argument("action", choices=["prewarm", "ls", "verify", "prune"])
    ao.add_argument("--dir", help="store directory (overrides "
                                  "serve.aot.dir)")
    ao.add_argument("--model-type", default="mlp",
                    choices=["gbt", "rf", "mlp", "lstm", "wide_deep",
                             "classic"],
                    help="prewarm: model family (lstm prewarms the step "
                         "scheduler's (rows, block) ladder; row families "
                         "the bucket table)")
    ao.add_argument("--model-file", help="prewarm: model JSON "
                                         "(gbt, rf, classic)")
    ao.add_argument("--checkpoint",
                    help="prewarm: checkpoint dir (latest intact step)")
    ao.add_argument("--num-features", type=int, default=0,
                    help="prewarm: input feature count (default: family "
                         "standard)")
    ao.add_argument("--max-bytes", type=int, default=None,
                    help="prune: byte bound (default serve.aot.max_bytes)")
    ao.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help=f"prewarm: serving device ({device_help})")
    for s in (fe, tr, pr, ex, rf, sv, fl, ot, rp, te, ao):
        s.add_argument("overrides", nargs="*", default=[],
                       help="config overrides: section.field=value")
    return p


_COMMANDS = {"fetch": cmd_fetch, "train": cmd_train, "predict": cmd_predict,
             "export": cmd_export,
             "reference": cmd_reference, "serve": cmd_serve,
             "replay": cmd_replay, "trace-export": cmd_trace_export,
             "obs-top": cmd_obs_top, "aot": cmd_aot,
             "fleet": cmd_fleet}


def main(argv: list[str] | None = None) -> int:
    # parse_known_args so `--serve.precision=fused`-style flags fall
    # through to the override list (apply_overrides strips leading dashes)
    args, unknown = build_parser().parse_known_args(argv)
    # a --distributed launch starts its ranks on this same command line
    args.argv = list(sys.argv[1:] if argv is None else argv)
    try:
        from euromillioner_tpu_torch.core.mesh import cpu_device_count

        cpu_device_count()  # a malformed EUROMILLIONER_CPU_DEVICES: exit 2
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
