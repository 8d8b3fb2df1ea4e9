#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``euromillioner_tpu_torch``) on one NVIDIA
GPU and check it end to end.

Phases, each reported on its own lines:

1. device — the card's name, power limit and clocks;
2. build — every hand-written kernel, from the checkout's sources, one
   ``nvcc`` per source, all started together;
3. kernels — each kernel against its plain PyTorch version on the card at
   the shapes its path gives it (K1: the serving buckets and the training
   batch; K2: the training batches, with K1's residuals; then the K1+K2
   Function's gradients against autograd through the scan), then its
   median time beside the plain version's and the card's bound;
4. serve — the flagship LSTM at full width (hidden 512, 2 layers, 64-step
   windows, 11 features, 7 outputs) with seeded random weights, saved as a
   checkpoint and served through the port's CLI (``serve --smoke 32``)
   under ``serve.precision=f32`` and ``=fused``: no request may fail, the
   fused run must go through K1 (launch counts reset just before it and
   read just after), its replies must lie inside the (lstm, fused)
   envelope of the f32 replies, and the f32 replies must agree with a
   direct per-sequence apply;
5. train — the flagship at full width trained through the port's CLI
   (``train --model lstm --html-file tests/golden/euromillions.html``,
   2 epochs of B=64, f32) from seeded weights: two finite watch lines, K2
   launched exactly layers x steps x epochs times and K1 that plus the
   watch evaluations (counts reset just before, read just after), its
   ms/step and examples/s; then the same command at the default bfloat16
   compute dtype, which the kernels do not take, must exit 17 (refused,
   never scanned);
6. step — one training step on the card against the same step on the CPU
   through the plain versions: the loss, every gradient and every updated
   parameter agree;
7. serve the trained checkpoint — ``serve --smoke 8`` under
   ``serve.precision=fused``, no failed request;
8. the ``kernels`` JSON line, the ``nvidia-smi`` line, and last the
   ``{"ok": true, "device": ...}`` line.

Run from the root of a checkout: ``python3 chip_smoke.py``. Without a CUDA
device, or outside a checkout, it exits non-zero and prints no result.
Any failed check ends the run with exit code 1.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

SEED = 0
HIDDEN, LAYERS, SEQ_LEN, FEATURES, OUTPUTS = 512, 2, 64, 11, 7
SMOKE_REQUESTS = 32
# K1 at the serving path's (row bucket, time bucket) shapes
K1_SHAPES = ((8, 8), (32, 16), (128, 64))
TIMED_SHAPE = (128, 64)
# K1 with residuals at the training path's shape
K1_TRAIN_SHAPE = (64, 64)
TRAIN_EPOCHS = 2
TRAIN_SMOKE_REQUESTS = 8
STEP_RUNS = 5
GOLDEN_HTML = Path("tests") / "golden" / "euromillions.html"
# kernel vs plain version, both f32 on the card: summation order only.
# Measured at most 1.49e-7 (gates) on an H100 across K1_SHAPES and
# K1_TRAIN_SHAPE; pinned at ~10x that.
K1_TOL = 1.5e-6
# f32 serve replies vs a direct per-sequence apply (other batch shapes,
# so other GEMM algorithms — rounding only): measured 6.7e-7 max-rel on
# an H100, pinned at ~10x
F32_SERVE_TOL = 1e-5
# K2 at the training path's (batch, steps) shapes; timed at the second
K2_SHAPES = ((16, 8), (64, 64))
# K2 vs its plain version, both f32 on the card, on the same K1
# residuals: summation order only (the dh carry's 4H-long dots, dwh's
# (T-1)*B-long sums, dpeep's CTA partials). Each error is taken relative
# to the output's own scale, max|ref|. Measured on an H100 at K2_SHAPES:
# dxp 3.0e-7, dpeep 2.9e-7, dwh 3.1e-6 (its 4032-term sums); pinned at
# ~10x each.
K2_TOL = {"dxp": 3e-6, "dwh": 3e-5, "dpeep": 3e-6}
# the layer's parameter gradients through K1+K2 vs autograd through the
# plain scan, relative to each gradient's scale: measured at most 2.3e-6
# (wh) on an H100 at (64, 64); pinned at ~10x
FUNCTION_GRAD_TOL = 3e-5
# one full-width training step on the card (K1+K2) vs the CPU (plain
# versions), measured on an H100 and pinned at ~10x: the loss (relative,
# measured 9.2e-8) and each gradient relative to its scale (measured at
# most 1.3e-6, 0_LSTM.wh). The updated params are compared in absolute
# terms: adam's first step is lr * g / (|g| + 3.2e-7) per element, so a
# gradient element within a few ulps of zero can move its update by a
# visible fraction of lr = 1e-3 (measured 1.0e-5).
STEP_LOSS_TOL = 1e-6
STEP_GRAD_TOL = 1.5e-5
STEP_PARAM_TOL = 1e-4
# H100 SXM data-sheet peaks (dense): FP32 non-tensor and HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES_S = 3.35e12


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, warmup: int = 3, runs: int = 20) -> float:
    """Median milliseconds of ``fn`` on the card (CUDA events per run)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def k1_inputs(batch: int, steps: int, peepholes: bool):
    """Layer-1 inputs of the flagship model at one (rows, steps) shape:
    x_proj from a real input projection, wh and peepholes as initialised."""
    from euromillioner_tpu_torch.nn.recurrent import LSTM

    gen = torch.Generator().manual_seed(SEED + batch + steps)
    layer = LSTM(FEATURES, HIDDEN, peepholes=peepholes, generator=gen,
                 device="cuda").requires_grad_(False)
    x = torch.randn((batch, steps, FEATURES), generator=gen).cuda()
    x_proj = layer._input_proj(x).contiguous()
    return x_proj, layer.wh.contiguous(), layer._peep_rows()


def max_errors(got, ref) -> tuple[float, float]:
    diff = (got.double() - ref.double()).abs().max().item()
    return diff, diff / (ref.double().abs().max().item() + 1e-30)


def phase_k1() -> dict:
    from euromillioner_tpu_torch.ops import fused_lstm as K

    worst = 0.0
    for batch, steps in K1_SHAPES + (K1_TRAIN_SHAPE,):
        for peepholes in (True, False):
            x_proj, wh, peep = k1_inputs(batch, steps, peepholes)
            ref = K.lstm_sequence_reference(x_proj, wh, peep, peepholes)
            torch.cuda.synchronize()
            hs_only = K.lstm_sequence(x_proj, wh, peep, peepholes)
            torch.cuda.synchronize()
            full = K.lstm_forward(x_proj, wh, peep, peepholes)
            torch.cuda.synchronize()
            errs = {"hs(no residuals)": max_errors(hs_only, ref[0])}
            for name, got, want in zip(("hs", "cs", "gates"), full, ref):
                errs[name] = max_errors(got, want)
            for name, (abs_err, rel_err) in errs.items():
                print(f"K1 B={batch} T={steps} H={HIDDEN} "
                      f"peepholes={peepholes} {name}: max_abs={abs_err:.3e} "
                      f"max_rel={rel_err:.3e} (tol {K1_TOL:.0e})")
                check(abs_err <= K1_TOL,
                      f"K1 {name} at B={batch} T={steps} differs by "
                      f"{abs_err:.3e} > {K1_TOL:.0e}")
                worst = max(worst, abs_err)
    timed = {}
    for batch, steps in K1_SHAPES:
        x_proj, wh, peep = k1_inputs(batch, steps, True)
        ms = time_ms(lambda: K.lstm_sequence(x_proj, wh, peep, True))
        plain_ms = time_ms(
            lambda: K.lstm_sequence_reference(x_proj, wh, peep, True))
        # the least the card could take: inputs read once (x_proj, wh,
        # peep), hs written once, and the recurrent product's
        # 2*T*B*H*4H FLOPs on the FP32 pipe
        nbytes = 4 * (x_proj.numel() + wh.numel() + peep.numel()
                      + steps * batch * HIDDEN)
        flops = 2 * steps * batch * HIDDEN * 4 * HIDDEN
        bytes_ms = nbytes / PEAK_HBM_BYTES_S * 1e3
        ops_ms = flops / PEAK_FP32_FLOPS * 1e3
        timed[batch, steps] = (ms, plain_ms, bytes_ms, ops_ms)
        print(f"K1 timing B={batch} T={steps} H={HIDDEN} f32: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{max(bytes_ms, ops_ms):.4f} ms ({flops / 1e9:.3f} GFLOP -> "
              f"{ops_ms:.4f} ms; {nbytes / 1e6:.2f} MB -> {bytes_ms:.4f} ms)")
    # with residuals (cs and gates written too) at the training shape:
    # the bytes add cs (T*B*H) and gates (T*B*4H) written once
    batch, steps = K1_TRAIN_SHAPE
    x_proj, wh, peep = k1_inputs(batch, steps, True)
    train_ms = time_ms(lambda: K.lstm_forward(x_proj, wh, peep, True))
    train_plain_ms = time_ms(
        lambda: K.lstm_sequence_reference(x_proj, wh, peep, True))
    nbytes = 4 * (x_proj.numel() + wh.numel() + peep.numel()
                  + 6 * steps * batch * HIDDEN)
    flops = 2 * steps * batch * HIDDEN * 4 * HIDDEN
    print(f"K1 timing with residuals B={batch} T={steps} H={HIDDEN} f32: "
          f"kernel {train_ms:.4f} ms, plain {train_plain_ms:.4f} ms, bound "
          f"{max(nbytes / PEAK_HBM_BYTES_S, flops / PEAK_FP32_FLOPS) * 1e3:.4f}"
          f" ms ({flops / 1e9:.3f} GFLOP; {nbytes / 1e6:.2f} MB)")
    ms, plain_ms, bytes_ms, ops_ms = timed[TIMED_SHAPE]
    return {"name": "fused_lstm_fwd", "route": "cuda",
            "source": "euromillioner_tpu_torch/csrc/fused_lstm.cu",
            "replaces": "euromillioner_tpu/ops/fused_lstm.py:88",
            "launches": 0, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
            "library_ms": None}


def k2_inputs(batch: int, steps: int, peepholes: bool):
    """K2's inputs at one shape: K1's residuals on the flagship layer's
    inputs, and a seeded incoming gradient g_hs."""
    from euromillioner_tpu_torch.ops import fused_lstm as K

    x_proj, wh, peep = k1_inputs(batch, steps, peepholes)
    residuals = K.lstm_forward(x_proj, wh, peep, peepholes)
    gen = torch.Generator().manual_seed(SEED + 7 * batch + steps)
    g_hs = torch.randn((steps, batch, HIDDEN), generator=gen).cuda()
    return wh, peep, residuals, g_hs


def layer_grads(layer, x, g, fused: str) -> dict:
    """Gradients of every parameter of ``layer`` for sum(apply(x) * g)
    with ``layer.fused`` set to ``fused``."""
    layer.fused = fused
    layer.zero_grad(set_to_none=True)
    (layer.apply(x, train=True) * g).sum().backward()
    return {n: p.grad.detach().clone() for n, p in layer.named_parameters()}


def phase_k2() -> dict:
    from euromillioner_tpu_torch.nn.recurrent import LSTM
    from euromillioner_tpu_torch.ops import fused_lstm as K

    worst = 0.0
    failures = []
    for batch, steps in K2_SHAPES:
        for peepholes in (True, False):
            wh, peep, res, g_hs = k2_inputs(batch, steps, peepholes)
            want = K.lstm_backward_reference(wh, peep, res, g_hs, peepholes)
            torch.cuda.synchronize()
            got = K.lstm_backward(wh, peep, res, g_hs, peepholes)
            torch.cuda.synchronize()
            again = K.lstm_backward(wh, peep, res, g_hs, peepholes)
            torch.cuda.synchronize()
            for name, a, b, w in zip(("dxp", "dwh", "dpeep"), got, again,
                                     want):
                abs_err, rel_err = max_errors(a, w)
                same = torch.equal(a, b)
                print(f"K2 B={batch} T={steps} H={HIDDEN} "
                      f"peepholes={peepholes} {name}: max_abs={abs_err:.3e} "
                      f"rel_to_scale={rel_err:.3e} (tol {K2_TOL[name]:.0e}), "
                      f"scale {w.abs().max().item():.3e}, "
                      f"bit-identical rerun {same}")
                if rel_err > K2_TOL[name] or not same:
                    failures.append(f"K2 {name} at B={batch} T={steps} "
                                    f"peepholes={peepholes}: rel "
                                    f"{rel_err:.3e}, rerun equal {same}")
                worst = max(worst, abs_err)
    # the Function inside the layer: every parameter's gradient through
    # K1+K2 against autograd through the plain scan, on the card
    batch, steps = K2_SHAPES[-1]
    for peepholes in (True, False):
        gen = torch.Generator().manual_seed(SEED + 11)
        layer = LSTM(FEATURES, HIDDEN, return_sequences=True,
                     peepholes=peepholes, generator=gen, device="cuda")
        x = torch.randn((batch, steps, FEATURES), generator=gen).cuda()
        g = torch.randn((batch, steps, HIDDEN), generator=gen).cuda()
        kernel = layer_grads(layer, x, g, "on")
        plain = layer_grads(layer, x, g, "off")
        for name in plain:
            abs_err, rel_err = max_errors(kernel[name], plain[name])
            print(f"K1+K2 Function grad {name} B={batch} T={steps} "
                  f"peepholes={peepholes}: max_abs={abs_err:.3e} "
                  f"rel_to_scale={rel_err:.3e} (tol {FUNCTION_GRAD_TOL:.0e})")
            if rel_err > FUNCTION_GRAD_TOL:
                failures.append(f"Function grad {name}: rel {rel_err:.3e}")
    check(not failures, "; ".join(failures))

    batch, steps = K2_SHAPES[-1]
    wh, peep, res, g_hs = k2_inputs(batch, steps, True)
    ms = time_ms(lambda: K.lstm_backward(wh, peep, res, g_hs, True))
    plain_ms = time_ms(
        lambda: K.lstm_backward_reference(wh, peep, res, g_hs, True))
    # the least the card could take: g_hs, hs, cs, gates, wh, peep read
    # once, dxp, dwh, dpeep written once; the dh carry and dwh each
    # 2*(T-1)*B*H*4H FLOPs on the FP32 pipe (the t = 0 terms are zero)
    hs, cs, gates = res
    nbytes = 4 * (g_hs.numel() + hs.numel() + cs.numel() + gates.numel()
                  + 2 * wh.numel() + 2 * peep.numel() + gates.numel())
    flops = 2 * 2 * (steps - 1) * batch * HIDDEN * 4 * HIDDEN
    bytes_ms = nbytes / PEAK_HBM_BYTES_S * 1e3
    ops_ms = flops / PEAK_FP32_FLOPS * 1e3
    print(f"K2 timing B={batch} T={steps} H={HIDDEN} f32: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{max(bytes_ms, ops_ms):.4f} ms ({flops / 1e9:.3f} GFLOP -> "
          f"{ops_ms:.4f} ms; {nbytes / 1e6:.2f} MB -> {bytes_ms:.4f} ms)")
    return {"name": "fused_lstm_bwd", "route": "cuda",
            "source": "euromillioner_tpu_torch/csrc/fused_lstm_bwd.cu",
            "replaces": "euromillioner_tpu/ops/fused_lstm.py:175",
            "launches": 0, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
            "library_ms": None}


def serve_cli(ckdir: Path, precision: str,
              requests: int = SMOKE_REQUESTS) -> dict:
    from euromillioner_tpu_torch import cli

    argv = ["serve", "--model-type", "lstm", "--checkpoint", str(ckdir),
            "--smoke", str(requests), "model.compute_dtype=float32",
            f"serve.precision={precision}"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    check(rc == 0, f"serve {precision} exited {rc}")
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    shown = {k: v for k, v in summary.items() if k != "predictions"}
    print(f"serve {precision}: failed: {summary['failed']} "
          f"{json.dumps(shown)}")
    check(summary["failed"] == 0, f"serve {precision}: requests failed")
    return summary


def phase_serve(root: Path) -> int:
    """The main path; returns K1's launches during the fused serve."""
    from euromillioner_tpu_torch.config import ServeConfig
    from euromillioner_tpu_torch.core.precision import (SERVE_ENVELOPES,
                                                        rel_error)
    from euromillioner_tpu_torch.models.lstm import build_lstm
    from euromillioner_tpu_torch.ops.fused_lstm import FUSED_LSTM_FWD
    from euromillioner_tpu_torch.serve.transport import smoke_payloads
    from euromillioner_tpu_torch.train.checkpoint import save_checkpoint

    model = build_lstm(HIDDEN, LAYERS, OUTPUTS, fused="off",
                       in_features=FEATURES,
                       generator=torch.Generator().manual_seed(SEED),
                       device="cuda").requires_grad_(False)
    ckdir = root / "build" / "chip_smoke" / "ck"
    shutil.rmtree(ckdir, ignore_errors=True)
    save_checkpoint(str(ckdir), model, step=0)

    f32 = serve_cli(ckdir, "f32")
    FUSED_LSTM_FWD.launches = 0
    fused = serve_cli(ckdir, "fused")
    launches = FUSED_LSTM_FWD.launches
    serve = ServeConfig()
    programs = fused["stats"]["batches"] + (
        len(serve.buckets) * len(serve.seq_buckets) if serve.warmup else 0)
    print(f"serve fused: K1 launches {launches} for "
          f"{fused['stats']['batches']} batches + warmup programs "
          f"(expected {LAYERS} x {programs})")
    check(launches > 0, "the fused serve never launched K1")
    check(launches == LAYERS * programs,
          f"K1 launched {launches} times, expected {LAYERS * programs}")

    payloads = smoke_payloads(SMOKE_REQUESTS, FEATURES, SEQ_LEN)
    with torch.inference_mode():
        direct = [model.apply(torch.tensor([p], device="cuda"))[0].cpu()
                  for p in payloads]
    got_f32 = torch.tensor(f32["predictions"])
    got_fused = torch.tensor(fused["predictions"])
    check(tuple(got_f32.shape) == (SMOKE_REQUESTS, OUTPUTS)
          and tuple(got_fused.shape) == (SMOKE_REQUESTS, OUTPUTS),
          "reply shapes")
    check(bool(torch.isfinite(got_f32).all() and torch.isfinite(got_fused)
               .all()), "non-finite replies")
    oracle_err = rel_error(got_f32, torch.stack(direct))
    envelope = SERVE_ENVELOPES[("lstm", "fused")]
    fused_err = rel_error(got_fused, got_f32)
    print(f"serve check: f32 vs direct apply rel {oracle_err:.3e} "
          f"(tol {F32_SERVE_TOL:.0e}); fused vs f32 rel {fused_err:.3e} "
          f"(envelope {envelope:.0e})")
    check(oracle_err <= F32_SERVE_TOL, "f32 replies disagree with apply")
    check(fused_err <= envelope, "fused replies outside the envelope")
    shutil.rmtree(ckdir.parent, ignore_errors=True)
    return launches


def golden_windows(root: Path):
    """The training path's windows: (train, test) Datasets of seq_len
    windows over the golden page, as ``cli train`` builds them."""
    from euromillioner_tpu_torch.data.dataset import Dataset
    from euromillioner_tpu_torch.data.pipeline import pipeline_from_html
    from euromillioner_tpu_torch.models.lstm import make_sequences

    tr, va = pipeline_from_html((root / GOLDEN_HTML).read_text())
    return tuple(Dataset(*make_sequences(ds.full_rows(), SEQ_LEN))
                 for ds in (tr, va))


def phase_train(root: Path) -> tuple[int, int, Path]:
    """The training main path through the CLI; returns K1's and K2's
    launches during it and the checkpoint directory."""
    from euromillioner_tpu_torch import cli
    from euromillioner_tpu_torch.config import DataConfig
    from euromillioner_tpu_torch.ops.fused_lstm import (FUSED_LSTM_BWD,
                                                        FUSED_LSTM_FWD)

    out = root / "build" / "chip_smoke"
    ckdir = out / "train"
    jsonl = out / "train.jsonl"
    shutil.rmtree(ckdir, ignore_errors=True)
    out.mkdir(parents=True, exist_ok=True)
    jsonl.unlink(missing_ok=True)
    argv = ["train", "--model", "lstm", "--html-file",
            str(root / GOLDEN_HTML), f"train.epochs={TRAIN_EPOCHS}",
            "model.compute_dtype=float32", f"train.metrics_jsonl={jsonl}",
            "--save", str(ckdir)]
    FUSED_LSTM_FWD.launches = FUSED_LSTM_BWD.launches = 0
    rc = cli.main(argv)
    k1, k2 = FUSED_LSTM_FWD.launches, FUSED_LSTM_BWD.launches
    check(rc == 0, f"train exited {rc}")
    records = [json.loads(ln) for ln in jsonl.read_text().splitlines()]
    rounds = [r for r in records if "round" in r]
    summary = [r for r in records if r.get("event") == "fit_summary"]
    for r in rounds:
        print(f"train watch line [{r['round']}]: train-rmse "
              f"{r['train-rmse']:.6f} test-rmse {r['test-rmse']:.6f}")
    check(len(rounds) == TRAIN_EPOCHS, f"{len(rounds)} watch lines, "
          f"expected {TRAIN_EPOCHS}")
    check(all(math.isfinite(r[k]) for r in rounds
              for k in ("train-rmse", "test-rmse")), "non-finite rmse")

    train_ds, test_ds = golden_windows(root)
    batch = DataConfig().batch_size
    steps = -(-len(train_ds) // batch)
    evals = -(-len(train_ds) // batch) + -(-len(test_ds) // batch)
    want_k2 = LAYERS * steps * TRAIN_EPOCHS
    want_k1 = want_k2 + LAYERS * evals * TRAIN_EPOCHS
    print(f"train: {len(train_ds)} windows -> {steps} steps/epoch of "
          f"B={batch}; K2 launches {k2} (expected {LAYERS} layers x {steps} "
          f"x {TRAIN_EPOCHS} epochs = {want_k2}); K1 launches {k1} (expected "
          f"{want_k2} + {LAYERS} x {evals} watch chunks x {TRAIN_EPOCHS} = "
          f"{want_k1})")
    check(k2 == want_k2, f"K2 launched {k2} times, expected {want_k2}")
    check(k1 == want_k1, f"K1 launched {k1} times, expected {want_k1}")
    check(len(summary) == 1, "no fit summary")
    stats = summary[0]
    print(f"train timing (device-synchronised steps, {stats['steps']} "
          f"timed): {stats['mean_step_ms']:.4f} ms/step, "
          f"{stats['examples_per_sec']:.1f} examples/s")
    # the default compute dtype (bfloat16) is one the kernels do not take:
    # the card refuses it by name (ConfigError, exit 17) and never scans
    rc = cli.main(argv[:5] + ["train.epochs=1"])
    print(f"train at the default bfloat16 compute dtype: exit {rc} "
          f"(expected 17)")
    check(rc == 17, f"a bfloat16 train on the card exited {rc}, not 17")
    return k1, k2, ckdir


def phase_step(root: Path) -> None:
    """One training step from the same parameters and batch on the card
    (K1+K2) and on the CPU (the plain versions through the Function)."""
    from euromillioner_tpu_torch.core.precision import PARITY
    from euromillioner_tpu_torch.models.lstm import build_lstm
    from euromillioner_tpu_torch.train.optim import adam
    from euromillioner_tpu_torch.train.trainer import Trainer

    train_ds, _ = golden_windows(root)
    host_batch = next(iter(train_ds.batches(64)))
    results = {}
    params = None
    for device, fused in (("cpu", "on"), ("cuda", "auto")):
        model = build_lstm(HIDDEN, LAYERS, OUTPUTS, fused=fused,
                           in_features=FEATURES,
                           generator=torch.Generator().manual_seed(SEED + 3),
                           device=device)
        trainer = Trainer(model, adam(1e-3), precision=PARITY)
        state = trainer.init_state(params)
        params = state.params
        new, loss = trainer.train_step(state, trainer._place(host_batch))
        results[device] = (loss.cpu(), {k: v.cpu() for k, v in
                                        new.opt_state["mu"].items()},
                           {k: v.cpu() for k, v in new.params.items()})
    (loss_c, mu_c, p_c), (loss_g, mu_g, p_g) = results["cpu"], results["cuda"]
    loss_err = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
    print(f"step: loss card {float(loss_g):.6f} cpu {float(loss_c):.6f} "
          f"rel {loss_err:.3e} (tol {STEP_LOSS_TOL:.0e})")
    check(loss_err <= STEP_LOSS_TOL, f"step loss differs by {loss_err:.3e}")
    worst_grad = worst_param = 0.0
    for k in mu_c:
        # after one adam step mu = (1 - b1) * grad exactly, on both sides
        _, grad_err = max_errors(mu_g[k], mu_c[k])
        param_err, _ = max_errors(p_g[k], p_c[k])
        print(f"step grad {k}: rel_to_scale {grad_err:.3e} (tol "
              f"{STEP_GRAD_TOL:.1e}); updated param max_abs {param_err:.3e} "
              f"(tol {STEP_PARAM_TOL:.0e})")
        worst_grad = max(worst_grad, grad_err)
        worst_param = max(worst_param, param_err)
    check(worst_grad <= STEP_GRAD_TOL,
          f"step gradients differ by {worst_grad:.3e}")
    check(worst_param <= STEP_PARAM_TOL,
          f"updated params differ by {worst_param:.3e}")

    # the same step's time on the card through K1+K2 and through the scan
    # (host clock around synchronised steps; a comparison, not a check)
    timed = {}
    for fused in ("auto", "off", "auto"):
        model = build_lstm(HIDDEN, LAYERS, OUTPUTS, fused=fused,
                           in_features=FEATURES,
                           generator=torch.Generator().manual_seed(SEED + 3),
                           device="cuda")
        trainer = Trainer(model, adam(1e-3), precision=PARITY)
        state = trainer.init_state(params)
        batch = trainer._place(host_batch)
        for _ in range(2):
            state, _ = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEP_RUNS):
            state, _ = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        timed.setdefault(fused, []).append(
            (time.perf_counter() - t0) * 1e3 / STEP_RUNS)
    print(f"step timing B=64 T={SEQ_LEN} H={HIDDEN} {LAYERS} layers f32: "
          f"kernels {statistics.median(timed['auto']):.4f} ms/step "
          f"(runs {', '.join(f'{t:.4f}' for t in timed['auto'])}), "
          f"plain scan {timed['off'][0]:.4f} ms/step")


def phase_serve_trained(ckdir: Path) -> int:
    """Serve the checkpoint the train phase wrote; returns K1's launches."""
    from euromillioner_tpu_torch.ops.fused_lstm import FUSED_LSTM_FWD

    FUSED_LSTM_FWD.launches = 0
    summary = serve_cli(ckdir, "fused", TRAIN_SMOKE_REQUESTS)
    launches = FUSED_LSTM_FWD.launches
    got = torch.tensor(summary["predictions"])
    check(tuple(got.shape) == (TRAIN_SMOKE_REQUESTS, OUTPUTS),
          "trained-checkpoint reply shapes")
    check(bool(torch.isfinite(got).all()), "non-finite trained replies")
    check(launches > 0, "serving the trained checkpoint never launched K1")
    print(f"serve trained checkpoint: K1 launches {launches}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    if not (root / "euromillioner_tpu_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(euromillioner_tpu_torch/ not found)", file=sys.stderr)
        return 1
    from euromillioner_tpu_torch.core.device import resolve_device
    from euromillioner_tpu_torch.ops.fused_lstm import (FUSED_LSTM_BWD,
                                                        FUSED_LSTM_FWD)

    resolve_device("cuda")  # TF32 off for the plain versions' GEMMs
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi("name,power.limit")
    print(f"device: {name} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}); {nvidia_smi('clocks.sm,clocks.max.sm')}")
    kernels = (FUSED_LSTM_FWD, FUSED_LSTM_BWD)
    try:
        with ThreadPoolExecutor(len(kernels)) as pool:
            seconds = list(pool.map(lambda k: k.build(), kernels))
        for kernel, secs in zip(kernels, seconds):
            print(f"build: {kernel.source} in {secs:.2f} s (parallel)")
            for ln in kernel.build_log.splitlines():
                if "registers" in ln or "spill" in ln:
                    print(f"build: {kernel.source}: {ln.strip()}")
        k1 = phase_k1()
        k2 = phase_k2()
        serve_k1 = phase_serve(root)
        train_k1, train_k2, ckdir = phase_train(root)
        phase_step(root)
        phase_serve_trained(ckdir)
        shutil.rmtree(ckdir.parent, ignore_errors=True)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    k1["launches"] = serve_k1 + train_k1
    k1["launches_by_path"] = {"serve": serve_k1, "train": train_k1}
    k2["launches"] = train_k2
    k2["launches_by_path"] = {"train": train_k2}
    print(json.dumps({"kernels": [k1, k2]}))
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
