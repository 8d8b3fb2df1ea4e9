#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``euromillioner_tpu_torch``) on one NVIDIA
GPU and check it end to end.

Phases, each reported on its own line:

1. device — the card's name, power limit and clocks;
2. build — every hand-written kernel, from the checkout's sources;
3. kernels — each kernel against its plain PyTorch version on the card at
   the shapes the serving path gives it, then its median time beside the
   plain version's and the card's bound;
4. serve — the flagship LSTM at full width (hidden 512, 2 layers, 64-step
   windows, 11 features, 7 outputs) with seeded random weights, saved as a
   checkpoint and served through the port's CLI (``serve --smoke 32``)
   under ``serve.precision=f32`` and ``=fused``: no request may fail, the
   fused run must go through the fused kernel (launch counts reset just
   before it and read just after), its replies must lie inside the
   (lstm, fused) envelope of the f32 replies, and the f32 replies must
   agree with a direct per-sequence apply;
5. the ``kernels`` JSON line, the ``nvidia-smi`` line, and last the
   ``{"ok": true, "device": ...}`` line.

Run from the root of a checkout: ``python3 chip_smoke.py``. Without a CUDA
device, or outside a checkout, it exits non-zero and prints no result.
Any failed check ends the run with exit code 1.
"""

from __future__ import annotations

import contextlib
import io
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

SEED = 0
HIDDEN, LAYERS, SEQ_LEN, FEATURES, OUTPUTS = 512, 2, 64, 11, 7
SMOKE_REQUESTS = 32
# K1 at the serving path's (row bucket, time bucket) shapes
K1_SHAPES = ((8, 8), (32, 16), (128, 64))
TIMED_SHAPE = (128, 64)
# kernel vs plain version, both f32 on the card: summation order only.
# Measured at most 1.49e-7 (gates) on an H100 across the K1_SHAPES
# below; pinned at ~10x that.
K1_TOL = 1.5e-6
# f32 serve replies vs a direct per-sequence apply (other batch shapes,
# so other GEMM algorithms — rounding only): measured 6.7e-7 max-rel on
# an H100, pinned at ~10x
F32_SERVE_TOL = 1e-5
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
    if peepholes:
        peep = torch.stack([layer.p_i, layer.p_f, layer.p_o,
                            torch.zeros_like(layer.p_i)])
    else:
        peep = torch.zeros((4, HIDDEN), device="cuda")
    return x_proj, layer.wh.contiguous(), peep.contiguous()


def max_errors(got, ref) -> tuple[float, float]:
    diff = (got.double() - ref.double()).abs().max().item()
    return diff, diff / (ref.double().abs().max().item() + 1e-30)


def phase_k1() -> dict:
    from euromillioner_tpu_torch.ops import fused_lstm as K

    worst = 0.0
    for batch, steps in K1_SHAPES:
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
    ms, plain_ms, bytes_ms, ops_ms = timed[TIMED_SHAPE]
    return {"name": "fused_lstm_fwd", "route": "cuda",
            "source": "euromillioner_tpu_torch/csrc/fused_lstm.cu",
            "replaces": "euromillioner_tpu/ops/fused_lstm.py:88",
            "launches": 0, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
            "library_ms": None}


def serve_cli(ckdir: Path, precision: str) -> dict:
    from euromillioner_tpu_torch import cli

    argv = ["serve", "--model-type", "lstm", "--checkpoint", str(ckdir),
            "--smoke", str(SMOKE_REQUESTS), "model.compute_dtype=float32",
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

    model = build_lstm(HIDDEN, LAYERS, OUTPUTS, in_features=FEATURES,
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
    from euromillioner_tpu_torch.ops.fused_lstm import FUSED_LSTM_FWD

    resolve_device("cuda")  # TF32 off for the plain versions' GEMMs
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi("name,power.limit")
    print(f"device: {name} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}); {nvidia_smi('clocks.sm,clocks.max.sm')}")
    try:
        seconds = FUSED_LSTM_FWD.build()
        print(f"build: fused_lstm.cu in {seconds:.2f} s")
        ptxas = [ln for ln in FUSED_LSTM_FWD.build_log.splitlines()
                 if "registers" in ln or "spill" in ln]
        for ln in ptxas:
            print(f"build: {ln.strip()}")
        k1 = phase_k1()
        k1["launches"] = phase_serve(root)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": [k1]}))
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
