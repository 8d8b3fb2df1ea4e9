"""Open-loop serving of whole sequences through ``WholeSequenceScheduler``.

Requests arrive on the schedule of ``yardstick/arrivals.py`` at the
traffic file's rate, whatever the server does; each is one history of
draws of a length from the file's range. A request's latency runs from
when it was due, so a stall of the submitting thread or of the server
shows in every later request. After the window closes no request is
offered; every request of the window is waited for (at most a minute)
and one that fails or never comes counts as a miss.

End to end: ``serve_seqs_per_s``, the sequences answered inside the
window over its length; ``serve_p95_ms``, the 95th percentile of all the
window's requests' latencies (nearest rank, a miss as infinite).
"""

from __future__ import annotations

import json
import math
import os
import tempfile
import threading
import time

import numpy as np
import torch

from perfbench.harness import load_part
from perfbench.yardstick import arrivals, compare
from perfbench.yardstick.lowp import ROUNDINGS

DRAIN_S = 60.0
HISTORIES = 2048    # distinct histories a run cycles through
SAMPLE = 4096       # replies compared with the reference


def p95(latencies: np.ndarray) -> float:
    """Nearest-rank 95th percentile."""
    ordered = np.sort(latencies)
    return float(ordered[max(0, math.ceil(0.95 * len(ordered)) - 1)])


class Driver:
    def __init__(self, ctx):
        from euromillioner_tpu_torch.serve.batcher import pick_bucket
        from euromillioner_tpu_torch.serve.continuous import (
            RecurrentBackend, WholeSequenceScheduler)

        self.ctx = ctx
        cfg, tr = ctx.config, ctx.traffic
        t = time.perf_counter()
        self.setup_parts = {}
        self.fam = load_part("families", cfg["family"])
        if ctx.device == "cuda":
            self.fam.kernels(cfg, "serve")
        t = self._part("kernels", t)
        model = self.fam.build_model(cfg, ctx.device)
        shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        self.params = self.fam.weights(cfg, shapes, ctx.seed, ctx.device)
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(self.params[name])
        self.backend = RecurrentBackend(
            model, feat_dim=cfg["in_features"], compute_dtype=torch.float32,
            precision=cfg["serve"]["precision"])
        t = self._part("model", t)
        sch = tr["scheduler"]
        self.jsonl = None
        if ctx.trace:
            fd, self.jsonl = tempfile.mkstemp(prefix="perfbench-",
                                              suffix=".jsonl")
            os.close(fd)
        self.eng = WholeSequenceScheduler(
            self.backend, row_buckets=tuple(sch["row_buckets"]),
            time_buckets=tuple(sch["time_buckets"]),
            max_wait_ms=sch["max_wait_ms"], inflight=sch["inflight"],
            metrics_jsonl=self.jsonl)
        lo, hi = tr["lengths"]
        self.due, self.lens = arrivals.schedule(ctx.seed, ctx.seconds,
                                                tr["rate_per_s"], (lo, hi))
        rng = np.random.default_rng([ctx.seed, 3])
        self.histories = rng.standard_normal(
            (HISTORIES, hi, cfg["in_features"]), np.float32)
        t = self._part("scheduler_and_traffic", t)
        # warm the shapes this traffic reaches, and no others
        steps = sorted({pick_bucket(n, sch["time_buckets"])
                        for n in range(lo, hi + 1)})
        for rb in sch["row_buckets"]:
            for tb in steps:
                for _ in range(2):
                    x = np.zeros((rb, tb, cfg["in_features"]), np.float32)
                    self.backend.padded_fn(x, np.zeros(rb, np.int64)).cpu()
        # and through the scheduler: its dispatcher thread's first products
        # (a cuBLAS handle of its own) and the drift oracle that its first
        # batch runs
        for tb in steps:
            for n in (1, sch["row_buckets"][-1]):
                futures = [self.eng.submit(self.histories[i, :tb])
                           for i in range(n)]
                for f in futures:
                    f.result(timeout=DRAIN_S)
        self._part("warm_up", t)
        self.replies = [None] * len(self.due)

    def _part(self, name: str, t: float) -> float:
        now = time.perf_counter()
        self.setup_parts[name] = now - t
        return now

    def window(self, seconds: float) -> dict:
        ctx, eng = self.ctx, self.eng
        n = len(self.due)
        done = np.full(n, np.nan)
        submitted = np.zeros(n)
        ok = np.zeros(n, bool)
        left = [n]
        lock = threading.Lock()
        all_done = threading.Event()

        def settle():
            with lock:
                left[0] -= 1
                if left[0] == 0:
                    all_done.set()

        def finish(i, f):
            done[i] = time.perf_counter()
            if not f.cancelled() and f.exception() is None:
                self.replies[i] = f.result()
                ok[i] = True
            settle()

        before = eng.stats()
        with ctx.window_span():
            t0 = time.perf_counter()
            for i in range(n):
                delay = t0 + self.due[i] - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
                submitted[i] = time.perf_counter()
                try:
                    f = eng.submit(self.histories[i % len(self.histories),
                                                  :self.lens[i]])
                except Exception:  # noqa: BLE001 — a refused request misses
                    done[i] = submitted[i]
                    settle()
                    continue
                f.add_done_callback(lambda fut, i=i: finish(i, fut))
            rest = t0 + seconds - time.perf_counter()
            if rest > 0:
                time.sleep(rest)
            t_close = time.perf_counter()
            at_close = eng.stats()
        if n:
            all_done.wait(DRAIN_S)
        self.eng.close()
        records = self.batch_records()
        window_s = t_close - t0
        lat = np.where(ok, done - (t0 + self.due), np.inf)
        in_window = int(np.sum(ok & (done <= t_close)))
        late = submitted - (t0 + self.due)
        failed = int(n - ok.sum())
        tail = {"p50_ms": float(np.median(lat)) * 1e3 if n else None,
                "p95_ms": p95(lat) * 1e3 if n else None,
                "p99_ms": float(np.sort(lat)[max(0, math.ceil(0.99 * n) - 1)])
                * 1e3 if n else None}
        notes = {"setup_parts_s": self.setup_parts, "offered": n,
                 "offered_per_s": n / seconds,
                 "answered_in_window": in_window, "tails": tail,
                 "submit_late_ms_p50": float(np.median(late)) * 1e3,
                 "submit_late_ms_max": float(late.max()) * 1e3,
                 "backlog_at_close": int(n - in_window)}
        return {"t_window": t0, "window_s": window_s, "attempted": n,
                "failed": failed, "notes": notes,
                "window_batches": at_close["batches"] - before["batches"],
                "window_sequences": (at_close["sequences"]
                                     - before["sequences"]),
                "batch_records": records[before["batches"]:
                                         at_close["batches"]],
                "end_to_end": {"serve_seqs_per_s": in_window / window_s,
                               "serve_p95_ms": p95(lat) * 1e3}}

    def batch_records(self) -> list:
        """The scheduler's per-batch records (traced runs), in completion
        order."""
        if not self.jsonl:
            return []
        with open(self.jsonl, encoding="utf-8") as fh:
            recs = [json.loads(line) for line in fh if line.strip()]
        return [r for r in recs if r.get("event") == "batch"]

    def release(self) -> None:
        self.eng.close()
        if self.jsonl and os.path.exists(self.jsonl):
            os.remove(self.jsonl)
        self.backend = None
        if self.ctx.device == "cuda":
            torch.cuda.empty_cache()

    def sample(self) -> np.ndarray:
        """The requests compared: a seeded sample of the answered ones,
        the longest among them."""
        answered = np.array([i for i, r in enumerate(self.replies)
                             if r is not None], np.int64)
        if answered.size == 0:
            return answered
        rng = np.random.default_rng([self.ctx.seed, 4])
        pick = rng.choice(answered, min(SAMPLE, answered.size),
                          replace=False)
        longest = answered[np.argmax(self.lens[answered])]
        return np.unique(np.append(pick, longest))

    def outputs(self, idx: np.ndarray, rounding: str | None = None):
        """The reference's outputs for requests ``idx``, in blocks."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        q = ROUNDINGS[rounding] if rounding else (lambda t: t)
        cfg, dev = self.ctx.config, self.ctx.device
        outs = []
        with torch.no_grad():
            for s in range(0, len(idx), 1024):
                part = idx[s:s + 1024]
                x = torch.as_tensor(self.histories[part % len(self.histories)],
                                    device=dev)
                last = torch.as_tensor(self.lens[part] - 1, device=dev)
                outs.append(self.fam.serve_reference(cfg, q)(
                    self.params, x, last).cpu())
        return torch.cat(outs) if outs else torch.zeros((0, cfg["out_dim"]))

    def check(self) -> dict:
        self.release()
        idx = self.sample()
        if idx.size == 0:
            return {"reply_gap": math.inf}
        got = np.stack([self.replies[i] for i in idx])
        return {"reply_gap": compare.replies(got, self.outputs(idx))}

    def control(self, rounding: str) -> dict:
        self.release()
        idx = self.sample()
        return {"reply_gap": compare.replies(self.outputs(idx, rounding),
                                             self.outputs(idx))}
