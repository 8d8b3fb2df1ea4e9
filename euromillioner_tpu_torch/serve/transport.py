"""Serving transport: the request protocol and the in-process smoke path
(the JAX package's ``serve/transport.py``; its HTTP server is not ported
yet).

``handle_request`` is the whole protocol — a pure ``payload dict →
(status, reply dict)`` function — so the smoke path exercises the same
request→batch→dispatch→reply code an HTTP front end would.
"""

from __future__ import annotations

import threading
from typing import Any

import numpy as np

from euromillioner_tpu_torch.utils.errors import ServeError

# payload keys the JAX package accepts that need parts not ported yet
_UNPORTED_KEYS = ("class", "profile", "tag")


def handle_request(engine, payload: Any) -> tuple[int, dict]:
    """(status, reply) for one predict payload ``{"rows": [[...], ...]}``:
    a row engine (``engine.kind == "rows"``) treats ``rows`` as a batch of
    independent feature rows and replies with one prediction each; a
    sequence engine treats them as one ordered sequence of per-step rows
    and replies with its single prediction. Optional ``max_wait_s``
    shortens the request's flush deadline."""
    if not isinstance(payload, dict) or "rows" not in payload:
        return 400, {"error": 'payload must be {"rows": [[...], ...]}'}
    unported = [k for k in _UNPORTED_KEYS if k in payload]
    if unported:
        return 400, {"error": f"payload keys {unported} are not ported yet"}
    try:
        x = np.asarray(payload["rows"], np.float32)
    except (TypeError, ValueError) as e:
        return 400, {"error": f"rows are not numeric: {e}"}
    max_wait_s = payload.get("max_wait_s")
    if max_wait_s is not None:
        try:
            max_wait_s = float(max_wait_s)
        except (TypeError, ValueError):
            return 400, {"error": "max_wait_s must be a number"}
        if max_wait_s < 0:
            return 400, {"error": "max_wait_s must be >= 0"}
    try:
        pred = engine.predict(x, max_wait_s=max_wait_s)
    except ServeError as e:
        return 400, {"error": str(e)}
    except Exception as e:  # noqa: BLE001 — engine faults → 500, not crash
        return 500, {"error": f"{type(e).__name__}: {e}"}
    pred = np.asarray(pred)
    n = 1 if getattr(engine, "kind", "rows") == "sequence" else len(pred)
    return 200, {"predictions": pred.tolist(), "rows": int(n)}


def smoke_payloads(n: int, feat_dim: int, max_steps: int) -> list[list]:
    """The ``n`` synthetic sequences :func:`run_smoke` sends: lengths
    4..min(16, max_steps), normal rows, from numpy seed 0 (the JAX
    package's smoke traffic)."""
    rng = np.random.default_rng(0)
    hi = min(16, max_steps)
    return [rng.normal(size=(int(rng.integers(min(4, hi), hi + 1)),
                             feat_dim)).astype(np.float32).tolist()
            for _ in range(n)]


def row_payloads(n: int, feat_shape: tuple[int, ...]) -> list[list]:
    """The ``n`` single-row requests :func:`run_smoke` sends a row engine:
    normal rows from numpy seed 0 (the JAX package's smoke traffic)."""
    rows = np.random.default_rng(0).normal(
        size=(n, *feat_shape)).astype(np.float32)
    return [rows[i:i + 1].tolist() for i in range(n)]


def run_smoke(engine, n: int, concurrency: int = 4) -> dict:
    """In-process smoke: ``n`` synthetic requests pushed through
    :func:`handle_request` from ``concurrency`` threads — single rows for
    a row engine, 4-16-step sequences for a sequence engine. The summary
    carries each reply's predictions in request order (None where the
    request failed)."""
    if getattr(engine, "kind", "rows") == "sequence":
        payloads = smoke_payloads(n, engine.backend.feat_dim,
                                  engine.time_buckets[-1])
    else:
        payloads = row_payloads(n, engine.backend.feat_shape)
    statuses: list[int] = [0] * n
    preds: list = [None] * n

    def worker(idx: int) -> None:
        for i in range(idx, n, concurrency):
            status, reply = handle_request(engine, {"rows": payloads[i]})
            statuses[i] = status
            preds[i] = reply.get("predictions")

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(min(concurrency, n))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    ok = sum(1 for s in statuses if s == 200)
    return {"requests": n, "ok": ok, "failed": n - ok,
            "stats": engine.stats(), "predictions": preds}
