"""Serving transport: one request protocol, two front ends (the JAX
package's ``serve/transport.py``).

``handle_request`` is the whole protocol — a pure ``payload dict →
(status, reply dict)`` function — so the HTTP server and the in-process
smoke path run the same request→batch→dispatch→reply code.

HTTP (stdlib ``ThreadingHTTPServer``; one blocking ``predict`` per handler
thread, the engine coalesces across threads):

* ``POST /predict`` ``{"rows": [[...], ...]}`` (optional ``max_wait_s``,
  ``class``, ``profile``, and for a sequence engine ``tag``, the handle
  ``/admin/export`` names it by) → ``{"predictions": [...], "rows": n}``;
* ``GET /healthz`` — liveness and what is alive (:func:`healthz_body`);
* ``GET /stats`` — the engine's ``stats()``;
* ``GET /metrics`` — the engine's telemetry registry (its profile
  children's and the process's fault-point counters too) in Prometheus
  text exposition format 0.0.4;
* ``GET /trace?n=K`` — the last ``K`` (default 32) completed request
  spans, with the ring's recorded, buffered and dropped counts;
* ``POST /admin/export`` ``{"target": tag}`` → ``{"blob": base64 | null}``
  (one live sequence packed as a migration blob and removed here), or
  ``{"all": true}`` → ``{"blobs": [...]}`` (every live sequence);
* ``POST /admin/migrate`` ``{"blob": base64}`` → the imported sequence's
  ``{"predictions": [...], "migrated": true}`` once it finishes;
* ``POST /admin/release`` ``{"host": name}`` → ``{"host": name,
  "released": bool}``: lifts a fleet supervisor's quarantine of that host
  (a fleet front end, serve/router.py ``release_host``).

Only the step scheduler has the migration surface (``export_sequence``,
``drain_export``, ``import_sequence``); the row engine and the batch
scheduler answer both migration routes with the JAX handler's 404. Only a
fleet router has ``release_host``: every engine answers ``/admin/release``
with the 404, a router without a supervisor with a 400 naming that.
"""

from __future__ import annotations

import base64
import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

import numpy as np

from euromillioner_tpu_torch.utils.errors import ServeError
from euromillioner_tpu_torch.utils.logging_utils import get_logger

logger = get_logger("serve.transport")

# The /healthz schema version, the JAX package's: a fleet router keys its
# ejection policy on fields of this body
HEALTHZ_VERSION = 1

# the JAX handler's answers where the engine lacks the surface: the
# migration routes for a row engine or the batch scheduler, the release
# route for anything but a fleet router
_ADMIN_404 = {"/admin/export": "this engine has no live-migration surface",
              "/admin/migrate": "this engine has no live-migration surface",
              "/admin/release": "this endpoint has no fleet supervisor"}


def healthz_body(engine) -> dict:
    """The /healthz JSON: liveness, the serving mesh (``"<data>x<model>"``,
    only on a mesh), the SLO classes (and the step-block
    ladder), the precision profile with its envelope, a rollout's
    ``rollout`` rider (serving version, stage, candidate, rollbacks), and
    constant-time load figures, with the telemetry's health view
    (attainment per class, drift breaches, span count, uptime; a fleet
    router's per-host view) before the load. A part the engine lacks (a
    router has no precision profile) is left out. Nothing here waits on
    a dispatcher or the device: a fleet probes it every interval."""
    body = {"ok": True, "healthz_version": HEALTHZ_VERSION}
    mesh = getattr(engine, "mesh_desc", None)
    if mesh:
        body["mesh"] = mesh  # liveness says what is alive: the mesh
    body.update(getattr(engine, "slo_desc", None) or {})
    body.update(getattr(engine, "precision_desc", None) or {})
    rollout = getattr(engine, "rollout_desc", None)
    if rollout:
        body["rollout"] = rollout
    telemetry = getattr(engine, "telemetry", None)
    if telemetry is not None:
        body.update(telemetry.health())
    body.update(getattr(engine, "load_desc", None) or {})
    return body


def handle_request(engine, payload: Any) -> tuple[int, dict]:
    """(status, reply) for one predict payload ``{"rows": [[...], ...]}``:
    a row engine (``engine.kind == "rows"``) treats ``rows`` as a batch of
    independent feature rows and replies with one prediction each; a
    sequence engine treats them as one ordered sequence of per-step rows
    and replies with its single prediction. Optional ``max_wait_s``
    shortens the request's flush deadline and orders admission; ``class``
    names its SLO class and ``profile`` its precision profile (an unknown
    one is a 400 naming the valid ones); ``tag`` is a sequence's export
    handle (a non-empty string, sequence engines only, else a 400)."""
    if not isinstance(payload, dict) or "rows" not in payload:
        return 400, {"error": 'payload must be {"rows": [[...], ...]}'}
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
    cls = payload.get("class")
    if cls is not None and not isinstance(cls, str):
        return 400, {"error": "class must be a string (serve.classes)"}
    profile = payload.get("profile")
    if profile is not None and not isinstance(profile, str):
        return 400, {"error": "profile must be a string (serve.profiles)"}
    # profile is routed only when named: a fleet router has none
    kw = {} if profile is None else {"profile": profile}
    tag = payload.get("tag")
    if tag is not None:
        if not isinstance(tag, str) or not tag:
            return 400, {"error": "tag must be a non-empty string"}
        if getattr(engine, "kind", "rows") != "sequence":
            return 400, {"error": "tag is only valid for sequence "
                                  "engines (nothing to export)"}
        kw["tag"] = tag
    try:
        pred = engine.predict(x, max_wait_s=max_wait_s, cls=cls, **kw)
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
        # the batch scheduler refuses sequences past its largest bucket
        payloads = smoke_payloads(n, engine.backend.feat_dim,
                                  getattr(engine, "time_buckets", (16,))[-1])
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


def _admin_export(engine, payload: Any) -> tuple[int, dict]:
    """``/admin/export``: ``{"target": tag}`` packs that sequence
    (``{"blob": base64 | null}``), ``{"all": true}`` every live one
    (``{"blobs": [...]}``); 404 without the surface, 400 on a bad body."""
    exp = getattr(engine, "export_sequence", None)
    drain = getattr(engine, "drain_export", None)
    if exp is None or drain is None:
        return 404, {"error": _ADMIN_404["/admin/export"]}
    shape = 'body must be {"target": tag} or {"all": true}'
    if not isinstance(payload, dict):
        return 400, {"error": shape}
    try:
        if payload.get("all") is True:
            return 200, {"blobs": [base64.b64encode(b).decode()
                                   for b in drain(reason="drain")]}
        target = payload.get("target")
        if not isinstance(target, str) or not target:
            return 400, {"error": shape}
        blob = exp(target, reason="drain")
    except ServeError as e:
        return 400, {"error": str(e)}
    except Exception as e:  # noqa: BLE001 — engine faults → 500, not crash
        return 500, {"error": f"{type(e).__name__}: {e}"}
    return 200, {"blob": None if blob is None
                 else base64.b64encode(blob).decode()}


def _admin_migrate(engine, payload: Any) -> tuple[int, dict]:
    """``/admin/migrate``: ``{"blob": base64}`` imports one migration blob
    and answers with its prediction once it finishes; a header that does
    not fit the pool is a 400 naming the field, an engine without the
    surface a 404."""
    imp = getattr(engine, "import_sequence", None)
    if imp is None:
        return 404, {"error": _ADMIN_404["/admin/migrate"]}
    blob64 = payload.get("blob") if isinstance(payload, dict) else None
    if not isinstance(blob64, str) or not blob64:
        return 400, {"error": 'body must be {"blob": base64}'}
    try:
        blob = base64.b64decode(blob64, validate=True)
    except (ValueError, TypeError) as e:
        return 400, {"error": f"bad base64 blob: {e}"}
    try:
        pred = np.asarray(imp(blob).result())
    except ServeError as e:
        return 400, {"error": str(e)}
    except Exception as e:  # noqa: BLE001 — engine faults → 500, not crash
        return 500, {"error": f"{type(e).__name__}: {e}"}
    return 200, {"predictions": pred.tolist(), "migrated": True}


def _admin_release(engine, payload: Any) -> tuple[int, dict]:
    """``/admin/release``: ``{"host": name}`` lifts the fleet supervisor's
    quarantine of that host (``{"released": false}`` when it was not
    quarantined); 404 on an engine without ``release_host``, 400 on a bad
    body or a router without a supervisor."""
    release = getattr(engine, "release_host", None)
    if release is None:
        return 404, {"error": _ADMIN_404["/admin/release"]}
    host = payload.get("host") if isinstance(payload, dict) else None
    if not isinstance(host, str) or not host:
        return 400, {"error": 'body must be {"host": name}'}
    try:
        return 200, {"host": host, "released": bool(release(host))}
    except ServeError as e:
        return 400, {"error": str(e)}


class _Handler(BaseHTTPRequestHandler):
    engine: Any  # set by make_server on the subclass

    def _reply(self, status: int, body: dict) -> None:
        data = json.dumps(body).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _reply_text(self, status: int, text: str, content_type: str) -> None:
        data = text.encode()
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self) -> None:  # noqa: N802 — http.server API
        parsed = urllib.parse.urlsplit(self.path)
        telemetry = self.engine.telemetry
        if parsed.path == "/healthz":
            self._reply(200, healthz_body(self.engine))
        elif parsed.path == "/stats":
            self._reply(200, self.engine.stats())
        elif parsed.path == "/metrics":
            self._reply_text(200, telemetry.render(),
                             "text/plain; version=0.0.4")
        elif parsed.path == "/trace":
            q = urllib.parse.parse_qs(parsed.query)
            try:
                n = int(q.get("n", ["32"])[0])
            except ValueError:
                self._reply(400, {"error": "n must be an integer"})
                return
            snap = telemetry.trace_snapshot()
            self._reply(200, {"spans": telemetry.trace.last(n),
                              "recorded": snap["spans"],
                              "buffered": snap["buffered"],
                              "dropped": snap["dropped"]})
        else:
            self._reply(404, {"error": f"no route {self.path}"})

    def do_POST(self) -> None:  # noqa: N802 — http.server API
        if self.path != "/predict" and self.path not in _ADMIN_404:
            self._reply(404, {"error": f"no route {self.path}"})
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
            payload = json.loads(self.rfile.read(length) or b"{}")
        except ValueError as e:  # JSONDecodeError is a ValueError
            self._reply(400, {"error": f"bad JSON body: {e}"})
            return
        if self.path == "/admin/export":
            self._reply(*_admin_export(self.engine, payload))
        elif self.path == "/admin/migrate":
            self._reply(*_admin_migrate(self.engine, payload))
        elif self.path == "/admin/release":
            self._reply(*_admin_release(self.engine, payload))
        else:
            self._reply(*handle_request(self.engine, payload))

    def log_message(self, fmt: str, *args: Any) -> None:
        logger.debug("http: " + fmt, *args)


def make_server(engine, host: str, port: int) -> ThreadingHTTPServer:
    """A bound (not yet serving) HTTP server over ``engine``; the caller
    runs ``serve_forever`` and ``server_close``."""
    handler = type("BoundHandler", (_Handler,), {"engine": engine})
    return ThreadingHTTPServer((host, port), handler)
