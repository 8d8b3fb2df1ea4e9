"""Row micro-batching engine (the JAX package's ``serve/engine.py``
``InferenceEngine``, lean).

Requests of one or more feature rows queue in a :class:`MicroBatcher`; a
dispatcher thread cuts micro-batches (largest bucket reached, or the
oldest request's deadline passed), pads each to the smallest fitting
bucket of ``serve.buckets``, runs the backend's forward on the device and
keeps up to ``inflight`` batches enqueued while the oldest is read back.
Every bucket's program runs once at start (``warmup``).

SLO classes (``serve.classes``): a request names its class (``cls=``, the
HTTP ``"class"`` key); cuts take requests in (class priority, deadline,
arrival) order. The class and drift helpers here (:func:`resolve_classes`,
:func:`resolve_request_class`, :class:`ClassStats`, :class:`DriftStats`)
serve every engine, the sequence schedulers' included.

Precision profiles: an engine serves its backend's profile (or the one it
is built for); a neural backend's ``bf16``/``int8w`` replies are checked
against the f32 oracle program on the same padded batch on the first
dispatch and every ``DRIFT_EVERY``-th after it. ``serve.profiles`` adds
one child engine per extra profile over the same backend, each with its
own batcher and dispatcher, so profiles never share a micro-batch; a
request names its profile (``profile=``, the HTTP ``"profile"`` key) and
an unknown one is refused by name.

Memory budget (``serve.budget``): the engine accounts its serving params
and its queued payloads in a :class:`~euromillioner_tpu_torch.serve.
session.MemoryLedger`; under an enabled budget a submit past
``queue_bytes`` is shed with a ServeError naming the budget.

Telemetry (obs/telemetry.py ``ServeTelemetry``, ``serve.obs.*``): the
engine's counters live in a metrics registry, which ``stats()`` reads and
``GET /metrics`` renders; each request gets a trace span (``GET /trace``)
and is judged against its SLO deadline; ``serve.metrics_jsonl`` receives
one record per micro-batch and ``serve.obs.capture_path`` one replayable
trace line per admitted request. The fault points ``serve.request``,
``serve.budget`` and ``serve.dispatch`` (resilience/inject.py) sit at the
submit, the budget's front door and each micro-batch's dispatch.

Chunked tree dispatch (``serve.trees.chunk``): a tree backend that
serves chunked streams its chunk tables through this engine's ledger
(the ``tree_tables`` class); ``stats()["trees"]``, the ``/healthz``
``tree_chunks`` key and the ``serve_tree_chunks_total`` counter and
``serve_trees`` gauges appear only then, and a ``chunked_mean`` forest
is sampled against its whole-forest ``predict``.

A request larger than the largest bucket is cut into bucket-sized
requests, each admitted on its own (its own trace id, one replay event for
the whole), and the reply joins theirs in order; a cut the batcher refuses
un-admits itself and the cuts after it (the request counter and the
budget's queue bytes).

The AOT program store (``serve.aot``, serve/aotstore.py): with a store
each bucket's program is compiled ahead of time (``row``; a chunked
ensemble's chunk program, ``tree_chunk``) through one
:class:`~euromillioner_tpu_torch.serve.session.ExecutableCache` the
profile children share; warmup preloads the warm manifest first.
``stats()["aot"]``, ``/healthz`` ``aot_hits`` and the ``serve_aot`` gauges
appear only then. The f32 drift oracle stays eager.

The serving mesh (``serve.mesh``): an engine over a meshed
:class:`~euromillioner_tpu_torch.serve.session.ModelSession` rounds its
bucket table up to multiples of the data axis, uploads each batch's rows
shard by shard (``session.put_rows``: the ``serve.shard`` fault point
fails that batch only) and runs the session's meshed program; ``stats()``,
``/healthz`` and every batch record carry ``mesh`` (``"<data>x<model>"``),
and the records the upload's wall time, ``shard_put_ms``. A meshed session
is not bound to the AOT store.
"""

from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import Future
from types import SimpleNamespace
from typing import Sequence

import numpy as np
import torch

from euromillioner_tpu_torch.core.device import upload
from euromillioner_tpu_torch.core.precision import (rel_error,
                                                    resolve_serve_precision,
                                                    serve_envelope)
from euromillioner_tpu_torch.core.prefetch import DoubleBuffer
from euromillioner_tpu_torch.obs.telemetry import ServeTelemetry
from euromillioner_tpu_torch.resilience import fault_point
from euromillioner_tpu_torch.serve.batcher import (LATENCY_WINDOW,
                                                   MicroBatcher, Request,
                                                   pad_rows, percentile,
                                                   pick_bucket,
                                                   resolve_future,
                                                   validate_buckets)
from euromillioner_tpu_torch.serve.session import (BudgetPolicy,
                                                   MemoryLedger,
                                                   admit_queue_bytes)
from euromillioner_tpu_torch.utils.errors import ServeError
from euromillioner_tpu_torch.utils.logging_utils import get_logger

logger = get_logger("serve.engine")

# a narrow profile's replies are checked against the f32 oracle on the
# first readback and every 64th after it (DriftStats)
DRIFT_EVERY = 64


def resolve_request_class(class_priority: dict[str, int],
                          cls: str | None) -> tuple[str, int]:
    """One request's class name → ``(name, priority)``. None is the
    highest-priority class; an unknown name is a :class:`ServeError`
    naming the valid ones (the transport's 400)."""
    if cls is None:
        cls = next(iter(class_priority))
    prio = class_priority.get(cls)
    if prio is None:
        raise ServeError(
            f"unknown request class {cls!r}; serving classes are "
            f"{list(class_priority)}")
    return cls, prio


def resolve_classes(classes) -> dict[str, int]:
    """``serve.classes`` names → priority ranks (0 = most urgent, by
    position): non-empty, unique, non-blank, else a :class:`ServeError`
    at engine build."""
    names = [str(c).strip() for c in classes]
    if not names or len(set(names)) != len(names) or any(not n
                                                         for n in names):
        raise ServeError(
            f"serve.classes must be non-empty unique names, got {classes!r}")
    return {name: rank for rank, name in enumerate(names)}


def param_bytes(tree) -> int:
    """Bytes of every tensor in a (nested) dict/list/tuple of tensors —
    int8w's value and scale tensors included."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(param_bytes(t) for t in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(param_bytes(t) for t in tree)
    return 0


class ClassStats:
    """Per-class completion latency: all-time counts and a bounded recent
    window for p50/p99. Not thread-safe: mutate under the engine's stats
    lock."""

    def __init__(self, classes):
        self._lat: dict[str, collections.deque] = {
            c: collections.deque(maxlen=LATENCY_WINDOW) for c in classes}
        self._n = {c: 0 for c in classes}

    def observe(self, cls: str, seconds: float) -> None:
        if cls in self._lat:
            self._lat[cls].append(seconds)
            self._n[cls] += 1

    def snapshot(self) -> dict:
        return {
            c: {"completed": self._n[c],
                "p50_ms": round(percentile(sorted(d), 0.50) * 1e3, 3),
                "p99_ms": round(percentile(sorted(d), 0.99) * 1e3, 3)}
            for c, d in self._lat.items()}


class DriftStats:
    """Sampled drift of a narrow profile's replies from the f32 oracle:
    last/max rel error, checks, and breaches of the pinned envelope (the
    first breach logs a warning). Not thread-safe: mutate under the
    engine's stats lock."""

    def __init__(self, profile: str, envelope: float):
        self.profile = profile
        self.envelope = envelope
        self.last = 0.0
        self.max = 0.0
        self.checks = 0
        self.breaches = 0

    def observe(self, drift: float) -> None:
        self.last = drift
        self.max = max(self.max, drift)
        self.checks += 1
        if self.envelope > 0.0 and drift > self.envelope:
            self.breaches += 1
            if self.breaches == 1:
                logger.warning(
                    "precision=%s drift %.3e exceeds the pinned envelope "
                    "%.3e; further breaches are counted in stats()",
                    self.profile, drift, self.envelope)

    def snapshot(self) -> dict:
        return {"profile": self.profile, "envelope": self.envelope,
                "drift_last": round(self.last, 8),
                "drift_max": round(self.max, 8),
                "drift_checks": self.checks,
                "envelope_breaches": self.breaches}

    def desc(self, nbytes: int) -> dict:
        """The /healthz and banner surface: profile, pinned envelope and
        the serving params' size (``nbytes``)."""
        return {"precision": self.profile, "envelope": self.envelope,
                "serve_param_mb": round(nbytes / 2**20, 3)}

    def sample(self, got, oracle_fn, lock) -> float | None:
        """One drift measurement of ``got`` against ``oracle_fn()``,
        recorded under ``lock``; an oracle failure is logged, never a
        request failure."""
        try:
            drift = rel_error(got, oracle_fn())
        except Exception as e:  # noqa: BLE001 — monitoring only
            logger.warning("drift oracle check failed (%r); serving "
                           "continues", e)
            return None
        with lock:
            self.observe(drift)
        return drift


class MetricsSink:
    """JSONL records of a serving engine, through the one best-effort
    emitter of its :class:`~euromillioner_tpu_torch.obs.telemetry.
    ServeTelemetry` (a failing sink is disabled with one warning and
    serving continues)."""

    telemetry: ServeTelemetry

    @property
    def _jsonl(self):
        """The live JSONL writer, or None once disabled or closed."""
        return self.telemetry.emitter.writer

    def _observe(self, record: dict) -> None:
        self.telemetry.emit(record)


def _joined(reqs: list[Request]) -> Future:
    """One future over the cut requests of an oversized submit: their
    replies joined in order, or the first failure."""
    outer: Future = Future()
    pending = [len(reqs)]
    lock = threading.Lock()

    def done(f: Future) -> None:
        with lock:
            if outer.done():
                return
            exc = None if f.cancelled() else f.exception()
            if f.cancelled() or exc is not None:
                outer.set_exception(exc or ServeError(
                    "a part of the request was cancelled"))
                return
            pending[0] -= 1
            if pending[0] == 0:
                outer.set_result(np.concatenate(
                    [r.future.result() for r in reqs]))

    for r in reqs:
        r.future.add_done_callback(done)
    return outer


class InferenceEngine(MetricsSink):
    """Dynamic micro-batching over one row backend (``serve.session``'s
    ``NNBackend``, ``GBTBackend``, ``RFBackend`` or ``ClassicBackend``):
    ``submit`` returns a future, ``predict`` blocks. ``precision`` is the
    profile this engine serves (default: the backend's); ``profiles``
    adds a child engine for each other one. ``obs_enabled``,
    ``trace_capacity``, ``slo_ms``, ``capture_path`` and
    ``metrics_jsonl`` are the telemetry's (``serve.obs.*``)."""

    kind = "rows"  # transport: a request is a batch of independent rows

    def __init__(self, backend, *, buckets: Sequence[int] = (8, 32, 128),
                 max_wait_ms: float = 2.0, inflight: int = 2,
                 warmup: bool = True,
                 classes: Sequence[str] = ("interactive", "bulk"),
                 precision: str | None = None,
                 profiles: Sequence[str] = (), budget=None,
                 metrics_jsonl: str | None = None, obs_enabled: bool = True,
                 trace_capacity: int = 512, slo_ms: Sequence[float] = (),
                 capture_path: str | None = None, aot=None,
                 max_executables: int = 16, exec_cache=None):
        from euromillioner_tpu_torch.serve.session import ModelSession

        if isinstance(backend, ModelSession) and backend.mesh is None:
            # a session without a mesh is its backend
            precision = precision or backend.precision
            aot = aot if aot is not None else backend.aot
            backend = backend.backend
        self.backend = backend
        self._meshed = isinstance(backend, ModelSession)
        # where the JAX package's engine holds its backend (a session);
        # replay's payload_for reads the feature shape there
        self.session = (backend if self._meshed
                        else SimpleNamespace(backend=backend))
        if self._meshed and aot is not None:
            logger.info("serve.aot: meshed session executables are not "
                        "persisted (RAM tier only)")
            aot = None
        self.precision = (resolve_serve_precision(precision) if precision
                          else backend.precision)
        self.envelope = serve_envelope(backend.family, self.precision)
        # every extra profile is validated before anything is built: an
        # unknown name or an unpinned (family, profile) pair is a
        # ConfigError
        extra: list[str] = []
        for p in profiles:
            p = resolve_serve_precision(p)
            serve_envelope(backend.family, p)
            if p != self.precision and p not in extra:
                extra.append(p)
        # the profile's program and params, built here on the
        # constructing thread: f32's program is the oracle, ``apply``
        self._program = backend.serve_apply(self.precision)
        self._serve_params = backend.serve_params(self.precision)
        self._class_priority = resolve_classes(classes)
        self.classes = tuple(self._class_priority)
        self._cls_stats = ClassStats(self.classes)
        self._drift = DriftStats(self.precision, self.envelope)
        self._n_dispatched = 0  # dispatcher thread only
        self.buckets = (backend.round_buckets(buckets) if self._meshed
                        else validate_buckets(buckets))
        self.max_batch = self.buckets[-1]
        if inflight < 1:
            raise ServeError(f"inflight must be >= 1, got {inflight}")
        self._feat_shape = tuple(backend.feat_shape)
        self._batcher = MicroBatcher(self.max_batch, max_wait_ms / 1000.0)
        self._buffer = DoubleBuffer(depth=inflight)
        # byte accounting (serve.budget): serving params and queued
        # payloads; queue_bytes is enforced only under an enabled policy
        self._budget = budget or BudgetPolicy()
        if self._budget.enabled:
            self._budget.validate()
        self._mem = MemoryLedger({"queue": self._budget.queue_bytes}
                                 if self._budget.enabled else None)
        self._mem.set_bytes("params", self._param_bytes())
        # chunked tree dispatch (serve.trees.chunk): the backend streams
        # its chunk tables through THIS engine's ledger, and the telemetry
        # grows the chunk counter and the serve_trees gauges
        self._n_chunks = 0  # chunk dispatches a batch; 0: unchunked
        if getattr(backend, "chunked", None) is not None:
            backend.attach_ledger(self._mem)
            self._n_chunks = backend.tree_counts()["n_chunks"]
        # the AOT program store (serve.aot): the programs compiled ahead
        # of time, through one executable cache that the profile children
        # share; without a store every program runs eagerly
        self._exec = exec_cache
        if aot is not None and exec_cache is None:
            self._exec = self._bind_aot(aot, max_executables)
        if self._exec is not None:
            probe = backend.prepare(np.zeros((1, *self._feat_shape),
                                             np.float32))
            self._prep_feat = tuple(probe.shape[1:])
            self._prep_dtype = probe.dtype
            self._aot_fn = (None if self._n_chunks
                            else backend.aot_program(self.precision))
        # the telemetry: registry counters (the stats() store), trace
        # ring, SLO attainment, the shared JSONL emitter
        self.telemetry = ServeTelemetry(
            kind="rows", family=backend.family, profile=self.precision,
            classes=self.classes, enabled=obs_enabled,
            trace_capacity=trace_capacity, slo_ms=slo_ms,
            metrics_jsonl=metrics_jsonl, capture_path=capture_path,
            queue_depth_fn=lambda: self._batcher.queue_depth,
            tree_counts_fn=(backend.tree_counts if self._n_chunks
                            else None),
            aot_counts_fn=(self._exec.aot_counts if self._exec is not None
                           else None))
        self.telemetry.register_drift(self._drift)
        self._lock = threading.Lock()
        self._latencies: collections.deque = collections.deque(
            maxlen=LATENCY_WINDOW)
        self._children: dict[str, InferenceEngine] = {}
        self._t_start = time.monotonic()
        self._closed = False
        self._thread = None
        try:
            if warmup:
                self.warmup()
            self.telemetry.stats_fn = self.stats
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="serve-dispatch")
            self._thread.start()
            # children once the parent is live: same backend, their own
            # batcher, dispatcher and telemetry; their registries render
            # in the parent's /metrics
            for p in extra:
                child = InferenceEngine(
                    backend, buckets=self.buckets, max_wait_ms=max_wait_ms,
                    inflight=inflight, warmup=warmup, classes=classes,
                    precision=p, obs_enabled=obs_enabled,
                    trace_capacity=trace_capacity, slo_ms=slo_ms,
                    exec_cache=self._exec)
                self._children[p] = child
                self.telemetry.extra_registries += (
                    child.telemetry.registry,)
        except BaseException:
            self.close()
            raise

    @property
    def children(self) -> dict:
        """The child engines, by the extra profile each serves."""
        return dict(self._children)

    def _param_bytes(self) -> int:
        """Device bytes of the params this engine's profile serves: a tree
        backend's resident tables (the chunked dispatch's two-block
        window), else every tensor of ``serve_params``."""
        own = getattr(self.backend, "serve_param_bytes", None)
        return own if own is not None else param_bytes(self._serve_params)

    @property
    def mesh_desc(self) -> str | None:
        """``"<data>x<model>"`` of a meshed session, else None."""
        return self.backend.mesh_desc if self._meshed else None

    def _put(self, x: np.ndarray, warm: bool = False):
        if self._meshed:
            return self.backend.put_rows(x, fault=not warm)
        return upload(x, self.backend.device)

    def _bind_aot(self, aot, maxsize: int):
        """This engine's executable cache over the store's ``row`` family
        (identity: the f32 params' structure; the profile rides in each
        bucket's key), or ``tree_chunk`` for a chunked ensemble (identity:
        one chunk block and the chunk programs' signature, so a grown
        ensemble compiles nothing)."""
        from euromillioner_tpu_torch.serve.session import ExecutableCache

        b = self.backend
        cache = ExecutableCache(maxsize)
        if self._n_chunks:
            blk = {k: torch.from_numpy(v)
                   for k, v in b.chunked.blocks[0].items()}
            space = aot.space(program="tree_chunk", family=b.family,
                              backend_name=f"{b.name}|{b.chunked.signature}",
                              params=blk, device=b.device)
        else:
            space = aot.space(program="row", family=b.family,
                              backend_name=b.name,
                              params=b.aot_program("f32")[1],
                              device=b.device)
        cache.bind_aot(space)
        return cache

    def _compiled(self, bucket: int):
        """The AOT store's program for one bucket of this engine's profile:
        ``(program, params, tail)``."""
        fn, params, tail = self._aot_fn
        shape = (bucket, *self._prep_feat)
        exe = self._exec.get_or_compile(
            (shape, self._prep_dtype.str, self.precision), fn,
            lambda: (params, self._put(np.zeros(shape, self._prep_dtype))))
        return exe, params, tail

    def _chunk_leaves(self, block: dict, binned: torch.Tensor):
        """The AOT store's leaf-value program of one chunk block at
        ``binned``'s rows (chunk-shaped: any block of the ensemble)."""
        exe = self._exec.get_or_compile(
            ("chunk", tuple(binned.shape), self._prep_dtype.str),
            self.backend.chunked.leaves_apply, lambda: (block, binned))
        return exe(block, binned)

    def _forward(self, x_dev: torch.Tensor, bucket: int,
                 counted: bool = True):
        """This engine's program on one padded batch: eager, or the AOT
        store's compiled program followed by its eager tail."""
        if self._n_chunks:
            leaves = self._chunk_leaves if self._exec is not None else None
            return self.backend.apply(x_dev, counted=counted, leaves=leaves)
        if self._exec is None:
            return self._program(x_dev)
        exe, params, tail = self._compiled(bucket)
        with torch.inference_mode():
            y = exe(params, x_dev)
            return y if tail is None else tail(y)

    def warmup(self) -> None:
        """Run every bucket's program once, so the first request pays for
        no kernel build, allocator growth or library initialisation. With
        the AOT store the warm manifest preloads first, so each bucket's
        program comes from RAM or disk instead of a compile."""
        if self._exec is not None:
            self._exec.preload_aot()
        for b in self.buckets:
            x = np.zeros((b, *self._feat_shape), np.float32)
            # warmups are no chunk dispatches
            self._forward(self._put(self.backend.prepare(x), warm=True), b,
                          counted=False).cpu()

    @property
    def slo_desc(self) -> dict:
        """/healthz: the classes this engine admits, in priority order."""
        return {"classes": list(self.classes)}

    @property
    def load_desc(self) -> dict:
        """/healthz: constant-time load figures (no percentile sort);
        ``tree_chunks`` only while the chunked tree dispatch is active."""
        out = {"queue_depth": self._batcher.queue_depth}
        if self._exec is not None:
            out["aot_hits"] = int(self._exec.aot_counts()["hits"])
        if self._n_chunks:
            out["tree_chunks"] = int(self.backend.tree_counts()["chunks"])
        return out

    def exec_cache_counts(self) -> dict:
        """The AOT store's RAM tier: compiles, hits, evictions, size and
        compile_ms (zeros without a store)."""
        if self._exec is None:
            return {"compiles": 0, "hits": 0, "evictions": 0, "size": 0,
                    "compile_ms": 0.0}
        return self._exec.counts()

    @property
    def precision_desc(self) -> dict:
        """/healthz and the banner: profile, envelope, params' size, and
        the served profiles where children serve more."""
        desc = self._drift.desc(self._param_bytes())
        if self._children:
            desc["profiles"] = [self.precision, *self._children]
        return desc

    def _route_profile(self, profile: str | None
                       ) -> "InferenceEngine | None":
        """None or this engine's profile → None (served here); a child's
        profile → that child; any other is a :class:`ServeError` naming
        the servable ones (the 400)."""
        if profile is None or profile == self.precision:
            return None
        child = self._children.get(profile)
        if child is None:
            raise ServeError(
                f"unknown precision profile {profile!r}; serving profiles "
                f"are {[self.precision, *self._children]}")
        return child

    # -- request side ---------------------------------------------------
    def submit(self, x: np.ndarray, max_wait_s: float | None = None,
               cls: str | None = None, profile: str | None = None
               ) -> Future:
        """Enqueue rows ``(n, *feat)`` (a single row ``feat`` is lifted to
        one); resolves to an ``(n, out)`` array. ``max_wait_s`` shortens
        this request's flush deadline (clamped to the engine's); ``cls``
        names its SLO class (default: the most urgent); ``profile`` its
        precision profile (default: the engine's)."""
        child = self._route_profile(profile)
        if child is not None:
            return child.submit(x, max_wait_s=max_wait_s, cls=cls)
        cls, prio = resolve_request_class(self._class_priority, cls)
        x = np.asarray(x, np.float32)
        if x.shape == self._feat_shape:
            x = x[None]
        if x.shape[1:] != self._feat_shape:
            raise ServeError(
                f"request rows have feature shape {x.shape[1:]}, model "
                f"wants {self._feat_shape}")
        fault_point("serve.request", rows=len(x))
        if len(x) == 0:
            f: Future = Future()
            f.set_result(np.empty((0,), self.backend.out_dtype))
            return f
        tm = self.telemetry
        self._admit_bytes(cls, x.nbytes)
        # a request past the largest bucket is cut into bucket-sized
        # requests, each admitted on its own (its own trace id), and the
        # reply joins theirs in order
        reqs = []
        for i in range(0, len(x), self.max_batch):
            req = Request(x=x[i:i + self.max_batch], priority=prio, cls=cls,
                          span=tm.trace_id(cls))
            if max_wait_s is not None:
                # the flush deadline is clamped to the engine's coalescing
                # ceiling; the SLO deadline is the client's raw ask
                req.deadline = req.t_submit + max(
                    0.0, min(float(max_wait_s), self._batcher.max_wait_s))
                req.slo_deadline = req.t_submit + max(0.0,
                                                      float(max_wait_s))
            reqs.append(req)
        tm.requests.inc(len(reqs))
        for i, req in enumerate(reqs):
            try:
                self._batcher.submit(req)
            except Exception:
                # un-admit the requests that never reached the batcher
                tm.requests.inc(-(len(reqs) - i))
                if self._budget.enabled:
                    self._mem.sub("queue", sum(r.x.nbytes
                                               for r in reqs[i:]))
                raise
        # captured after admission, one event for the whole request: a
        # rejected submit is not workload, and replay cuts it again
        tm.capture_request(cls, rows=len(x), deadline_s=max_wait_s)
        if len(reqs) == 1:
            return reqs[0].future
        return _joined(reqs)

    def _admit_bytes(self, cls: str, nbytes: int) -> None:
        """The budget's front door: reserve ``nbytes`` of the ``queue``
        class or shed the submit with a ServeError naming the budget
        (counted in ``serve_budget_shed_total``). Admitted payloads stay
        accounted until their batch dispatches. The ``serve.budget``
        fault point rides here: a fire rejects only this submit."""
        if not self._budget.enabled:
            return
        fault_point("serve.budget", rows=0,
                    queue_bytes=int(self._mem.bytes("queue")))
        admit_queue_bytes(self._mem, self._budget, nbytes, cls,
                          self.telemetry.budget_shed.inc, logger)

    def predict(self, x: np.ndarray, max_wait_s: float | None = None,
                cls: str | None = None, profile: str | None = None
                ) -> np.ndarray:
        return self.submit(x, max_wait_s=max_wait_s, cls=cls,
                           profile=profile).result()

    # -- dispatcher thread ----------------------------------------------
    def _run(self) -> None:
        while True:
            # with device work in flight, poll instead of blocking so the
            # oldest batch's readback proceeds while requests trickle in
            batch = self._batcher.next_batch(
                timeout=None if self._buffer.empty else 0.0)
            if batch is None:
                break
            if batch:
                self._dispatch(batch)
            elif not self._buffer.empty:
                self._complete(self._buffer.pop())
        for item in self._buffer.drain():
            self._complete(item)

    def _dispatch(self, batch: list[Request]) -> None:
        t0 = time.monotonic()
        rows = sum(r.rows for r in batch)
        if self._budget.enabled:
            # the batch left the queue, whatever its dispatch's outcome
            self._mem.sub("queue", sum(r.x.nbytes for r in batch))
        try:
            fault_point("serve.dispatch", rows=rows, requests=len(batch))
            bucket = pick_bucket(rows, self.buckets)
            x = (batch[0].x if len(batch) == 1
                 else np.concatenate([r.x for r in batch]))
            padded = pad_rows(x, bucket)
            prepared = self.backend.prepare(padded)
            t_put = time.monotonic()
            x_dev = self._put(prepared)
            t_h2d = time.monotonic()
            y_dev = self._forward(x_dev, bucket)
            t_disp = time.monotonic()
            if self._n_chunks:
                # one chunked batch = n_chunks chunk dispatches
                self.telemetry.tree_chunks.inc(self._n_chunks)
            ref_dev = None
            if self.precision != "f32":
                # the sampled drift check: the same padded batch through
                # the f32 oracle program, compared in _complete; a chunked
                # tree backend's profile is the chunk stream itself, so
                # its oracle is the whole-ensemble predict, deferred
                if self._n_dispatched % DRIFT_EVERY == 0:
                    ref_dev = ((lambda _x=padded: self.backend.predict(_x))
                               if self._n_chunks
                               else self.backend.apply(x_dev))
                self._n_dispatched += 1
        except Exception as e:  # noqa: BLE001 — fail the batch, keep serving
            self._fail(batch, e)
            return
        done = self._buffer.push((batch, rows, bucket, t0, y_dev, ref_dev,
                                  t_put, t_h2d, t_disp))
        if done is not None:
            self._complete(done)

    def _fail(self, batch: list[Request], exc: BaseException) -> None:
        logger.warning("micro-batch of %d request(s) failed: %r", len(batch),
                       exc)
        self.telemetry.errors.inc()
        self.telemetry.failed.inc(len(batch))
        for req in batch:
            resolve_future(req.future, exc=exc)
        self._observe({"event": "batch_error", "requests": len(batch),
                       "error": repr(exc)[:200]})

    def _complete(self, item) -> None:
        batch, rows, bucket, t0, y_dev, ref_dev, t_put, t_h2d, t_disp = item
        tm = self.telemetry
        t_fin = time.monotonic()
        try:
            y = y_dev.cpu().numpy().astype(self.backend.out_dtype)
        except Exception as e:  # noqa: BLE001 — a device fault fails the batch
            self._fail(batch, e)
            return
        t_read = time.monotonic()
        drift = None
        if ref_dev is not None:
            oracle = (ref_dev if callable(ref_dev)
                      else lambda: ref_dev.cpu().numpy())
            drift = self._drift.sample(y, oracle, self._lock)
        now = time.monotonic()
        # accounting BEFORE futures resolve: a returned predict() sees
        # itself in stats(). The spans share the batch's host stamps (the
        # device work ends inside the blocking read: its start and end
        # bound the compute and readback stages); no sync is added.
        waits = [now - r.t_submit for r in batch]
        tm.record_batch(batch, (("h2d_put", t_h2d), ("dispatch", t_disp),
                                ("compute", t_fin), ("readback", t_read)),
                        now)
        tm.observe_batch([(r.cls, w, r.slo_deadline, r.t_submit)
                          for r, w in zip(batch, waits)], now)
        with self._lock:
            self._latencies.extend(waits)
            for r, w in zip(batch, waits):
                self._cls_stats.observe(r.cls, w)
        tm.completed.inc(len(batch))
        tm.rows.inc(rows)
        tm.batches.inc()
        tm.fill_sum.inc(rows / bucket)
        tm.batch_latency.observe(now - t0)
        off = 0
        for req in batch:
            resolve_future(req.future, y[off:off + req.rows].copy())
            off += req.rows
        rec = {
            "event": "batch", "requests": len(batch), "rows": rows,
            "bucket": bucket, "fill_ratio": round(rows / bucket, 4),
            "queue_depth": self._batcher.queue_depth,
            "dispatch_to_done_ms": round((now - t0) * 1e3, 3),
            "oldest_e2e_ms": round(max(waits) * 1e3, 3)}
        if tm.enabled:
            rec["trace_ids"] = [r.span for r in batch if r.span is not None]
            rec["stage_ms"] = {
                "put": round((t_h2d - t_put) * 1e3, 3),
                "compute": round((t_fin - t0) * 1e3, 3),
                "readback": round((t_read - t_fin) * 1e3, 3)}
        if self.precision != "f32":
            rec["precision"] = self.precision
            if drift is not None:
                rec["drift"] = round(drift, 8)
        if self._meshed:
            rec["mesh"] = self.mesh_desc
            rec["shard_put_ms"] = round((t_h2d - t_put) * 1e3, 3)
        self._observe(rec)

    # -- introspection / lifecycle --------------------------------------
    def stats(self) -> dict:
        """Counters and p50/p99 request latency over the recent window,
        under the JAX row engine's key names (its ``slo`` and ``trace``
        sections are the telemetry's ``attainment()`` and
        ``trace_snapshot()``); the counters are read from the telemetry
        registry (the store ``GET /metrics`` renders)."""
        tm = self.telemetry
        with self._lock:
            lat = sorted(self._latencies)
            cls_snap = self._cls_stats.snapshot()
            prec_snap = self._drift.snapshot()
        n = int(tm.batches.get())
        out = {
            "requests": int(tm.completed.get()),
            "rows": int(tm.rows.get()),
            "batches": n,
            "errors": int(tm.errors.get()),
            "queue_depth": self._batcher.queue_depth,
            "mean_fill_ratio": (round(tm.fill_sum.get() / n, 4) if n
                                else 0.0),
            "uptime_s": round(time.monotonic() - self._t_start, 3),
            "classes": cls_snap,
            "precision": prec_snap,
        }
        out["budget"] = {
            "enabled": self._budget.enabled,
            **self._mem.snapshot(defaults=("params", "queue")),
            "shed": int(tm.budget_shed.get()),
        }
        if self._n_chunks:
            # chunk size, chunk dispatches, cumulative upload wall: only
            # while the chunked path is active
            out["trees"] = self.backend.tree_counts()
        if self._exec is not None:
            # the AOT store's counters: only while a store is bound
            out["aot"] = {"enabled": True, **self._exec.aot_counts()}
        if self._meshed:
            out["mesh"] = self.mesh_desc
        out["p50_ms"] = round(percentile(lat, 0.50) * 1e3, 3)
        out["p99_ms"] = round(percentile(lat, 0.99) * 1e3, 3)
        if self._children:
            out["profiles"] = {
                self.precision: self._profile_row(),
                **{p: c._profile_row() for p, c in self._children.items()}}
        return out

    def _profile_row(self) -> dict:
        """This engine's row of ``stats()["profiles"]``."""
        with self._lock:
            drift = self._drift.snapshot()
        return {"requests": int(self.telemetry.requests.get()),
                "completed": int(self.telemetry.completed.get()),
                "drift": drift}

    def close(self) -> None:
        """Stop accepting requests, drain queued work, join the
        dispatcher (children first), flush the telemetry's sinks."""
        if self._closed:
            return
        self._closed = True
        for child in self._children.values():
            child.close()
        self._batcher.close()
        if self._thread is not None:
            self._thread.join()
        self.telemetry.close()

    def __enter__(self) -> "InferenceEngine":
        return self

    def __exit__(self, *exc: object) -> None:
        self.close()


def make_row_engine(backend, cfg, aot=None, mesh=None) -> InferenceEngine:
    """``cfg.serve`` → the row engine over ``backend``, its budget
    included; ``aot`` an open AOT store (serve/aotstore.py
    ``open_store``) or None; ``mesh`` a serving mesh
    (session.build_serving_mesh) or None."""
    sc = cfg.serve
    if mesh is not None:
        from euromillioner_tpu_torch.serve.session import ModelSession

        backend = ModelSession(backend, mesh=mesh)
    return InferenceEngine(backend, buckets=sc.buckets,
                           max_wait_ms=sc.max_wait_ms,
                           inflight=sc.inflight, warmup=sc.warmup,
                           classes=sc.classes, profiles=sc.profiles,
                           budget=BudgetPolicy.from_config(sc.budget),
                           aot=aot, max_executables=sc.max_executables,
                           **obs_kwargs(sc))


def obs_kwargs(sc) -> dict:
    """``serve.metrics_jsonl`` and ``serve.obs.*`` → the telemetry keyword
    arguments every engine takes."""
    return {"metrics_jsonl": sc.metrics_jsonl or None,
            "obs_enabled": sc.obs.enabled,
            "trace_capacity": sc.obs.trace_buffer,
            "slo_ms": tuple(sc.obs.slo_ms),
            "capture_path": sc.obs.capture_path or None}
