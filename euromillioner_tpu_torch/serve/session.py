"""Row-family serving backends (the JAX package's ``serve/session.py``):
:class:`NNBackend`, :class:`GBTBackend`, :class:`RFBackend`,
:class:`ClassicBackend` and :func:`load_backend`.

Every row family serves: the neural ones (``mlp``, ``wide_deep``) at the
``f32``, ``bf16`` and ``int8w`` profiles, the tree families (``gbt``,
``rf``) through whole-ensemble programs and ``classic`` (linear models,
Gaussian naive Bayes, k-means), these three at ``f32`` only, as in the
JAX package. A neural backend keeps its f32 ``predict`` as the oracle;
``bf16`` casts the params once at restore and computes in bfloat16,
``int8w`` stores the big matmul operands as per-output-channel int8
(``quant_rules`` of the model, else the size rule) and runs the model's
``quantized_apply`` where it has one (Wide&Deep's dequantized gather),
else the model's forward on the tree dequantized at each call.

:class:`MemoryLedger`, :func:`admit_queue_bytes` and :class:`BudgetPolicy`
are the byte accounting and the front-door budget every engine shares
(``serve.budget``; the row engine's ``queue`` class, the step
scheduler's every class).

A fault in a narrow profile's restore-time cast or quantization (the
``serve.quant`` fault point) falls that profile back to the f32 params,
logged once: its replies are then bit-equal to the f32 oracle. Only the
cast or quantization is covered: a kernel that fails to build raises.

Chunked ensemble dispatch (``serve.trees.chunk``; trees/chunked.py): a
GBT or classifier-forest ensemble above ``serve.trees.chunk_threshold``
trees serves through fixed-size tree chunks instead of one
whole-ensemble program. An f32 carry threads chunk to chunk in the
whole-ensemble order, so replies stay bit-equal to ``predict``; each
chunk's tables are uploaded in turn on their own stream while the
previous chunk computes, so only ~2 chunks of tables are device-resident
at once (the ``tree_tables`` class of the engine's ledger). The
``serve.chunk`` fault point covers each chunk: a fire fails only that
batch.

The AOT program store (serve/aotstore.py): every backend gives
``aot_program(profile)`` — its serving program as a function of its
parameters (an input) and the rows, and the eager tail after it (a tree
ensemble's ordered leaf sums, votes and transform, so its replies stay
bit-equal to ``predict``) — and :class:`ExecutableCache` keeps the
compiled programs an engine serves.

Mesh-sharded serving (``serve.mesh = (data, model)``;
:func:`build_serving_mesh`): a :class:`ModelSession` over a serving mesh
serves the whole mesh from this process. Each micro-batch's rows split
over the ``data`` axis, each shard uploaded to its own device on its own
stream (the ``serve.shard`` fault point sits before the upload) and run
there through the backend's program on a copy of the params placed on
that device, so replies stay bit-identical to one device; the shards'
replies join on shard 0's device. A ``model`` axis above 1 places the
params per the model's ``sharding_rules`` (Wide&Deep: each of a row's
devices holds its shard of the wide table, embeddings and kernels) and
runs the model's ``tp_apply``: K4a on each shard's columns, the
(B, out_dim) partials added in model-index order on the row's first
device; a family without rules replicates, with the JAX warning. Bucket
tables round up to multiples of the data axis (logged once). Chunked
tree dispatch shards rows over ``data`` only (a ConfigError for a model
axis), and a meshed session is not bound to the AOT store. Without a
mesh a session is its backend: the engines serve it byte-for-byte as
they serve the backend.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import math
import threading
import time
from dataclasses import dataclass
from typing import Callable, Mapping

import numpy as np
import torch
from torch.func import functional_call

from euromillioner_tpu_torch.config import Config
from euromillioner_tpu_torch.core.device import resolve_device, upload
from euromillioner_tpu_torch.core.mesh import (AXIS_DATA, AXIS_MODEL,
                                               cpu_device_count, mesh_desc,
                                               model_dims,
                                               round_up_multiple,
                                               serving_mesh, shard_leaf,
                                               shard_specs)
from euromillioner_tpu_torch.core.precision import (cast_floats,
                                                    dequantize_int8w,
                                                    quantize_int8w,
                                                    resolve_serve_precision,
                                                    serve_envelope)
from euromillioner_tpu_torch.core.prefetch import DoubleBuffer
from euromillioner_tpu_torch.resilience import fault_point
from euromillioner_tpu_torch.serve.batcher import validate_buckets
from euromillioner_tpu_torch.utils.errors import ConfigError, ServeError
from euromillioner_tpu_torch.utils.logging_utils import get_logger

logger = get_logger("serve.session")

# row families this port serves through load_backend
PORTED_ROW_FAMILIES = ("gbt", "rf", "mlp", "wide_deep", "classic")
_TREE_FAMILIES = ("gbt", "rf")


class MemoryLedger:
    """Bytes held by each class of serving residency: the device slot
    pool's (h, c) state (``pool``), the serving params (``params``),
    staged readback rows (``staged``), parked eviction state on the host
    (``ram``) and on disk (``disk``), queued request payloads
    (``queue``) and, when paging is on, the page store (``pages``, the
    same device bytes as ``pool``). Engines ``add``/``sub`` as bytes come
    and go; a class with a budget is bounded by it, the others are only
    tracked. Thread-safe; peaks are kept per class."""

    def __init__(self, budgets: Mapping[str, int] | None = None):
        self._lock = threading.Lock()
        self._bytes: dict[str, int] = {}
        self._peak: dict[str, int] = {}
        self._budgets = {k: int(v) for k, v in (budgets or {}).items()
                         if int(v) > 0}

    def add(self, klass: str, n: int) -> None:
        with self._lock:
            cur = self._bytes.get(klass, 0) + int(n)
            self._bytes[klass] = cur
            if cur > self._peak.get(klass, 0):
                self._peak[klass] = cur

    def try_add(self, klass: str, n: int) -> bool:
        """Add ``n`` unless the class's budget would be exceeded (then
        nothing is added): the check and the add are one lock hold, so
        concurrent admitters cannot overshoot together."""
        with self._lock:
            cur = self._bytes.get(klass, 0)
            b = self._budgets.get(klass)
            if b is not None and cur + int(n) > b:
                return False
            cur += int(n)
            self._bytes[klass] = cur
            if cur > self._peak.get(klass, 0):
                self._peak[klass] = cur
            return True

    def sub(self, klass: str, n: int) -> None:
        with self._lock:
            cur = self._bytes.get(klass, 0) - int(n)
            if cur < 0:
                # a sub without its add is a bookkeeping fault: say so
                logger.warning("MemoryLedger %r went %d bytes negative; "
                               "clamping to 0", klass, cur)
                cur = 0
            self._bytes[klass] = cur

    def set_bytes(self, klass: str, n: int) -> None:
        """Overwrite a recomputed class (the pool after a resize)."""
        with self._lock:
            self._bytes[klass] = int(n)
            if n > self._peak.get(klass, 0):
                self._peak[klass] = int(n)

    def bytes(self, klass: str | None = None) -> int:
        with self._lock:
            if klass is not None:
                return self._bytes.get(klass, 0)
            return sum(self._bytes.values())

    def peak(self, klass: str) -> int:
        with self._lock:
            return self._peak.get(klass, 0)

    def budget(self, klass: str) -> int | None:
        return self._budgets.get(klass)

    def headroom(self, klass: str) -> float:
        """``budget - bytes`` of one class; +inf without a budget."""
        b = self._budgets.get(klass)
        if b is None:
            return math.inf
        with self._lock:
            return b - self._bytes.get(klass, 0)

    def snapshot(self, defaults: tuple[str, ...] = ()) -> dict:
        """``stats()["budget"]``'s bytes, peaks and budgets; the classes
        in ``defaults`` read 0 when nothing was recorded."""
        with self._lock:
            by = dict(self._bytes)
            pk = dict(self._peak)
        for k in defaults:
            by.setdefault(k, 0)
            pk.setdefault(k, 0)
        return {"bytes": {k: int(v) for k, v in sorted(by.items())},
                "peak": {k: int(v) for k, v in sorted(pk.items())},
                "budgets": {k: int(v) for k, v
                            in sorted(self._budgets.items())}}


def admit_queue_bytes(mem: MemoryLedger, policy: "BudgetPolicy",
                      nbytes: int, cls: str, on_shed: Callable[[], None],
                      log) -> None:
    """The front door of every engine under an enabled budget: reserve
    ``nbytes`` of the ``queue`` class, or call ``on_shed`` (the engine's
    shed counter) and raise a ServeError naming the exhausted budget."""
    if not policy.enabled:
        return
    if mem.try_add("queue", nbytes):
        return
    on_shed()
    queued = mem.bytes("queue")
    log.warning(
        "serve.budget.queue_bytes exhausted: shedding one %s request "
        "(%d queued + %d new > %d budget)", cls, queued, nbytes,
        policy.queue_bytes)
    raise ServeError(
        f"serve.budget.queue_bytes exhausted: admitting {nbytes} "
        f"payload bytes would exceed the {policy.queue_bytes}-byte "
        f"queue budget ({queued} bytes queued); request shed")


@dataclass(frozen=True)
class BudgetPolicy:
    """``serve.budget`` as the engines read it (config.BudgetConfig's
    fields). Disabled, bytes are tracked and nothing is enforced."""

    enabled: bool = False
    ledger_bytes: int = 32 * 2**20
    spill_dir: str = ""
    spill_bytes: int = 256 * 2**20
    queue_bytes: int = 0

    def validate(self) -> None:
        if self.ledger_bytes < 1:
            raise ServeError("serve.budget.ledger_bytes must be >= 1, "
                             f"got {self.ledger_bytes}")
        if self.spill_dir and self.spill_bytes < 1:
            raise ServeError("serve.budget.spill_bytes must be >= 1 "
                             f"with a spill_dir, got {self.spill_bytes}")
        if self.queue_bytes < 0:
            raise ServeError("serve.budget.queue_bytes must be >= 0, "
                             f"got {self.queue_bytes}")

    @classmethod
    def from_config(cls, bc) -> "BudgetPolicy":
        """``cfg.serve.budget`` → a policy, validated when enabled."""
        pol = cls(enabled=bc.enabled, ledger_bytes=bc.ledger_bytes,
                  spill_dir=bc.spill_dir, spill_bytes=bc.spill_bytes,
                  queue_bytes=bc.queue_bytes)
        if pol.enabled:
            pol.validate()
        return pol


class ExecutableCache:
    """Lock-guarded bounded LRU of compiled serving programs over one bound
    program family of the AOT store (the JAX package's ``ExecutableCache``
    and ``bind_aot``; serve/aotstore.py). Only a bound store puts a program
    here: without one, every engine runs its programs eagerly.

    :meth:`get_or_compile` returns the program of a key: from RAM, else
    loaded from the store, else ``fn`` compiled at ``example()``'s inputs,
    saved back, and served as loaded back from those same bytes — so a
    cold run and a warm restart run the same code. A failed compile or a
    package that does not load back raises :class:`ServeError`: nothing
    is served in its place. Compiles run outside the lock.
    :meth:`preload_aot` loads the warm manifest's keys, newest first, up
    to the capacity. ``counts()`` (compiles, hits, evictions, size,
    compile_ms) and ``aot_counts()`` (the store's hits, misses, saves,
    errors, load_ms, save_ms) feed ``stats()["aot"]`` and the
    ``serve_aot`` gauges."""

    def __init__(self, maxsize: int):
        if maxsize < 1:
            raise ServeError(
                f"serve.max_executables must be >= 1, got {maxsize}")
        self.maxsize = int(maxsize)
        self._cache: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()
        self._hits = 0
        self._compiles = 0
        self._evictions = 0
        self._compile_ms = 0.0
        self._space = None
        # key → (seconds to compile, package bytes), in compile order
        self.compiled: dict = {}

    def __len__(self) -> int:
        with self._lock:
            return len(self._cache)

    def bind_aot(self, space) -> None:
        """Attach the program family's binding to the store."""
        self._space = space

    def _insert(self, key, exe, *, compiled: bool) -> None:
        with self._lock:
            if compiled:
                self._compiles += 1
            if key not in self._cache and len(self._cache) >= self.maxsize:
                self._cache.popitem(last=False)
                self._evictions += 1
            self._cache[key] = exe
            self._cache.move_to_end(key)

    def get_or_compile(self, key, fn: Callable,
                       example: Callable[[], tuple]):
        from euromillioner_tpu_torch.serve.aotstore import (compile_program,
                                                            load_program)

        with self._lock:
            exe = self._cache.get(key)
            if exe is not None:
                self._hits += 1
                self._cache.move_to_end(key)
                return exe
        space = self._space
        exe = space.load(key)
        if exe is not None:
            self._insert(key, exe, compiled=False)
            return exe
        t0 = time.perf_counter()
        try:
            payload = compile_program(fn, example(), space.compiler)
            exe = load_program(payload, space.compiler)
        except Exception as e:  # noqa: BLE001 — never serve eagerly instead
            raise ServeError(
                f"serve.aot: compiling the program at {key!r} failed "
                f"({e!r}); nothing is served in its place") from e
        ms = (time.perf_counter() - t0) * 1e3
        logger.info("serve.aot compiled %r in %.1f s (%d bytes)", key,
                    ms / 1e3, len(payload))
        self._insert(key, exe, compiled=True)
        with self._lock:
            self._compile_ms += ms
            self.compiled[key] = (ms / 1e3, len(payload))
        space.save(key, payload)
        return exe

    def preload_aot(self) -> int:
        """Load the warm manifest's programs into RAM — every key an
        earlier process compiled, not only this process's warmup set —
        newest first and no more than the capacity (the rest stay on disk
        for a lazy load). A failed load is a counted miss: that key
        compiles on first use. Returns how many were loaded."""
        if self._space is None:
            return 0
        n = skipped = 0
        for key in reversed(self._space.manifest_keys()):
            with self._lock:
                if key in self._cache:
                    continue
                if len(self._cache) >= self.maxsize:
                    skipped += 1
                    continue
            exe = self._space.load(key)
            if exe is not None:
                self._insert(key, exe, compiled=False)
                n += 1
        if n:
            logger.info("serve.aot preloaded %d program(s) from the warm "
                        "manifest%s", n,
                        f" ({skipped} over the cache's capacity stay on "
                        "disk)" if skipped else "")
        return n

    def counts(self) -> dict:
        """Compile/hit/evict/size counters and the seconds spent compiling
        (``compile_ms``), one consistent snapshot."""
        with self._lock:
            return {"compiles": self._compiles, "hits": self._hits,
                    "evictions": self._evictions, "size": len(self._cache),
                    "compile_ms": round(self._compile_ms, 3)}

    def aot_counts(self) -> dict:
        """The bound space's store counters (``stats()["aot"]``)."""
        if self._space is None:
            return {"hits": 0, "misses": 0, "saves": 0, "errors": 0,
                    "load_ms": 0.0, "save_ms": 0.0}
        return self._space.counts()


def _bind(model: torch.nn.Module, params: dict) -> torch.nn.Module:
    """A private copy of ``model`` whose parameters are the tensors of
    ``params`` (no data is copied): one profile's program runs on it and
    never touches the parameters another thread's program reads."""
    memo = {id(p): torch.nn.Parameter(params[name], requires_grad=False)
            for name, p in model.named_parameters()}
    return copy.deepcopy(model, memo)


def _skeleton(model: torch.nn.Module) -> torch.nn.Module:
    """A copy of ``model`` whose parameters and buffers live on the meta
    device: a program compiled ahead of time runs it through
    ``functional_call`` on parameters passed as inputs, so no weight is
    copied or baked into the package."""
    memo = {id(t): torch.nn.Parameter(torch.empty_like(t, device="meta"),
                                      requires_grad=False)
            for t in model.parameters()}
    memo.update({id(t): torch.empty_like(t, device="meta")
                 for t in model.buffers()})
    return copy.deepcopy(model, memo)


class NNBackend:
    """Neural checkpoint serving: params on the serving device, forward in
    the model's own arithmetic, outputs in float32.

    * ``apply(x)`` — (rows, *feat) float32 on the device → (rows, out)
      float32 on the device through the f32 params: the oracle program.
    * ``serve_apply(profile)`` — the program one profile serves
      (``apply`` itself at ``f32``), over ``serve_params(profile)``.
    * ``predict(x)`` — host rows → host float32 predictions through
      ``apply``: the direct oracle every profile is measured against.

    The input is cast to ``compute_dtype`` (bfloat16 at ``bf16``) unless
    the model reads ids from it (``cast_inputs = False``, as Wide&Deep);
    such a model casts after the lookup to its own compute dtype. The
    narrow trees and programs of ``precision`` and of every profile in
    ``profiles`` are built here, on the constructing thread; a profile
    whose cast or quantization fails (``serve.quant``) serves the f32
    params and program instead (``fallbacks`` names it), and when that
    profile is ``precision`` the backend's precision becomes ``f32``."""

    def __init__(self, model, feat_shape: tuple[int, ...],
                 compute_dtype=None, precision: str = "f32",
                 profiles=(), mesh=None):
        self.name = f"nn:{type(model).__name__}"
        self.model = model.requires_grad_(False)
        self.family = ("wide_deep" if type(model).__name__ == "WideDeep"
                       else "nn")
        self.device = next(model.parameters()).device
        self.feat_shape = tuple(feat_shape)
        self.out_dtype = np.float32
        self.compute_dtype = compute_dtype or torch.bfloat16
        self.cast_inputs = getattr(model, "cast_inputs", True)
        self.precision = resolve_serve_precision(precision)
        # no pinned (family, fused) pair: a ConfigError naming the pairs
        self.envelope = serve_envelope(self.family, self.precision)
        self._params = {k: v.detach() for k, v in model.state_dict().items()}
        self._serve_params: dict[str, dict] = {"f32": self._params}
        self._serve_apply: dict[str, Callable] = {"f32": self.apply}
        if self.family == "wide_deep" and self.device.type == "cuda":
            from euromillioner_tpu_torch.ops.wide_onehot import \
                WIDE_ONEHOT_FWD

            WIDE_ONEHOT_FWD.build()
        self.fallbacks: set[str] = set()
        for p in dict.fromkeys((self.precision, *profiles)):
            prof = resolve_serve_precision(p)
            serve_envelope(self.family, prof)  # unpinned → ConfigError
            if prof == "f32":
                continue
            try:
                self.serve_params(prof)
            except Exception as e:  # noqa: BLE001 — degrade to f32
                logger.warning(
                    "serve.precision=%s cast/quantize failed at restore "
                    "(%r); falling back to f32 params for this profile",
                    prof, e)
                self.fallbacks.add(prof)
                self._serve_params[prof] = self._params
                self._serve_apply[prof] = self.apply
                if prof == self.precision:
                    self.precision = "f32"
                    self.envelope = 0.0
                continue
            self.serve_apply(prof)
        # the serving mesh (serve.mesh): the f32 params placed on it here,
        # at restore; a ModelSession on this mesh serves this placement
        self.mesh = mesh
        self._placed: dict[str, tuple] = {}
        if mesh is not None:
            self.placed_params("f32")

    def sharding_rules(self) -> list:
        """Tensor-parallel rules delegated to the model (e.g.
        ``WideDeep.sharding_rules``); families without one replicate."""
        fn = getattr(self.model, "sharding_rules", None)
        return list(fn()) if fn is not None else []

    def placed_params(self, profile: str, mesh=None) -> tuple:
        """``(placed, dims)`` of one profile on ``mesh`` (default: this
        backend's): ``placed[i][j]`` the state dict on data shard ``i``'s
        model shard ``j``'s device, split per :meth:`sharding_rules` over
        ``model``, and ``dims`` the dim each leaf is split on. The int8w
        tree's marker dicts match no rule path: it replicates. Built once
        per profile on the backend's own mesh."""
        mesh = mesh or self.mesh
        prof = resolve_serve_precision(profile)
        own = mesh is self.mesh
        if own and prof in self._placed:
            return self._placed[prof]
        rules = self.sharding_rules() if prof != "int8w" else []
        out = _place_params(self.serve_params(prof), mesh, rules)
        if own:
            self._placed[prof] = out
        return out

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            if self.cast_inputs:
                x = x.to(self.compute_dtype)
            return self.model.apply(x).to(torch.float32)

    def serve_params(self, profile: str) -> dict:
        """The state dict one profile serves: ``f32`` the model's own
        tensors, ``bf16`` a one-time float cast, ``int8w`` the quantized
        tree (per the model's ``quant_rules`` where it has them). Built
        once per profile and kept."""
        prof = resolve_serve_precision(profile)
        tree = self._serve_params.get(prof)
        if tree is None:
            serve_envelope(self.family, prof)  # unpinned → ConfigError
            fault_point("serve.quant", profile=prof, family=self.family)
            if prof == "bf16":
                tree = cast_floats(self._params, torch.bfloat16)
            else:
                rules = getattr(self.model, "quant_rules", None)
                tree = quantize_int8w(self._params,
                                      names=list(rules()) if rules else None)
            self._serve_params[prof] = tree
        return tree

    def serve_apply(self, profile: str) -> Callable:
        """The program one profile serves, x on the device → float32 on
        the device. ``bf16`` runs the model on its bfloat16 params with a
        bfloat16 compute dtype (inputs cast unless ``cast_inputs`` is
        off); ``int8w`` runs the model's ``quantized_apply`` where it has
        one, else its forward on the tree dequantized to f32 at each call,
        on f32 inputs."""
        prof = resolve_serve_precision(profile)
        fn = self._serve_apply.get(prof)
        if fn is not None:
            return fn
        params = self.serve_params(prof)
        if prof == "bf16":
            model = _bind(self.model, params)
            if getattr(model, "compute_dtype", None) is not None:
                model.compute_dtype = torch.bfloat16
            cast = self.cast_inputs

            def fn(x):
                with torch.inference_mode():
                    if cast:
                        x = x.to(torch.bfloat16)
                    return model.apply(x).to(torch.float32)
        else:
            qapply = getattr(self.model, "quantized_apply", None)
            if qapply is not None:
                def fn(x):
                    with torch.inference_mode():
                        return qapply(params, x).to(torch.float32)
            else:
                model = _bind(self.model, self._params)

                def fn(x):
                    with torch.inference_mode():
                        dense = dequantize_int8w(params, torch.float32)
                        return functional_call(model, dense, (x,)).to(
                            torch.float32)
        self._serve_apply[prof] = fn
        return fn

    def aot_program(self, profile: str) -> tuple[Callable, dict, None]:
        """``(fn, params, tail)`` of one profile for the AOT store: ``fn(
        params, x)`` is :meth:`serve_apply`'s program with the profile's
        params as an input (a meta-device skeleton of the model under
        ``functional_call``, or ``quantized_apply``; the eager programs
        call bound copies instead, with no per-call rebinding), and no
        eager tail."""
        prof = resolve_serve_precision(profile)
        params = self.serve_params(prof)
        if prof in self.fallbacks:
            prof = "f32"
        f32 = torch.float32
        if prof == "int8w":
            qapply = getattr(self.model, "quantized_apply", None)
            if qapply is not None:
                return (lambda p, x: qapply(p, x).to(f32)), params, None
            skel = _skeleton(self.model)

            def fn(p, x):
                dense = dequantize_int8w(p, f32)
                return functional_call(skel, dense, (x,)).to(f32)

            return fn, params, None
        skel = _skeleton(self.model)
        dtype = self.compute_dtype
        if prof == "bf16":
            dtype = torch.bfloat16
            if getattr(skel, "compute_dtype", None) is not None:
                skel.compute_dtype = torch.bfloat16
        cast = self.cast_inputs

        def fn(p, x):
            if cast:
                x = x.to(dtype)
            return functional_call(skel, p, (x,)).to(f32)

        return fn, params, None

    def prepare(self, x) -> np.ndarray:
        return np.asarray(x, np.float32)

    def predict(self, x) -> np.ndarray:
        """Direct single-shot path through the f32 params:
        (rows, *feat) → (rows, out)."""
        xt = torch.as_tensor(self.prepare(x), device=self.device)
        return self.apply(xt).cpu().numpy().astype(self.out_dtype)


class _F32Backend:
    """What the row engine reads of a backend whose only profile is
    ``f32``: its program (``apply``) and the tensors it reads."""

    precision = "f32"

    def serve_params(self, profile: str = "f32"):
        return self._params

    def serve_apply(self, profile: str = "f32"):
        return self.apply


class _TreeBackend(_F32Backend):
    """What the row engine reads of a tree backend: the model's
    ``predict_program`` split — ``prepare`` bins the rows on the host,
    ``apply`` runs the ensemble program on the device — so replies are
    bit-identical to the model's direct ``predict`` by construction. f32
    only: routing and leaf sums have no narrow-dtype profile.

    With a :class:`~euromillioner_tpu_torch.trees.chunked.
    ChunkedTreeProgram` (``chunked``), ``apply`` is the chunked dispatch
    instead (:meth:`_dispatch_chunked`) and the whole ensemble's tables
    are never uploaded; ``attach_ledger`` hands it the engine's byte
    ledger and ``tree_counts`` feeds ``stats()["trees"]``."""

    def __init__(self, model, program, out_dtype, chunked=None):
        self.device = model.device
        self.feat_shape = (len(model.cuts),)
        self.out_dtype = out_dtype
        self.chunked = chunked
        self._ledger: MemoryLedger | None = None
        self._tree_lock = threading.Lock()
        self._tree_counts = {"chunks": 0, "dispatches": 0,
                             "chunk_h2d_ms": 0.0}
        if chunked is None:
            self._params, self._leaves, self._tail, self.prepare = program()
            return
        self._params = {}
        self.prepare = chunked.prepare
        cuda = self.device.type == "cuda"
        # host blocks as CPU tensors, pinned on CUDA so each upload is an
        # asynchronous copy; uploads run on their own stream
        self._blocks = [
            {k: (torch.from_numpy(a).pin_memory() if cuda
                 else torch.from_numpy(a)) for k, a in blk.items()}
            for blk in chunked.blocks]
        # one upload stream per device a dispatch runs on (a meshed
        # session's shards each run the chunk loop on their own device)
        self._copy_streams: dict[torch.device, torch.cuda.Stream] = {}

    @property
    def serve_param_bytes(self) -> int:
        """Device bytes of the tables a dispatch keeps resident: the whole
        ensemble's, or the chunked dispatch's two-block window."""
        if self.chunked is not None:
            return 2 * self.chunked.block_bytes
        return sum(t.numel() * t.element_size()
                   for t in self._params.values())

    def apply(self, binned: torch.Tensor, *, counted: bool = True,
              leaves: Callable | None = None) -> torch.Tensor:
        """The ensemble's replies to ``binned`` on the device; a chunked
        dispatch with ``counted=False`` (an engine's warmup) leaves
        :meth:`tree_counts` as it was. ``leaves(tables, binned)`` replaces
        the eager leaf-value program (the AOT store's compiled one); the
        sums after it stay eager, in tree order."""
        with torch.inference_mode():
            if self.chunked is not None:
                return self._dispatch_chunked(binned, counted, leaves)
            run = leaves or self._leaves
            return self._tail(run(self._params, binned))

    def aot_program(self, profile: str = "f32"):
        """``(fn, params, tail)`` for the AOT store: the whole-ensemble
        leaf-value program over the tables (an input), and the eager tail
        that sums, votes or transforms in the whole-ensemble order."""
        return self._leaves, self._params, self._tail

    # -- chunked tree dispatch (serve.trees.chunk) -----------------------
    def attach_ledger(self, mem: MemoryLedger) -> None:
        """Adopt the engine's byte ledger: the chunked dispatch accounts
        its streamed tables there in the ``tree_tables`` class."""
        self._ledger = mem

    def tree_counts(self) -> dict:
        """The chunked dispatch's figures — ``stats()["trees"]`` and the
        ``serve_trees{stat=...}`` gauges (one locked snapshot)."""
        ch = self.chunked
        with self._tree_lock:
            return {"chunk": ch.chunk if ch else 0,
                    "n_chunks": ch.n_chunks if ch else 0,
                    "chunks": self._tree_counts["chunks"],
                    "dispatches": self._tree_counts["dispatches"],
                    "chunk_h2d_ms": round(
                        self._tree_counts["chunk_h2d_ms"], 3)}

    def _upload(self, blk: dict, device: torch.device) -> dict:
        """One block's tables on ``device``. On CUDA the copies run on
        that device's upload stream, so the next block crosses while the
        compute stream still runs the current chunk; the compute stream
        waits for them before it reads the block."""
        if device.type != "cuda":
            return blk
        stream = self._copy_streams.get(device)
        if stream is None:
            stream = self._copy_streams[device] = torch.cuda.Stream(device)
        compute = torch.cuda.current_stream(device)
        with torch.cuda.stream(stream):
            dev = {k: v.to(device, non_blocking=True)
                   for k, v in blk.items()}
        compute.wait_stream(stream)
        for t in dev.values():
            t.record_stream(compute)  # freed only after compute reads it
        return dev

    def _dispatch_chunked(self, binned: torch.Tensor, counted: bool = True,
                          leaves: Callable | None = None) -> torch.Tensor:
        """One padded micro-batch through the chunk loop (the JAX
        package's ``ModelSession._dispatch_chunked``): the f32 carry
        stays on the device and threads chunk to chunk in the
        whole-ensemble order while each chunk's tables are uploaded in
        turn through a :class:`DoubleBuffer` window of depth 1 — pushing
        a block retires the one before it, whose compute is already
        enqueued — so the ``tree_tables`` ledger class peaks at two
        blocks' bytes. Only device work is enqueued here; the engine's
        readback is the one sync. Each chunk passes the ``serve.chunk``
        fault point: a fire fails only this batch (the carry is dropped
        and the window's accounting unwound)."""
        ch = self.chunked
        mem, bb = self._ledger, ch.block_bytes
        carry = upload(ch.init_carry(binned.shape[0]), binned.device)
        h2d_ms = 0.0
        buf = DoubleBuffer(depth=1)
        try:
            for i, blk in enumerate(self._blocks):
                fault_point("serve.chunk", chunk=i, chunks=ch.n_chunks,
                            rows=int(binned.shape[0]))
                t1 = time.perf_counter()
                dev_blk = self._upload(blk, binned.device)
                h2d_ms += (time.perf_counter() - t1) * 1e3
                # accounted and in the window BEFORE the chunk runs: if it
                # raises, the drain below still unwinds this block
                if mem is not None:
                    mem.add("tree_tables", bb)
                if buf.push(dev_blk) is not None and mem is not None:
                    mem.sub("tree_tables", bb)
                if leaves is None:
                    carry = ch.chunk_apply(dev_blk, carry, binned)
                else:
                    carry = ch.carry_apply(carry, leaves(dev_blk, binned))
            out = ch.finish_apply(carry)
        finally:
            for _ in buf.drain():
                if mem is not None:
                    mem.sub("tree_tables", bb)
        if not counted:
            return out
        with self._tree_lock:
            self._tree_counts["dispatches"] += 1
            self._tree_counts["chunks"] += ch.n_chunks
            self._tree_counts["chunk_h2d_ms"] += h2d_ms
        return out


def _chunked_log(family: str, chunked) -> None:
    logger.info("%s serving chunked: %d trees in %d chunks of %d (%.2f "
                "MB/chunk streamed, whole-ensemble tables never "
                "device-resident)", family, chunked.n_trees,
                chunked.n_chunks, chunked.chunk,
                chunked.block_bytes / 2**20)


class GBTBackend(_TreeBackend):
    """Booster serving via ``Booster.predict_program`` (whole ensemble):
    transformed predictions, or raw margins with ``output_margin``.

    **Chunked dispatch** (``serve.trees.chunk``): with ``chunk`` > 0 and
    an ensemble of more than ``chunk_threshold`` trees, serving runs
    ``Booster.chunked_predict_program`` instead — fixed-size tree chunks
    streamed to the device with an f32 margin carry threaded chunk to
    chunk in tree order, so replies stay bit-equal to ``predict``. At or
    below the threshold (or at chunk=0, the default) the whole-ensemble
    program serves."""

    name = family = "gbt"

    def __init__(self, booster, output_margin: bool = False,
                 chunk: int = 0, chunk_threshold: int = 0):
        lo, hi = booster._resolve_range(None)
        chunked = None
        if int(chunk) > 0 and (hi - lo) > int(chunk_threshold):
            chunked = booster.chunked_predict_program(
                len(booster.cuts), chunk, output_margin=output_margin)
            _chunked_log("gbt", chunked)
        super().__init__(booster, lambda: booster.serving_split(
            len(booster.cuts), output_margin=output_margin), np.float32,
            chunked)
        self.booster = booster
        self._output_margin = output_margin

    def predict(self, x) -> np.ndarray:
        from euromillioner_tpu_torch.trees import DMatrix

        return self.booster.predict(DMatrix(x),
                                    output_margin=self._output_margin)


class RFBackend(_TreeBackend):
    """Random-forest serving via ``RandomForestModel.predict_program``
    (whole forest): int32 majority votes, or f32 means for a regressor.

    **Chunked dispatch** (``serve.trees.chunk``): a classifier of more
    than ``chunk_threshold`` trees serves through
    ``RandomForestModel.chunked_predict_program`` (exact vote counts: the
    replies stay bit-equal). A regressor keeps the whole-forest program
    with a warning — its mean's reduce order is not a sequential carry's
    — unless ``approx_mean`` (``serve.trees.approx_mean``) opts in: the
    chunked sum-carry mean then serves behind the pinned ``(rf,
    chunked_mean)`` envelope, and this backend's profile is
    ``chunked_mean``, which the engine samples against the whole-forest
    ``predict``."""

    name = family = "rf"

    def __init__(self, model, chunk: int = 0, chunk_threshold: int = 0,
                 approx_mean: bool = False):
        n_trees = int(np.asarray(model.trees["feature"]).shape[0])
        chunked = None
        if int(chunk) > 0 and n_trees > int(chunk_threshold):
            chunked = model.chunked_predict_program(
                len(model.cuts), chunk, approx_mean=bool(approx_mean))
            if chunked is None:
                logger.warning(
                    "serve.trees.chunk=%d requested but this forest is a "
                    "REGRESSOR — the mean-over-trees reduce is "
                    "order-sensitive, so chunking would break the "
                    "engine-vs-predict bit pin; serving the whole-forest "
                    "program (serve.trees.approx_mean opts into a "
                    "pinned-envelope chunked mean)", int(chunk))
            else:
                if not model.classification:
                    # the backend's own approximate profile: the engine
                    # inherits it and samples drift against predict
                    self.precision = "chunked_mean"
                    logger.info(
                        "rf regression serving the OPT-IN chunked "
                        "approximate mean (serve.trees.approx_mean): a "
                        "sequential sum carry against the whole-forest "
                        "reduce, behind the pinned (rf, chunked_mean) "
                        "envelope — NOT bit-pinned to predict()")
                _chunked_log("rf", chunked)
        super().__init__(model, lambda: model.serving_split(
            len(model.cuts)),
            np.int32 if model.classification else np.float32, chunked)
        self.model = model

    def predict(self, x) -> np.ndarray:
        return self.model.predict(np.asarray(x, np.float32))


class ClassicBackend(_F32Backend):
    """classic-family serving (linear models, Gaussian naive Bayes, k-means
    assignment): int32 class or cluster ids through the model's own score
    program (``scores``, ``log_likelihood``, ``assign_program``) and an
    argmax (an argmin of distances for k-means), so replies are bit-equal
    to the model's ``predict`` of the same rows. f32 only, as in the JAX
    package."""

    family = "classic"

    def __init__(self, model):
        from euromillioner_tpu_torch.classic.kmeans import (KMeans,
                                                            assign_program)
        from euromillioner_tpu_torch.classic.linear import _LinearBase
        from euromillioner_tpu_torch.classic.naive_bayes import (
            GaussianNB, log_likelihood)

        self.name = f"classic:{type(model).__name__}"
        self.model = model
        self.device = model.device
        self.out_dtype = np.int32
        unfit = ServeError("classic model must be fit/loaded before serving")
        # each model's score program as a function of its tensors
        # (``_pure(params, x)``, the AOT store's program) and of rows
        if isinstance(model, KMeans):
            if model.centers is None:
                raise unfit
            self._params = (model.centers,)
            self.feat_shape = (int(model.centers.shape[1]),)
            self._pure = lambda p, x: assign_program(x, p["0"])
        elif isinstance(model, _LinearBase):
            if model._wb is None:
                raise unfit
            self._params = tuple(model._wb)
            self.feat_shape = (int(model._wb[0].shape[0]),)
            self._pure = lambda p, x: (x @ p["0"] + p["1"]).argmax(
                dim=-1).to(torch.int32)
        elif isinstance(model, GaussianNB):
            if model._params is None:
                raise unfit
            self._params = tuple(model._params)
            self.feat_shape = (int(model._params[0].shape[1]),)
            self._pure = lambda p, x: log_likelihood(
                x, p["0"], p["1"], p["2"]).argmax(dim=-1).to(torch.int32)
        else:
            raise ServeError(
                f"no classic serving adapter for {type(model).__name__} "
                "(serve linear models, GaussianNB or KMeans)")
        self._named = {str(i): t for i, t in enumerate(self._params)}

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return self._pure(self._named, x)

    def aot_program(self, profile: str = "f32"):
        """``(fn, params, tail)`` for the AOT store: the score program over
        the model's tensors (an input, keyed ``"0"``, ``"1"``, ...)."""
        return self._pure, self._named, None

    def prepare(self, x) -> np.ndarray:
        return np.asarray(x, np.float32)

    def predict(self, x) -> np.ndarray:
        return self.model.predict(np.asarray(x, np.float32))


# -- the serving mesh ---------------------------------------------------------

def serving_devices(device=None) -> list:
    """The devices a serving mesh may take: the visible cards on
    ``cuda`` (the default), ``EUROMILLIONER_CPU_DEVICES`` logical devices
    (default 1) on the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")] * (cpu_device_count() or 1)


def build_serving_mesh(mesh_axes, devices=None, device=None):
    """``serve.mesh`` (data, model) → a serving mesh
    (``core.mesh.ServingMesh``), or None for the 1×1 default (the
    single-device path, untouched). Bad axis tuples are a
    :class:`ConfigError` before any program runs. ``data·model`` must
    divide the device count (the mesh takes the first ``data·model``):
    ``devices`` when given (a list may name one device more than once),
    else :func:`serving_devices` of ``device``."""
    try:
        axes = tuple(int(a) for a in mesh_axes)
    except (TypeError, ValueError):
        # the "2x1" typo lands here (every log prints meshes that way):
        # keep it on the ConfigError front door
        raise ConfigError(
            f"serve.mesh must be integer (data, model) axis sizes, got "
            f"{mesh_axes!r} (e.g. serve.mesh=4,1)") from None
    if len(axes) == 1:
        axes = (axes[0], 1)
    if len(axes) != 2:
        raise ConfigError(
            f"serve.mesh must be (data, model) axis sizes, got {mesh_axes!r}")
    data, model = axes
    if data < 1 or model < 1:
        raise ConfigError(
            f"serve.mesh axis sizes must be >= 1, got {data}x{model}")
    if (data, model) == (1, 1):
        return None
    devs = list(devices) if devices is not None else serving_devices(device)
    need = data * model
    if need > len(devs) or len(devs) % need:
        raise ConfigError(
            f"serve.mesh={data}x{model} needs {need} device(s), which must "
            f"divide the {len(devs)} available — adjust serve.mesh or the "
            f"device count (e.g. EUROMILLIONER_CPU_DEVICES on the CPU)")
    return serving_mesh(data, model, devs)


def _to_device(tree, dev: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, dev) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(dev, non_blocking=True)
    return tree


def _place_params(params: dict, mesh, rules) -> tuple:
    """Place one backend's state dict on the serving mesh: ``(placed,
    dims)``, ``placed[i][j]`` on ``mesh.devices[i][j]``. Split per
    ``rules`` over ``model`` when that axis is > 1 (``shard_params``
    semantics: a leaf no candidate divides replicates, with a warning),
    whole on every device otherwise."""
    model_axis = mesh.shape[AXIS_MODEL]
    flat = {k: v for k, v in params.items()}
    specs = {}
    if model_axis > 1:
        if rules:
            specs = shard_specs(
                {k: v for k, v in flat.items()
                 if isinstance(v, torch.Tensor)}, mesh, rules)
        else:
            # a model axis with no partition rules replicates every param
            # and every step
            logger.warning(
                "mesh model axis %d but this backend has no sharding rules; "
                "params replicate (no tensor parallelism) — use "
                "serve.mesh=<data>,1 for this family", model_axis)
    dims = model_dims(specs)
    placed, cache = [], {}
    for i, row in enumerate(mesh.devices):
        line = []
        for j, dev in enumerate(row):
            key = (j if specs else 0, str(dev))
            if key not in cache:
                cache[key] = {
                    k: (_to_device(shard_leaf(v, specs[k], mesh.at(i, j)),
                                   dev) if k in specs
                        else _to_device(v, dev))
                    for k, v in flat.items()}
            line.append(cache[key])
        placed.append(line)
    return placed, dims


class ShardedRows:
    """The data shards of a serving mesh as one process drives them: each
    shard's device (its row's first) and, on CUDA, its own stream. Rows
    split into equal shards in shard order and join back on a head
    device once every shard's stream is done with them."""

    def __init__(self, mesh):
        self.devices = [row[0] for row in mesh.devices]
        self.streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
                        for d in self.devices]

    def stream(self, i: int):
        """Shard ``i``'s stream as the current one (nothing on the CPU)."""
        s = self.streams[i]
        return (torch.cuda.stream(s) if s is not None
                else contextlib.nullcontext())

    def put(self, x) -> list:
        """Each shard's rows of host rows ``x`` on its device and stream."""
        share = len(x) // len(self.devices)
        out = []
        for i, dev in enumerate(self.devices):
            with self.stream(i):
                out.append(upload(x[i * share:(i + 1) * share], dev))
        return out

    def join(self, parts: list, head: torch.device) -> torch.Tensor:
        """``parts`` in shard order, concatenated on ``head``."""
        if head.type == "cuda":
            cur = torch.cuda.current_stream(head)
            for s in self.streams:
                if s is not None:
                    cur.wait_stream(s)
            for t in parts:
                if t.device == head:
                    t.record_stream(cur)
        return torch.cat([t.to(head, non_blocking=True) for t in parts])


class ModelSession:
    """Serving state for one model over a serving mesh (the JAX package's
    ``ModelSession``), in the backend's own interface so the row engine
    serves it as it serves a backend. Without ``mesh`` it is the backend
    (the engine unwraps it).

    With ``mesh`` the params are placed on every device once (the
    backend's own placement when it was restored onto this mesh, else a
    session copy, the backend's params staying the parity oracle).
    :meth:`put_rows` passes the ``serve.shard`` fault point and uploads
    each data shard's rows to its device on its own stream;
    :meth:`serve_apply` gives the program of one profile over such shards:
    each runs the backend's program on its device (a model axis: the
    model's ``tp_apply`` over the row's model shards), and the replies
    join on shard 0's device. ``max_executables`` is the JAX package's
    argument, accepted: a meshed session's programs run eagerly, so it
    compiles and caches none."""

    def __init__(self, backend, max_executables: int = 16, mesh=None,
                 precision: str | None = None, aot=None):
        self.backend = backend
        self.mesh = mesh
        self.family = getattr(backend, "family", backend.name)
        backend_prof = getattr(backend, "precision", "f32")
        self.precision = (resolve_serve_precision(precision)
                          if precision else backend_prof)
        self.envelope = serve_envelope(self.family, self.precision)
        if (self.precision not in ("f32", backend_prof)
                and not isinstance(backend, NNBackend)):
            raise ConfigError(
                f"serve.precision={self.precision} needs a neural "
                f"backend; the {self.family} family serves f32 only")
        self.chunked = getattr(backend, "chunked", None)
        self.aot = aot
        self._programs: dict[str, Callable] = {}
        self._lock = threading.Lock()
        if mesh is None:
            return
        if self.chunked is not None and mesh.shape[AXIS_MODEL] > 1:
            raise ConfigError(
                "serve.trees.chunk shards rows over the data axis only "
                "(chunk tables replicate; a model axis > 1 has nothing to "
                "hold); use serve.mesh=N,1 or serve.trees.chunk=0 for this "
                "session")
        if aot is not None:
            logger.info("serve.aot: meshed session executables are not "
                        "persisted (RAM tier only)")
            self.aot = None
        self._shards = ShardedRows(mesh)
        if isinstance(backend, NNBackend):
            backend.placed_params(self.precision, mesh)

    # -- the backend's interface ------------------------------------------
    def __getattr__(self, name):
        # what the session does not define is the backend's
        return getattr(self.__dict__["backend"], name)

    @property
    def compiled_count(self) -> int:
        """Programs compiled for this session: a meshed session runs its
        programs eagerly."""
        return 0

    @property
    def data_axis_size(self) -> int:
        return 1 if self.mesh is None else self.mesh.shape[AXIS_DATA]

    @property
    def mesh_desc(self) -> str | None:
        """``"<data>x<model>"`` for observability, None off-mesh."""
        return None if self.mesh is None else mesh_desc(self.mesh)

    @property
    def device(self) -> torch.device:
        return (self.backend.device if self.mesh is None
                else self.mesh.primary)

    def round_buckets(self, buckets) -> tuple[int, ...]:
        """Validate a bucket table and round each bucket up to a multiple
        of the data axis (each shard takes an equal share of the rows);
        logged once when that changes the table."""
        buckets = validate_buckets(buckets)
        d = self.data_axis_size
        if d <= 1:
            return buckets
        rounded = tuple(sorted({round_up_multiple(b, d) for b in buckets}))
        if rounded != buckets:
            logger.info("serve.mesh data axis %d: bucket table %s rounded "
                        "up to %s", d, buckets, rounded)
        return rounded

    def put_rows(self, prepared: np.ndarray, fault: bool = True) -> list:
        """Each data shard's rows of a prepared batch on its device, on its
        own stream; the ``serve.shard`` fault point first (not on a
        warmup)."""
        if fault:
            fault_point("serve.shard", rows=len(prepared),
                        mesh=self.mesh_desc)
        return self._shards.put(prepared)

    def serve_params(self, profile: str):
        if self.mesh is None:
            return self.backend.serve_params(profile)
        if isinstance(self.backend, NNBackend):
            return self.backend.placed_params(profile, self.mesh)[0]
        return self.backend.serve_params(profile)

    def serve_apply(self, profile: str) -> Callable:
        """The program of one profile: over a backend's device tensor
        without a mesh, over :meth:`put_rows`' shards with one."""
        if self.mesh is None:
            return self.backend.serve_apply(profile)
        prof = resolve_serve_precision(profile)
        with self._lock:
            fn = self._programs.get(prof)
            if fn is None:
                fn = self._programs[prof] = self._meshed(prof)
        return fn

    def apply(self, xs, *, counted: bool = True, leaves=None):
        """The f32 oracle program (a chunked ensemble's chunk loop)."""
        if self.mesh is None:
            if self.chunked is not None:
                return self.backend.apply(xs, counted=counted, leaves=leaves)
            return self.backend.apply(xs)
        if self.chunked is not None:
            ys = []
            for i, x in enumerate(xs):
                with self._shards.stream(i):
                    # one batch counts once, whatever its shards
                    ys.append(self.backend.apply(
                        x, counted=counted and i == 0))
            return self._shards.join(ys, self.mesh.primary)
        return self.serve_apply("f32")(xs)

    def _meshed(self, prof: str) -> Callable:
        """The meshed program of one profile."""
        b = self.backend
        if self.chunked is not None:
            return self.apply
        if isinstance(b, NNBackend):
            placed, dims = b.placed_params(prof, self.mesh)
        else:
            placed = [[_to_device(b.aot_program(prof)[1], row[0])]
                      for row in self.mesh.devices]
            dims = {}
        fn, _params, tail = b.aot_program(prof)
        split = any(d is not None for d in dims.values())
        if split:
            skel = _skeleton(b.model)
            if prof == "bf16":
                skel.compute_dtype = torch.bfloat16
            from euromillioner_tpu_torch.dist.collectives import DeviceComm

            comms = [DeviceComm(row) for row in self.mesh.devices]

            def shard_fn(i, x):
                xs = [x if x.device == d else x.to(d, non_blocking=True)
                      for d in self.mesh.devices[i]]
                return skel.tp_apply(placed[i], xs, comms[i],
                                     dims)[0].to(torch.float32)
        else:
            def shard_fn(i, x):
                y = fn(placed[i][0], x)
                return y if tail is None else tail(y)

        def run(xs: list) -> torch.Tensor:
            ys = []
            with self._lock, torch.inference_mode():
                for i, x in enumerate(xs):
                    with self._shards.stream(i):
                        ys.append(shard_fn(i, x))
            return self._shards.join(ys, self.mesh.primary)

        return run


def _load_tree_backend(model_type: str, model_file: str | None, cfg: Config,
                       device) -> _TreeBackend:
    if not model_file:
        raise ServeError(f"serve --model-type {model_type} needs "
                         "--model-file")
    tc = cfg.serve.trees
    if model_type == "gbt":
        from euromillioner_tpu_torch.trees import Booster

        return GBTBackend(Booster.load_model(model_file, device=device),
                          chunk=tc.chunk, chunk_threshold=tc.chunk_threshold)
    from euromillioner_tpu_torch.trees import RandomForestModel

    return RFBackend(RandomForestModel.load_model(model_file, device=device),
                     chunk=tc.chunk, chunk_threshold=tc.chunk_threshold,
                     approx_mean=tc.approx_mean)


def load_backend(model_type: str, checkpoint: str | None = None,
                 cfg: Config | None = None, num_features: int = 0,
                 device=None, *, model_file: str | None = None):
    """A serving backend on ``device`` (the card when None): a model JSON
    of either package (``gbt``, ``rf``, ``classic``; ``model_file``) or a
    checkpoint directory of either package (``mlp``, ``wide_deep``) at
    ``cfg.serve.precision``, with the trees of ``cfg.serve.profiles``
    built too. The checks run in the JAX package's order, before any
    load: the profile's name, then a tree or classic family at another
    profile than f32 (ConfigError), then the model file or checkpoint."""
    from euromillioner_tpu_torch.models.registry import restore_for_inference

    cfg = cfg or Config()
    profile = resolve_serve_precision(cfg.serve.precision)
    if profile != "f32" and model_type in (*_TREE_FAMILIES, "classic"):
        raise ConfigError(
            f"serve.precision={profile} needs a neural model family; "
            f"{model_type} serves f32 only")
    if model_type == "classic":
        if not model_file:
            raise ServeError("serve --model-type classic needs "
                             "--model-file")
        from euromillioner_tpu_torch.classic import load_classic_model

        return ClassicBackend(load_classic_model(model_file, device=device))
    if model_type in _TREE_FAMILIES:
        return _load_tree_backend(model_type, model_file, cfg, device)
    if model_type == "lstm":
        raise ServeError("lstm is a sequence family: load it with "
                         "serve.continuous.load_recurrent_backend")
    if model_type not in PORTED_ROW_FAMILIES:
        raise ServeError(f"unknown model type {model_type!r}")
    if not checkpoint:
        raise ServeError(f"serve --model-type {model_type} needs "
                         "--checkpoint")
    cfg.model.name = model_type
    model, compute_dtype, in_shape, _ck = restore_for_inference(
        cfg, checkpoint, num_features, device)
    return NNBackend(model, in_shape, compute_dtype=compute_dtype,
                     precision=profile, profiles=cfg.serve.profiles)
