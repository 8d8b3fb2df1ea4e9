"""The AOT program store (the JAX package's ``serve/aotstore.py``): serving
programs compiled ahead of time, kept on disk, loaded by a restarted
process instead of compiled again.

A program here is one serving function of device tensors — a row bucket's
forward, a (rows, steps) padded sequence program, a tree chunk's leaf
values, a step-block rung, the finishers' gather — with **the parameters
(and a tree ensemble's tables) as inputs**. :func:`compile_program`
exports it (``torch.export.export``, non-strict) and compiles the export
with AOTInductor (``torch._inductor.aoti_compile_and_package``); the
package's bytes are what the store keeps and :func:`load_program` loads
(``torch._inductor.aoti_load_package``). Parameters as inputs keep the
package free of weights: the fingerprint covers the parameters'
structure only, so a store warmed by one model serves another of the same
structure with that model's own weights. The kernels a serving program
reaches stay opaque calls of the custom ops ``emtpu::lstm_sequence`` (K1)
and ``emtpu::wide_onehot_fwd`` (K4a), which the loaded package runs
through torch's dispatcher, so the kernels' launch counters see them.

Three pieces, as in the JAX package:

* :class:`AotStore` — one crc32-checked EMT1 blob per program
  (utils/serialization.py; the payload is the package's bytes), named by
  its digest, plus the warm manifest (``manifest.jsonl``) of every key a
  serving process ever compiled, which a restart preloads whole;
  ``max_bytes`` prunes LRU by file mtime (a load touches its file).
* :class:`AotSpace` — one program family's binding: the stable identity
  (program family, backend name, the parameters' structure) with the
  environment (:func:`env_signature`); each program's own key rides in
  its digest.
* :class:`~euromillioner_tpu_torch.serve.session.ExecutableCache` — the
  engines' RAM tier over one bound space: a RAM miss loads from the store
  before compiling, and a fresh compile is saved back.

**The environment** (:func:`env_signature`): the blob format, torch's
version and its CUDA runtime, the platform (and the card's name and
compute capability on CUDA), the host CPU's signature (AOTInductor's CPU
code bakes in the ISA), the compiler, and a digest of the custom ops'
schemas and of the kernel sources' build keys. An entry compiled under
any other environment is a miss, never a load.

**Failure model** (the ``serve.aot`` fault point, on every load and every
save): the store is a tier, never a source of errors. A corrupt blob
(truncated, a flipped byte: crc32 fails), a foreign or stale stamp, or a
package that fails to load is a counted miss, logged, and the file is
quarantined (renamed ``*.bad``, never read again); the program is then
compiled afresh. A fired ``serve.aot`` on load is a counted miss too, with
the (healthy) blob left in place; on save the entry is skipped and serving
goes on. A compile that fails raises :class:`ServeError`: the store never
serves the eager program in its place.

**The numeric contract.**

* A warm restart serves bit-for-bit what the cold run served, in every
  family: on a miss the program served is the package loaded back from
  the very bytes the store keeps, so cold and warm run the same code.
* Tree families are bit-equal to ``predict``: the compiled region is the
  routing to each tree's leaf value (integer compares and gathers), and
  the leaf sums, votes and transforms stay in the eager tail, in the
  whole-ensemble order.
* Neural families are held to a measured tolerance of the eager program
  (``tests/test_torch_aot.py``): AOTInductor's generated code is not
  eager's arithmetic (fusions and reductions in its own order), so a
  package is not bit-equal to eager — a property of the compiler, not a
  fault.

``compiler="export"`` keeps the exported program itself (``torch.export.
save``; run by torch's interpreter, eager's arithmetic) instead of an
AOTInductor package: the store's mechanics without a compile, for the
CPU tests.
"""

from __future__ import annotations

import functools
import hashlib
import io
import json
import os
import platform
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Any, Callable, Mapping

import numpy as np
import torch

from euromillioner_tpu_torch.resilience import fault_point
from euromillioner_tpu_torch.utils import serialization
from euromillioner_tpu_torch.utils.errors import ConfigError
from euromillioner_tpu_torch.utils.logging_utils import get_logger

logger = get_logger("serve.aotstore")

# Bump when the blob layout or the fingerprint's inputs change: old entries
# become environment misses
AOT_FORMAT = 1

COMPILERS = ("aoti", "export")
# the compiler a store uses unless it is given one
DEFAULT_COMPILER = "aoti"

_MANIFEST = "manifest.jsonl"

# the custom ops serving programs reach, and the sources of their kernels
_OPS = ("lstm_sequence", "wide_onehot_fwd")
_SOURCES = ("fused_lstm.cu", "wide_onehot.cu")

# torch dtype → numpy's ``dtype.str`` (bfloat16 is ml_dtypes' void of 2)
_DTYPE_STR = {
    torch.float32: "<f4", torch.float64: "<f8", torch.float16: "<f2",
    torch.bfloat16: "<V2", torch.int32: "<i4", torch.int64: "<i8",
    torch.int8: "|i1", torch.uint8: "|u1", torch.bool: "|b1",
}


@functools.lru_cache(maxsize=None)
def _cpu_signature() -> str:
    """The host's architecture and a digest of its CPU feature flags (the
    JAX package's ``utils/compile_cache._cpu_signature``)."""
    flags = ""
    try:
        with open("/proc/cpuinfo", encoding="utf-8") as fh:
            for line in fh:
                if line.startswith(("flags", "Features")):
                    flags = line
                    break
    except OSError:
        pass
    digest = hashlib.sha256(flags.encode()).hexdigest()[:8]
    return f"{platform.machine()}-{digest}"


@functools.lru_cache(maxsize=None)
def _ops_signature() -> str:
    """16 hex digits of the custom ops' schemas and the kernel sources'
    build keys: a package that calls an op or a kernel built otherwise is
    another environment's."""
    import euromillioner_tpu_torch.ops  # noqa: F401 — registers the ops
    from euromillioner_tpu_torch.ops.common import source_key

    desc = [str(getattr(torch.ops.emtpu, op).default._schema) for op in _OPS]
    desc += [source_key(src) for src in _SOURCES]
    return hashlib.sha256("|".join(desc).encode()).hexdigest()[:16]


def env_signature(device=None, compiler: str = "aoti") -> dict:
    """The environment half of every fingerprint, for programs that run on
    ``device`` (the card when None and one is present, else the CPU)."""
    dev = torch.device(device if device is not None else
                       "cuda" if torch.cuda.is_available() else "cpu")
    env = {"format": AOT_FORMAT, "torch": torch.__version__,
           "cuda": torch.version.cuda, "platform": dev.type,
           "cpu": _cpu_signature(), "compiler": compiler,
           "ops": _ops_signature()}
    if dev.type == "cuda":
        idx = dev.index if dev.index is not None else 0
        env["device"] = torch.cuda.get_device_name(idx)
        env["capability"] = "%d.%d" % torch.cuda.get_device_capability(idx)
    return env


def _nest(flat: Mapping[str, Any]) -> dict:
    """``{"0_LSTM.wx": t}`` → ``{"0_LSTM": {"wx": t}}``."""
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        *parents, name = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return tree


def _treedef(node) -> str:
    """The ``str`` of a JAX ``PyTreeDef`` of nested dicts: keys in sorted
    order, each leaf a ``*``."""
    if isinstance(node, dict):
        inner = ", ".join(f"{k!r}: {_treedef(node[k])}"
                          for k in sorted(node))
        return "{" + inner + "}"
    return "*"


def _leaves(node) -> list[torch.Tensor]:
    """Leaves in the order ``jax.tree_util.tree_flatten`` gives them."""
    if isinstance(node, dict):
        return [leaf for k in sorted(node) for leaf in _leaves(node[k])]
    return [node]


def params_fingerprint(params: Mapping[str, Any]) -> str:
    """16 hex digits of the parameters' structure — the names, each leaf's
    shape and dtype, never the values — equal to the JAX package's
    ``params_fingerprint`` of the same parameters as a nested dict. The
    string hashed is rebuilt here: the JAX treedef's ``str`` and
    ``shape:dtype.str`` per leaf, joined by ``|``. Live migration stamps
    every blob with it; the store keys each space on it."""
    tree = _nest(params)
    desc = [f"PyTreeDef({_treedef(tree)})"]
    for leaf in _leaves(tree):
        desc.append(f"{tuple(leaf.shape)}:{_DTYPE_STR[leaf.dtype]}")
    return hashlib.sha256("|".join(desc).encode()).hexdigest()[:16]


def _canon(obj: Any) -> str:
    """Canonical JSON for hashing (sorted keys, tuples as lists)."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"),
                      default=str)


def _as_key(obj: Any) -> Any:
    """JSON manifest entry → the in-memory cache-key shape (lists back
    to tuples, recursively)."""
    if isinstance(obj, list):
        return tuple(_as_key(v) for v in obj)
    return obj


@functools.lru_cache(maxsize=None)
def _openmp_cxx() -> str | None:
    """The C++ compiler AOTInductor builds packages with: ``$CXX`` when it
    links an OpenMP program (Inductor always passes ``-fopenmp`` on Linux),
    else the first ``g++`` or ``c++`` on PATH that does; None (no such
    compiler) leaves Inductor's own choice."""
    cands = (os.environ.get("CXX"), shutil.which("g++"), shutil.which("c++"))
    with tempfile.TemporaryDirectory(prefix="emt-cxx-") as d:
        src = os.path.join(d, "omp.cpp")
        with open(src, "w") as fh:
            fh.write("#include <omp.h>\nint main() { return "
                     "omp_get_max_threads() > 0 ? 0 : 1; }\n")
        for cxx in dict.fromkeys(c for c in cands if c):
            try:
                done = subprocess.run(
                    [cxx, "-fopenmp", src, "-o", os.path.join(d, "omp")],
                    capture_output=True, timeout=120)
            except (OSError, subprocess.SubprocessError):
                continue
            if done.returncode == 0:
                return cxx
    return None


class _Program(torch.nn.Module):
    """A serving function as the module ``torch.export`` takes. It holds no
    parameters or buffers: everything the function reads is an input, so
    nothing is baked into the package."""

    def __init__(self, fn: Callable):
        super().__init__()
        self._fn = fn

    def forward(self, *args):
        return self._fn(*args)


def compile_program(fn: Callable, args: tuple, compiler: str = "aoti"
                    ) -> bytes:
    """``fn(*args)`` exported and compiled → the bytes of its package (or
    of the saved export under ``compiler="export"``). ``args`` are example
    inputs of the shapes, dtypes and device the program serves; their
    values are not read."""
    if compiler not in COMPILERS:
        raise ConfigError(f"unknown AOT compiler {compiler!r}; "
                          f"one of {COMPILERS}")
    t0 = time.perf_counter()
    with torch.inference_mode(False), torch.no_grad():
        ep = torch.export.export(_Program(fn), tuple(args), strict=False)
        logger.info("serve.aot exported a program in %.2f s",
                    time.perf_counter() - t0)
        if compiler == "export":
            buf = io.BytesIO()
            torch.export.save(ep, buf)
            return buf.getvalue()
        from torch._inductor import aoti_compile_and_package

        cxx = _openmp_cxx()
        configs = {"cpp.cxx": (None, cxx)} if cxx else None
        with tempfile.TemporaryDirectory(prefix="emt-aot-") as d:
            path = aoti_compile_and_package(
                ep, package_path=os.path.join(d, "program.pt2"),
                inductor_configs=configs)
            with open(path, "rb") as fh:
                return fh.read()


class _Package:
    """A loaded AOTInductor package called like the function it was
    compiled from (``torch._inductor.aoti_load_package``'s model, without
    importing the compiler: a restarted server loads, it never compiles)."""

    def __init__(self, loader):
        from torch.utils import _pytree

        self._pytree = _pytree
        self._loader = loader
        in_spec, out_spec = loader.get_call_spec()
        self._out_spec = _pytree.treespec_loads(out_spec)

    def __call__(self, *args):
        flat = self._pytree.tree_flatten((args, {}))[0]
        out = self._loader.boxed_run(
            [x for x in flat if isinstance(x, torch.Tensor)])
        return self._pytree.tree_unflatten(out, self._out_spec)


def load_program(payload: bytes, compiler: str = "aoti") -> Callable:
    """A program's bytes (from :func:`compile_program`) → a callable taking
    the same inputs. The custom ops it may call are registered first."""
    import euromillioner_tpu_torch.ops  # noqa: F401

    if compiler == "export":
        return torch.export.load(io.BytesIO(payload)).module()
    with tempfile.TemporaryDirectory(prefix="emt-aot-") as d:
        path = os.path.join(d, "program.pt2")
        with open(path, "wb") as fh:
            fh.write(payload)
        try:
            loader = torch._C._aoti.AOTIModelPackageLoader(path, "model",
                                                            False, 1, -1)
        except TypeError:  # another torch's loader signature
            from torch._inductor import aoti_load_package

            return aoti_load_package(path)
        return _Package(loader)


def _blob_meta(arrays) -> dict:
    return serialization.json_value(arrays["meta"])


class AotSpace:
    """One program family's binding to the store: identity and counters.

    ``key_desc`` arguments are the stable part of a program's key — e.g.
    ``((rows, feat), dtype_str, profile)`` for a row bucket or ``(rows,
    block, profile)`` for a ladder rung — JSON-serializable tuples of ints
    and strings."""

    def __init__(self, store: "AotStore", meta: Mapping[str, Any],
                 device=None):
        self.store = store
        self.meta = dict(meta)
        self.meta["env"] = env_signature(device, store.compiler)
        self.space_id = hashlib.sha256(
            _canon(self.meta).encode()).hexdigest()[:12]
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.saves = 0
        self.errors = 0
        self.load_ms = 0.0
        self.save_ms = 0.0

    @property
    def compiler(self) -> str:
        return self.store.compiler

    def digest(self, key_desc: Any) -> str:
        return self.space_id + "-" + hashlib.sha256(
            (_canon(self.meta) + _canon(key_desc)).encode()).hexdigest()[:20]

    def load(self, key_desc: Any) -> Any | None:
        """One loaded program, or None (a miss: absent, corrupt, foreign
        or faulted — the caller compiles)."""
        t0 = time.perf_counter()
        exe, err = self.store.load(self.digest(key_desc),
                                   env=self.meta["env"])
        ms = (time.perf_counter() - t0) * 1e3
        with self._lock:
            if exe is not None:
                self.hits += 1
                self.load_ms += ms
            else:
                self.misses += 1
                if err:
                    self.errors += 1
        return exe

    def save(self, key_desc: Any, payload: bytes) -> bool:
        t0 = time.perf_counter()
        ok = self.store.save(self.digest(key_desc), payload,
                             space_id=self.space_id, key_desc=key_desc,
                             meta=self.meta)
        ms = (time.perf_counter() - t0) * 1e3
        with self._lock:
            self.save_ms += ms
            if ok:
                self.saves += 1
            else:
                self.errors += 1
        return ok

    def manifest_keys(self) -> list[Any]:
        """Every key this space's programs were ever compiled at (the warm
        manifest) — what a restart preloads, the whole ladder included."""
        return [_as_key(k) for k
                in self.store.manifest_keys(self.space_id)]

    def counts(self) -> dict[str, float]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "saves": self.saves, "errors": self.errors,
                    "load_ms": round(self.load_ms, 3),
                    "save_ms": round(self.save_ms, 3)}


class AotStore:
    """crc32-checked on-disk store of compiled serving programs.

    Blob layout (one EMT1 container per entry; every raw byte range is
    crc32-checked by utils/serialization.loads):

    ======== ==========================================================
    payload  the package's bytes (:func:`compile_program`)
    meta     JSON: the environment, the space's meta, key_desc, digest
    ======== ==========================================================

    Writes are atomic (a temporary file, then ``os.replace``) and best
    effort: a failed save never fails the compile it rode on. Reads check
    crc32, the stamped digest and the stamped environment; any mismatch,
    or a package that does not load, quarantines the file (``*.bad``) and
    reports a miss."""

    def __init__(self, dir: str, max_bytes: int = 0,  # noqa: A002
                 compiler: str | None = None):
        compiler = compiler or DEFAULT_COMPILER
        if compiler not in COMPILERS:
            raise ConfigError(f"unknown AOT compiler {compiler!r}; "
                              f"one of {COMPILERS}")
        self.dir = str(dir)
        self.max_bytes = int(max_bytes)
        self.compiler = compiler
        os.makedirs(self.dir, exist_ok=True)
        self._lock = threading.Lock()
        self._manifest_seen: set[str] = set()
        self.loads = 0
        self.saves = 0
        self.errors = 0
        self.pruned = 0

    # -- paths ------------------------------------------------------------
    def _path(self, digest: str) -> str:
        return os.path.join(self.dir, f"{digest}.aot")

    @property
    def manifest_path(self) -> str:
        return os.path.join(self.dir, _MANIFEST)

    def space(self, *, program: str, family: str, backend_name: str,
              params: Mapping[str, Any], mesh: str | None = None,
              device=None) -> AotSpace:
        """A program family's binding — identity from (program family,
        family, backend name, the parameters' structure, mesh) and the
        environment of ``device``; each program's own key rides in its
        entry's digest."""
        return AotSpace(self, {
            "program": program, "family": family, "backend": backend_name,
            "params": params_fingerprint(params), "mesh": mesh}, device)

    # -- load/save --------------------------------------------------------
    def load(self, digest: str, env: Mapping[str, Any] | None = None
             ) -> tuple[Any | None, str | None]:
        """``(program, error)``: ``(None, None)`` is a clean miss, ``(None,
        err)`` a counted failure — the file is quarantined for everything
        but an injected fault, which may fire over a healthy blob."""
        path = self._path(digest)
        if not os.path.exists(path):
            return None, None
        try:
            fault_point("serve.aot", op="load", digest=digest)
        except Exception as e:  # noqa: BLE001 — injected: a failed load
            with self._lock:
                self.errors += 1
            logger.warning("serve.aot load faulted for %s (%r); "
                           "falling back to compile", digest, e)
            return None, f"fault: {e!r}"
        want = dict(env) if env is not None else env_signature(
            compiler=self.compiler)
        try:
            arrays = serialization.load(path)
            meta = _blob_meta(arrays)
            if meta.get("digest") != digest:
                raise ConfigError(
                    f"entry is stamped {meta.get('digest')!r}, "
                    f"filename says {digest!r}")
            if meta.get("env") != want:
                raise ConfigError(
                    f"entry compiled under {meta.get('env')}, this "
                    f"process is {want} — stale or foreign programs must "
                    "never load")
            exe = load_program(arrays["payload"].numpy().tobytes(),
                               self.compiler)
        except Exception as e:  # noqa: BLE001 — a miss, never a crash
            with self._lock:
                self.errors += 1
            self._quarantine(path, e)
            return None, repr(e)
        with self._lock:
            self.loads += 1
        try:  # LRU freshness for max_bytes pruning
            os.utime(path)
        except OSError:
            pass
        return exe, None

    def save(self, digest: str, payload: bytes, *, space_id: str,
             key_desc: Any, meta: Mapping[str, Any]) -> bool:
        """Write one entry atomically and append the warm manifest. Best
        effort: a failure is logged and counted, and serving goes on."""
        path = self._path(digest)
        try:
            fault_point("serve.aot", op="save", digest=digest)
            blob = serialization.dumps({
                "payload": np.frombuffer(payload, np.uint8),
                "meta": serialization.json_entry({
                    "digest": digest, "env": dict(meta)["env"],
                    "space": dict(meta), "key": key_desc})})
            tmp = path + f".tmp.{os.getpid()}"
            with open(tmp, "wb") as fh:
                fh.write(blob)
            os.replace(tmp, path)
            self._manifest_add(space_id, key_desc, digest)
        except Exception as e:  # noqa: BLE001 — the store is best effort
            with self._lock:
                self.errors += 1
            logger.warning("serve.aot save failed for %s (%r); entry "
                           "skipped, serving continues", digest, e)
            return False
        with self._lock:
            self.saves += 1
        if self.max_bytes > 0:
            self.prune(self.max_bytes)
        return True

    def _quarantine(self, path: str, err: BaseException) -> None:
        """Rename a bad entry out of the loadable namespace: it is never
        read again (and never silently deleted — the ``*.bad`` file is
        the evidence). One log line per file."""
        bad = path + ".bad"
        try:
            os.replace(path, bad)
            logger.warning("serve.aot entry %s failed verification "
                           "(%r); quarantined to %s and falling back "
                           "to a fresh compile",
                           os.path.basename(path), err, bad)
        except OSError as e:
            logger.warning("serve.aot entry %s failed verification "
                           "(%r) and could not be quarantined (%r)",
                           os.path.basename(path), err, e)

    # -- warm manifest ----------------------------------------------------
    def _manifest_add(self, space_id: str, key_desc: Any,
                      digest: str) -> None:
        with self._lock:
            if digest in self._manifest_seen:
                return
            self._manifest_seen.add(digest)
            line = json.dumps({"space": space_id, "key": key_desc,
                               "digest": digest}) + "\n"
            try:
                with open(self.manifest_path, "a", encoding="utf-8") as fh:
                    fh.write(line)
            except OSError as e:
                logger.warning("serve.aot manifest append failed (%r); "
                               "warm preload will miss this key", e)

    def _manifest_lines(self) -> list[dict]:
        try:
            with open(self.manifest_path, encoding="utf-8") as fh:
                raw = fh.read()
        except OSError:
            return []
        out = []
        for ln in raw.splitlines():
            ln = ln.strip()
            if not ln:
                continue
            try:
                rec = json.loads(ln)
            except json.JSONDecodeError:
                continue  # a torn tail line is not a store failure
            if isinstance(rec, dict) and "digest" in rec:
                out.append(rec)
        return out

    def manifest_keys(self, space_id: str) -> list[Any]:
        """Deduplicated key_descs recorded for one space whose blob still
        exists (pruned or quarantined entries drop out)."""
        seen: dict[str, Any] = {}
        for rec in self._manifest_lines():
            if rec.get("space") == space_id \
                    and os.path.exists(self._path(rec["digest"])):
                seen[rec["digest"]] = rec.get("key")
        return list(seen.values())

    # -- the `aot` CLI's surface ------------------------------------------
    def entries(self) -> list[dict]:
        """One record per ``*.aot`` file: digest, bytes, mtime."""
        out = []
        try:
            names = sorted(os.listdir(self.dir))
        except OSError:
            return []
        for name in names:
            if not name.endswith(".aot"):
                continue
            try:
                st = os.stat(os.path.join(self.dir, name))
            except OSError:
                continue
            out.append({"digest": name[:-4], "bytes": int(st.st_size),
                        "mtime": st.st_mtime})
        return out

    def total_bytes(self) -> int:
        return sum(e["bytes"] for e in self.entries())

    @staticmethod
    def _stamped_digest(meta: Mapping[str, Any]) -> str:
        """An entry's digest recomputed from its own stamped (space, key):
        the self-consistency check of :meth:`verify`, which does not
        condemn another environment's entries in a shared store."""
        space = _canon(dict(meta.get("space", {})))
        space_id = hashlib.sha256(space.encode()).hexdigest()[:12]
        return space_id + "-" + hashlib.sha256(
            (space + _canon(meta.get("key"))).encode()).hexdigest()[:20]

    def verify(self) -> dict:
        """Read, crc-check and self-check every entry without loading its
        package. Corrupt or inconsistent entries are quarantined as a
        serving load would; entries stamped for another environment are
        counted ``foreign`` and left alone (another host's warm ladder in
        a shared store, never looked up here)."""
        ok, foreign, bad = 0, 0, []
        # this process's environment on each platform it can run
        here = [env_signature("cpu", self.compiler)]
        if torch.cuda.is_available():
            here.append(env_signature("cuda", self.compiler))
        for e in self.entries():
            path = self._path(e["digest"])
            try:
                meta = _blob_meta(serialization.load(path))
                if meta.get("digest") != e["digest"] \
                        or self._stamped_digest(meta) != e["digest"]:
                    raise ConfigError("digest stamp mismatch")
                if meta.get("env") in here:
                    ok += 1
                else:
                    foreign += 1
            except Exception as err:  # noqa: BLE001 — report, quarantine
                self._quarantine(path, err)
                bad.append({"digest": e["digest"], "error": repr(err)})
        return {"ok": ok, "foreign": foreign, "bad": bad}

    def prune(self, max_bytes: int) -> int:
        """LRU-prune (oldest mtime first) until the store fits
        ``max_bytes``; rewrites the manifest to the surviving set."""
        entries = sorted(self.entries(), key=lambda e: e["mtime"])
        total = sum(e["bytes"] for e in entries)
        removed = 0
        while entries and total > max_bytes:
            victim = entries.pop(0)
            try:
                os.remove(self._path(victim["digest"]))
            except OSError:
                continue
            total -= victim["bytes"]
            removed += 1
        if removed:
            live = {e["digest"] for e in entries}
            with self._lock:
                self.pruned += removed
                # a pruned digest must be appendable again: a later save of
                # the same key needs its manifest line back
                self._manifest_seen &= live
            keep = [rec for rec in self._manifest_lines()
                    if rec["digest"] in live]
            try:
                tmp = self.manifest_path + ".tmp"
                with open(tmp, "w", encoding="utf-8") as fh:
                    fh.writelines(json.dumps(r) + "\n" for r in keep)
                os.replace(tmp, self.manifest_path)
            except OSError as e:
                logger.warning("serve.aot manifest rewrite failed (%r)", e)
            logger.info("serve.aot pruned %d entr%s (LRU) to fit %d bytes",
                        removed, "y" if removed == 1 else "ies", max_bytes)
        return removed

    def counts(self) -> dict[str, int]:
        with self._lock:
            return {"loads": self.loads, "saves": self.saves,
                    "errors": self.errors, "pruned": self.pruned}


def open_store(ac) -> AotStore | None:
    """``cfg.serve.aot`` → an :class:`AotStore`, or None when disabled (the
    default: serving stays eager, as without the store). The one mapping
    ``serve`` and the ``aot`` CLI share."""
    if not getattr(ac, "enabled", False):
        return None
    if ac.max_bytes < 0:
        raise ConfigError(
            f"serve.aot.max_bytes must be >= 0, got {ac.max_bytes}")
    path = ac.dir or os.path.join(os.getcwd(), ".aot_store")
    return AotStore(path, max_bytes=ac.max_bytes)
