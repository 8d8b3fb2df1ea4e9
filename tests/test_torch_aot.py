"""The AOT program store (euromillioner_tpu_torch/serve/aotstore.py, the
engines' ``ExecutableCache`` and the ``aot`` CLI) on the CPU: the port of
the JAX package's ``tests/test_aot.py`` and of ``TestChunkAot`` and
``TestPaddedProgramsAot`` from its ``tests/test_serve_trees.py``.

- the fingerprint keys the parameters' structure, the program and the
  environment (torch, the platform, the CPU, the compiler, the custom
  ops and the kernel sources);
- warm restarts of the four program families (``row``, ``padded``,
  ``tree_chunk``, ``ladder`` with its finishers' gather) make zero
  compiles and reply bit-identical to the cold run; the manifest preloads
  rungs past the configured ladder;
- a truncated, flipped or foreign blob is a counted miss, quarantined,
  and a fresh compile; the ``serve.aot`` fault point on load and save;
- ``stats()["aot"]``, ``/healthz`` ``aot_hits``, ``/metrics`` and
  ``obs-top`` only while a store is bound; ``aot prewarm|ls|verify|prune``;
- K1 and K4a as custom ops against their plain versions, and inside
  exported programs;
- three cases with no JAX counterpart: a store warmed by model A serves
  model B of the same structure with B's weights, a failed compile
  raises, and (slow) the JAX package's replies against the warm store's.

Most tests run the store on ``compiler="export"`` — the exported program
itself, saved and loaded by ``torch.export`` (eager's arithmetic, no
compile): the store's mechanics within seconds. The tests that compile
AOTInductor packages (~15-20 s a package on an x86-64 CPU at 2 threads)
are marked ``slow``:
``python -m pytest -m slow tests/test_torch_aot.py``. They pin the numeric
contract: warm == cold bit for bit, tree replies bit-equal to ``predict``
and neural replies within the measured tolerance of the eager programs.

The JAX ``TestCompileCacheWiring`` has no counterpart: the port compiles
no XLA program, so it has no XLA compile cache to wire.
"""

from __future__ import annotations

import json
import logging
import os

import numpy as np
import pytest
import torch

from euromillioner_tpu_torch.models.lstm import build_lstm
from euromillioner_tpu_torch.models.mlp import build_mlp
from euromillioner_tpu_torch.resilience import FaultPlan, FaultSpec, inject
from euromillioner_tpu_torch.serve import aotstore
from euromillioner_tpu_torch.serve.aotstore import (AotStore, env_signature,
                                                    open_store,
                                                    params_fingerprint)
from euromillioner_tpu_torch.serve.continuous import (RecurrentBackend,
                                                      StepScheduler,
                                                      WholeSequenceScheduler)
from euromillioner_tpu_torch.serve.engine import InferenceEngine
from euromillioner_tpu_torch.serve.session import GBTBackend, NNBackend
from euromillioner_tpu_torch.serve.transport import healthz_body
from euromillioner_tpu_torch.utils import serialization
from euromillioner_tpu_torch.utils.errors import ServeError

torch.set_num_threads(2)

EXPORT = "export"
# AOTInductor's code against the eager program on the same inputs, f32:
# measured on an x86-64 CPU (torch 2.13) at most 1.49e-08 absolute
# (1.06e-07 of the scale) over the MLP, Wide&Deep and the LSTM's padded,
# fused and ladder programs; held to the JAX package's NN pin
# (tests/test_train.py:241-243). The narrow tiers measured 1.45e-03 (Wide&Deep bf16) and
# 7.38e-03 (LSTM bf16) of the scale, held to their SERVE_ENVELOPES entry.
F32_RTOL = 1e-5
F32_ATOL = 1e-6
COMPILERS = ["export", pytest.param("aoti", marks=pytest.mark.slow)]


@pytest.fixture(scope="module")
def row_backend():
    model = build_mlp(hidden_sizes=(8,), out_dim=1, in_features=5,
                      device="cpu")
    return NNBackend(model, (5,), compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def seq_model():
    return build_lstm(hidden=8, num_layers=1, out_dim=3, in_features=4,
                      device="cpu")


def _rows(n, seed=0, feat=5):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, feat)).astype(np.float32)


def _seqs(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(int(rng.integers(2, 7)), 4)).astype(np.float32)
            for _ in range(n)]


def _store(path, compiler=EXPORT, **kw):
    return AotStore(str(path), compiler=compiler, **kw)


def _store_files(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".aot"))


def _serve_rows(backend, store, x, buckets=(8,), **kw):
    with InferenceEngine(backend, buckets=buckets, max_wait_ms=1.0,
                         aot=store, **kw) as eng:
        out = eng.predict(x)
        return out, eng.exec_cache_counts(), eng.stats().get("aot")


# ---------------------------------------------------------------------------
# the fingerprint
# ---------------------------------------------------------------------------

class TestFingerprint:
    def test_params_fingerprint_keys_structure_not_values(self):
        a = {"w": torch.zeros((4, 3))}
        b = {"w": torch.ones((4, 3))}
        c = {"w": torch.zeros((4, 4))}
        d = {"w": torch.zeros((4, 3), dtype=torch.float64)}
        assert params_fingerprint(a) == params_fingerprint(b)
        assert params_fingerprint(a) != params_fingerprint(c)
        assert params_fingerprint(a) != params_fingerprint(d)

    def test_space_digest_keys_program_and_key(self, tmp_path,
                                               row_backend):
        store = _store(tmp_path)
        params = row_backend.aot_program("f32")[1]
        s1 = store.space(program="row", family="nn", backend_name="nn:x",
                         params=params, device="cpu")
        s2 = store.space(program="ladder", family="nn",
                         backend_name="nn:x", params=params, device="cpu")
        key = ((8, 5), "<f4", "f32")
        assert s1.digest(key) != s2.digest(key)
        assert s1.digest(key) != s1.digest(((8, 5), "<f4", "bf16"))
        assert s1.digest(key) == s1.digest(key)
        # the compiler is part of the environment: an export entry is
        # never an AOTInductor package's
        s3 = AotStore(str(tmp_path), compiler="aoti").space(
            program="row", family="nn", backend_name="nn:x", params=params,
            device="cpu")
        assert s3.digest(key) != s1.digest(key)

    def test_env_signature_names_torch_platform_cpu_and_kernels(
            self, monkeypatch):
        env = env_signature("cpu")
        assert set(env) == {"format", "torch", "cuda", "platform", "cpu",
                            "compiler", "ops"}
        assert env["torch"] == torch.__version__
        assert env["platform"] == "cpu" and env["compiler"] == "aoti"
        # another build of a kernel's source is another environment
        from euromillioner_tpu_torch.ops import common

        monkeypatch.setattr(common, "source_key", lambda src: "0" * 16)
        aotstore._ops_signature.cache_clear()
        try:
            assert env_signature("cpu")["ops"] != env["ops"]
        finally:
            monkeypatch.undo()
            aotstore._ops_signature.cache_clear()
        assert env_signature("cpu") == env


# ---------------------------------------------------------------------------
# the custom ops: K1 and K4a as torch.library ops
# ---------------------------------------------------------------------------

class TestCustomOps:
    def test_lstm_sequence_op_is_the_plain_version_on_the_cpu(self):
        from euromillioner_tpu_torch.ops import fused_lstm as K

        g = torch.Generator().manual_seed(0)
        x_proj = torch.randn((5, 3, 32), generator=g)
        wh = torch.randn((8, 32), generator=g) * 0.3
        peep = torch.randn((4, 8), generator=g) * 0.1
        want = K.lstm_sequence_reference(x_proj, wh, peep, True)[0]
        got = torch.ops.emtpu.lstm_sequence(x_proj, wh, peep, True)
        assert torch.equal(got, want) and got.is_contiguous()
        with torch.inference_mode():  # the serving programs' mode
            assert torch.equal(K.lstm_sequence_op(x_proj, wh, peep, True),
                               want)
        torch.library.opcheck(K.lstm_sequence_op, (x_proj, wh, peep, True))

    def test_wide_onehot_op_is_the_plain_version_on_the_cpu(self):
        from euromillioner_tpu_torch.ops import wide_onehot as K

        g = torch.Generator().manual_seed(1)
        w = torch.randn((3, 10, 6), generator=g)
        ids = torch.randint(0, 10, (7, 3), generator=g, dtype=torch.int32)
        want = K.wide_onehot_fwd_reference(w, ids)
        got = torch.ops.emtpu.wide_onehot_fwd(w, ids)
        assert torch.equal(got, want) and got.dtype == torch.float32
        torch.library.opcheck(K.wide_onehot_fwd_op, (w, ids))
        # inference goes through the op, training through the Function
        assert torch.equal(K.wide_onehot_matmul(w, ids), want)
        wg = w.clone().requires_grad_(True)
        out = K.wide_onehot_matmul(wg, ids)
        assert out.grad_fn is not None and torch.equal(out.detach(), want)

    def test_the_ops_stay_opaque_calls_in_an_exported_program(self):
        """The fused padded program and Wide&Deep's forward keep K1 and
        K4a as calls of the custom ops in the export the store compiles."""
        from euromillioner_tpu_torch.models.wide_deep import WideDeep

        model = build_lstm(hidden=8, num_layers=1, out_dim=3,
                           in_features=4, device="cpu")
        b = RecurrentBackend(model, feat_dim=4, compute_dtype=torch.float32,
                             precision="fused")
        args = (b.serving_params(), torch.zeros((2, 5, 4)),
                torch.zeros((2,), dtype=torch.long))
        ep = torch.export.export(aotstore._Program(b.padded_pure), args,
                                 strict=False)
        assert "emtpu.lstm_sequence" in str(ep.graph)
        wd = NNBackend(WideDeep(compute_dtype=torch.float32, device="cpu",
                                wide_embed_dim=4, embed_dim=4,
                                ball_vocab=8, hidden_sizes=(8,)), (11,),
                       compute_dtype=torch.float32)
        fn, params, _ = wd.aot_program("f32")
        ep = torch.export.export(aotstore._Program(fn),
                                 (params, torch.ones((2, 11))),
                                 strict=False)
        assert "emtpu.wide_onehot_fwd" in str(ep.graph)
        assert not ep.state_dict  # no weight is baked into the program


# ---------------------------------------------------------------------------
# warm restarts, each family
# ---------------------------------------------------------------------------

class TestWarmRestart:
    @pytest.mark.parametrize("compiler", COMPILERS)
    @pytest.mark.parametrize("profile", ["f32", "bf16"])
    def test_row_bucket_warm_restart_bit_identical(self, tmp_path,
                                                   compiler, profile):
        """``row``: a restarted engine loads its bucket from disk with zero
        compiles and replies bit-identical to the cold engine; both are
        within the measured tolerance of the eager engine (bit-equal under
        the export compiler, which keeps eager's arithmetic)."""
        model = build_mlp(hidden_sizes=(16,), out_dim=2, in_features=5,
                          device="cpu")
        backend = NNBackend(model, (5,), compute_dtype=torch.float32,
                            precision=profile)
        x = _rows(6)
        cold, cold_c, cold_a = _serve_rows(
            backend, _store(tmp_path, compiler), x, precision=profile)
        assert cold_c["compiles"] == 1 and cold_a["saves"] == 1
        warm, warm_c, warm_a = _serve_rows(
            backend, _store(tmp_path, compiler), x, precision=profile)
        assert warm_c["compiles"] == 0 and warm_a["hits"] == 1
        np.testing.assert_array_equal(cold, warm)
        plain, _, none = _serve_rows(backend, None, x, precision=profile)
        assert none is None
        if compiler == EXPORT:
            np.testing.assert_array_equal(plain, warm)
        elif profile == "f32":
            np.testing.assert_allclose(warm, plain, rtol=F32_RTOL,
                                       atol=F32_ATOL)
        else:
            rel = np.abs(warm - plain).max() / np.abs(plain).max()
            assert rel <= backend.envelope, rel

    def test_profile_children_share_the_store(self, tmp_path):
        """``serve.profiles``: the children compile their own profiles'
        programs into the parent's store; a restart loads every profile's
        with zero compiles and replies bit-identically per profile."""
        model = build_mlp(hidden_sizes=(16,), out_dim=2, in_features=5,
                          device="cpu")
        backend = NNBackend(model, (5,), compute_dtype=torch.float32,
                            profiles=("bf16", "int8w"))
        x = _rows(6, seed=8)

        def serve():
            with InferenceEngine(backend, buckets=(8,), max_wait_ms=1.0,
                                 profiles=("bf16", "int8w"),
                                 aot=_store(tmp_path)) as eng:
                outs = {p: eng.predict(x, profile=p)
                        for p in ("f32", "bf16", "int8w")}
                return outs, eng.exec_cache_counts(), eng.stats()["aot"]

        cold, cold_c, _a = serve()
        assert cold_c["compiles"] == 3
        warm, warm_c, warm_a = serve()
        assert warm_c["compiles"] == 0 and warm_a["hits"] == 3
        for p in cold:
            np.testing.assert_array_equal(cold[p], warm[p])

    @pytest.mark.parametrize("compiler", COMPILERS)
    @pytest.mark.parametrize("profile", ["f32", "bf16"])
    def test_lstm_ladder_warm_restart_bit_identical(self, tmp_path,
                                                    seq_model, compiler,
                                                    profile):
        """``ladder``: a restarted step scheduler preloads its rung and the
        rung's gather from the manifest, compiles nothing and serves
        bit-identical sequences."""
        backend = RecurrentBackend(seq_model, feat_dim=4,
                                   compute_dtype=torch.float32,
                                   precision=profile)
        xs = _seqs(6)

        def serve(aot):
            with StepScheduler(backend, max_slots=4, step_block=2,
                               warmup=True, aot=aot) as eng:
                outs = [eng.predict(x) for x in xs]
                counts = eng._exec.counts() if aot else None
                aotc = eng._exec.aot_counts() if aot else None
            return outs, counts, aotc

        cold, cold_counts, cold_aot = serve(_store(tmp_path, compiler))
        assert cold_counts["compiles"] == 2 and cold_aot["saves"] == 2
        warm, warm_counts, warm_aot = serve(_store(tmp_path, compiler))
        assert warm_counts["compiles"] == 0
        assert warm_aot["hits"] == 2 and warm_aot["load_ms"] > 0
        plain, _c, _a = serve(None)
        for a, b, c in zip(cold, warm, plain):
            np.testing.assert_array_equal(a, b)
            if compiler == EXPORT:
                np.testing.assert_array_equal(b, c)
            elif profile == "f32":
                np.testing.assert_allclose(b, c, rtol=F32_RTOL,
                                           atol=F32_ATOL)
            else:
                assert np.abs(b - c).max() / np.abs(c).max() \
                    <= backend.envelope

    def test_manifest_preloads_beyond_the_configured_ladder(
            self, tmp_path, seq_model):
        """The manifest holds every key ever compiled: a rung the first
        process reached past its configured ladder preloads on restart."""
        backend = RecurrentBackend(seq_model, feat_dim=4,
                                   compute_dtype=torch.float32)
        with StepScheduler(backend, max_slots=4, step_blocks=(2,),
                           warmup=True, aot=_store(tmp_path)) as eng:
            eng._compiled_block(8)  # a rung warmup never knew about
            assert eng._exec.counts()["compiles"] == 3  # 2, gather, 8
        with StepScheduler(backend, max_slots=4, step_blocks=(2,),
                           warmup=True, aot=_store(tmp_path)) as eng:
            assert len(eng._exec) == 3  # the rung past the ladder too
            eng._compiled_block(8)
            assert eng._exec.counts()["compiles"] == 0

    def test_gather_program_persists_and_stays_bit_exact(self, tmp_path,
                                                         seq_model):
        """The finishers' gather rides the store: its key is in the
        manifest and a warm restart's gathered rows stay bit-exact."""
        backend = RecurrentBackend(seq_model, feat_dim=4,
                                   compute_dtype=torch.float32)
        xs = _seqs(4, seed=3)
        with StepScheduler(backend, max_slots=4, step_blocks=(2,),
                           warmup=True, aot=_store(tmp_path)) as eng:
            cold = [eng.predict(x) for x in xs]
        keys = _store(tmp_path).space(
            program="ladder", family="lstm", backend_name=backend.name,
            params=backend.model.state_dict(), device="cpu").manifest_keys()
        assert ("gather", (4, 2, 3), "float32") in keys
        with StepScheduler(backend, max_slots=4, step_blocks=(2,),
                           warmup=True, aot=_store(tmp_path)) as eng:
            warm = [eng.predict(x) for x in xs]
            assert eng._exec.counts()["compiles"] == 0
        for a, b in zip(cold, warm):
            np.testing.assert_array_equal(a, b)

    def test_paged_pool_runs_the_ladder_programs(self, tmp_path,
                                                 seq_model):
        """The paged dispatch steps through the same stored rung."""
        from euromillioner_tpu_torch.serve.continuous import PagingPolicy

        backend = RecurrentBackend(seq_model, feat_dim=4,
                                   compute_dtype=torch.float32)
        xs = _seqs(5, seed=4)
        pol = PagingPolicy(enabled=True, page_slots=2, pages=2)
        with StepScheduler(backend, max_slots=4, step_block=2,
                           warmup=True, paging=pol) as eng:
            want = [eng.predict(x) for x in xs]
        for _ in range(2):
            with StepScheduler(backend, max_slots=4, step_block=2,
                               warmup=True, paging=pol,
                               aot=_store(tmp_path)) as eng:
                got = [eng.predict(x) for x in xs]
                compiles = eng._exec.counts()["compiles"]
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
        assert compiles == 0


class TestPaddedProgramsAot:
    """``padded``: the batch scheduler's (rows, steps) programs."""

    @pytest.fixture(scope="class")
    def lstm_backend(self):
        model = build_lstm(hidden=16, num_layers=1, out_dim=7,
                           in_features=11, device="cpu")
        return RecurrentBackend(model, feat_dim=11,
                                compute_dtype=torch.float32)

    @pytest.mark.parametrize("compiler", COMPILERS)
    def test_loaded_vs_fresh_bit_pin_and_warm_restart(self, tmp_path,
                                                      lstm_backend,
                                                      compiler):
        seq = np.random.default_rng(2).normal(
            size=(10, 11)).astype(np.float32)
        kw = dict(row_buckets=(4,), time_buckets=(16,), max_wait_ms=1.0,
                  warmup=True)
        with WholeSequenceScheduler(lstm_backend, **kw) as eng:
            base = eng.predict(seq)  # store-less: the eager program
        store = _store(tmp_path, compiler)
        with WholeSequenceScheduler(lstm_backend, aot=store, **kw) as eng:
            fresh = eng.predict(seq)
            assert eng._exec.counts()["compiles"] == 1  # one (rb, tb)
        with WholeSequenceScheduler(lstm_backend, aot=_store(
                tmp_path, compiler), **kw) as eng:
            loaded = eng.predict(seq)
            assert eng._exec.counts()["compiles"] == 0
            assert eng.load_desc["aot_hits"] == 1
        np.testing.assert_array_equal(loaded, fresh)
        if compiler == EXPORT:
            np.testing.assert_array_equal(loaded, base)
        else:
            np.testing.assert_allclose(loaded, base, rtol=F32_RTOL,
                                       atol=F32_ATOL)

    def test_make_sequence_engine_batch_passes_store(self, tmp_path,
                                                     lstm_backend):
        from euromillioner_tpu_torch.config import Config
        from euromillioner_tpu_torch.serve.continuous import \
            make_sequence_engine

        cfg = Config()
        cfg.serve.scheduler = "batch"
        cfg.serve.buckets = (4,)
        cfg.serve.seq_buckets = (8,)
        cfg.serve.warmup = True
        store = _store(tmp_path)
        eng = make_sequence_engine(lstm_backend, cfg, aot=store)
        try:
            assert eng.stats()["aot"]["enabled"]
            assert len(store.entries()) == 1
        finally:
            eng.close()


# ---------------------------------------------------------------------------
# store poisoning: a counted miss, a fresh compile, quarantine
# ---------------------------------------------------------------------------

def _poison_and_serve(tmp_path, row_backend, poison, caplog):
    """Warm a store, poison its one entry, serve again: the engine falls
    back to a fresh compile loudly, serves bit-identical, and the bad file
    is renamed ``*.bad`` (never read again); the fallback's save heals the
    entry under the same digest."""
    d = str(tmp_path)
    x = _rows(5, seed=1)
    want, _c, _a = _serve_rows(row_backend, _store(d), x)
    (name,) = _store_files(d)
    path = os.path.join(d, name)
    poison(path)
    store = _store(d)
    with caplog.at_level(logging.WARNING):
        got, counts, aot = _serve_rows(row_backend, store, x)
    np.testing.assert_array_equal(got, want)
    assert counts["compiles"] == 1
    assert aot["errors"] >= 1 and store.counts()["errors"] >= 1
    assert os.path.exists(path + ".bad")
    assert any("quarantined" in r.getMessage() for r in caplog.records)
    assert _store_files(d) == [name]
    errs = store.counts()["errors"]
    exe, err = store.load(name[:-4], env=env_signature("cpu", EXPORT))
    assert exe is not None and err is None
    assert store.counts()["errors"] == errs


class TestStorePoisoning:
    def test_truncated_blob_falls_back_and_quarantines(
            self, tmp_path, row_backend, caplog):
        def truncate(path):
            blob = open(path, "rb").read()
            with open(path, "wb") as fh:
                fh.write(blob[:len(blob) // 2])

        _poison_and_serve(tmp_path, row_backend, truncate, caplog)

    def test_flipped_byte_fails_crc_and_quarantines(
            self, tmp_path, row_backend, caplog):
        def flip(path):
            blob = bytearray(open(path, "rb").read())
            blob[len(blob) // 2] ^= 0xFF  # the payload: crc32 fails
            with open(path, "wb") as fh:
                fh.write(bytes(blob))

        _poison_and_serve(tmp_path, row_backend, flip, caplog)

    def test_foreign_environment_stamp_is_a_miss_never_a_load(
            self, tmp_path, row_backend, caplog):
        def restamp(path):
            arrays = serialization.load(path)
            meta = serialization.json_value(arrays["meta"])
            meta["env"]["torch"] = "0.0.1"          # another torch
            meta["env"]["cpu"] = "alien-00000000"   # another machine
            arrays["meta"] = serialization.json_entry(meta)
            serialization.save(path, arrays)  # a valid crc, foreign env

        _poison_and_serve(tmp_path, row_backend, restamp, caplog)

    def test_a_package_that_does_not_load_is_quarantined(
            self, tmp_path, row_backend, caplog):
        """A blob whose crc and stamps pass but whose payload is no
        package: the load fails, is counted and quarantined."""
        def garble(path):
            arrays = serialization.load(path)
            arrays["payload"] = torch.zeros(64, dtype=torch.uint8)
            serialization.save(path, arrays)

        _poison_and_serve(tmp_path, row_backend, garble, caplog)


# ---------------------------------------------------------------------------
# the serve.aot fault point
# ---------------------------------------------------------------------------

class TestAotChaos:
    def test_load_fault_falls_back_to_compile_bit_identical(
            self, tmp_path, row_backend):
        """``serve.aot`` fired on load is a counted miss: the program
        compiles afresh, replies are bit-identical, and the (healthy) blob
        is not quarantined."""
        d = str(tmp_path)
        x = _rows(4, seed=2)
        want, _c, _a = _serve_rows(row_backend, _store(d), x)
        n_files = len(_store_files(d))
        plan = FaultPlan([FaultSpec("serve.aot", raises=OSError)])
        with inject(plan):
            got, counts, aot = _serve_rows(row_backend, _store(d), x)
        assert plan.fired_count("serve.aot") >= 1
        np.testing.assert_array_equal(got, want)
        assert counts["compiles"] >= 1 and aot["errors"] >= 1
        assert len(_store_files(d)) == n_files
        assert not [f for f in os.listdir(d) if f.endswith(".bad")]
        rerun, counts, _a = _serve_rows(row_backend, _store(d), x)
        assert counts["compiles"] == 0
        np.testing.assert_array_equal(rerun, want)

    def test_save_fault_skips_entry_and_serving_continues(
            self, tmp_path, row_backend):
        d = str(tmp_path)
        x = _rows(4, seed=2)
        plan = FaultPlan([FaultSpec("serve.aot", raises=OSError)])
        with inject(plan):
            got, _c, aot = _serve_rows(row_backend, _store(d), x)
        assert plan.fired_count("serve.aot") >= 1
        assert aot["errors"] >= 1 and aot["saves"] == 0
        np.testing.assert_array_equal(got, row_backend.predict(x))
        assert not _store_files(d)


# ---------------------------------------------------------------------------
# surfaces: stats, /healthz, /metrics, obs-top
# ---------------------------------------------------------------------------

class TestSurfaces:
    def test_disabled_default_has_no_store_and_no_surface(self,
                                                          row_backend):
        """Unlike the JAX engine (which reports ``"aot": {"enabled":
        false, ...}``), the port's stats, /healthz and /metrics carry no
        AOT key at all without a store: the default stays what it was."""
        assert open_store(type("AC", (), {"enabled": False, "dir": "",
                                          "max_bytes": 0})()) is None
        with InferenceEngine(row_backend, buckets=(8,),
                             warmup=False) as eng:
            body = healthz_body(eng)
            st = eng.stats()
            text = eng.telemetry.render()
        assert "aot_hits" not in body and "aot" not in st
        assert "serve_aot" not in text

    def test_open_store_maps_the_config(self, tmp_path):
        from euromillioner_tpu_torch.config import Config, apply_overrides
        from euromillioner_tpu_torch.utils.errors import ConfigError

        cfg = apply_overrides(Config(), [
            "serve.aot.enabled=true", f"serve.aot.dir={tmp_path}",
            "serve.aot.max_bytes=123"])
        store = open_store(cfg.serve.aot)
        assert store.dir == str(tmp_path) and store.max_bytes == 123
        assert store.compiler == "aoti"
        assert Config().serve.aot.max_bytes == 1 << 30
        cfg.serve.aot.max_bytes = -1
        with pytest.raises(ConfigError, match="max_bytes"):
            open_store(cfg.serve.aot)

    def test_healthz_and_metrics_carry_aot_on_warm_host(
            self, tmp_path, row_backend):
        _serve_rows(row_backend, _store(tmp_path), _rows(2))
        with InferenceEngine(row_backend, buckets=(8,),
                             aot=_store(tmp_path)) as eng:
            body = healthz_body(eng)
            text = eng.telemetry.render()
            st = eng.stats()
        assert body["aot_hits"] >= 1
        assert 'serve_aot{family="nn",stat="hits"} 1' in text
        assert st["aot"]["enabled"] and st["aot"]["hits"] == 1

    def test_obs_top_renders_aot_nonzero_only(self):
        from euromillioner_tpu_torch.obs.top import (format_line,
                                                     parse_prometheus,
                                                     summarize_bucket,
                                                     summarize_metrics)

        rec = {"ts": 12.0, "event": "stats", "p50_ms": 1.0,
               "p99_ms": 2.0, "aot": {"hits": 3}}
        assert "aot=3" in format_line(summarize_bucket(12, [rec]))
        rec["aot"]["hits"] = 0
        assert "aot=" not in format_line(summarize_bucket(12, [rec]))
        text = ('serve_aot{family="lstm",stat="hits"} 5\n'
                'serve_aot{family="lstm",stat="load_ms"} 42.0\n')
        assert summarize_metrics(parse_prometheus(text))["aot_hits"] == 5

    def test_scheduler_stats_and_healthz_carry_aot(self, tmp_path,
                                                   seq_model):
        backend = RecurrentBackend(seq_model, feat_dim=4,
                                   compute_dtype=torch.float32)
        with StepScheduler(backend, max_slots=4, step_blocks=(2,),
                           warmup=True, aot=_store(tmp_path)):
            pass
        with StepScheduler(backend, max_slots=4, step_blocks=(2,),
                           warmup=True, aot=_store(tmp_path)) as eng:
            st = eng.stats()
            body = healthz_body(eng)
            text = eng.telemetry.render()
        assert st["aot"]["enabled"] and st["aot"]["hits"] == 2
        assert body["aot_hits"] == 2
        assert 'serve_aot{family="lstm",stat="hits"} 2' in text


# ---------------------------------------------------------------------------
# store ops and the `aot` CLI
# ---------------------------------------------------------------------------

class TestStoreOps:
    def test_verify_leaves_foreign_hosts_entries_alone(self, tmp_path,
                                                       row_backend):
        d = str(tmp_path)
        _serve_rows(row_backend, _store(d), _rows(2))
        (name,) = _store_files(d)
        arrays = serialization.load(os.path.join(d, name))
        meta = serialization.json_value(arrays["meta"])
        # a self-consistent entry from another machine
        space = dict(meta["space"])
        space["env"] = dict(space["env"], cpu="alien-00000000")
        fdigest = AotStore._stamped_digest({"space": space,
                                            "key": meta["key"]})
        arrays["meta"] = serialization.json_entry(
            {"digest": fdigest, "env": space["env"], "space": space,
             "key": meta["key"]})
        serialization.save(os.path.join(d, fdigest + ".aot"), arrays)
        assert _store(d).verify() == {"ok": 1, "foreign": 1, "bad": []}
        assert len(_store_files(d)) == 2
        # an inconsistent stamp is quarantined
        bogus = dict(meta, digest="0" * 12 + "-" + "0" * 20)
        arrays["meta"] = serialization.json_entry(bogus)
        serialization.save(os.path.join(d, bogus["digest"] + ".aot"),
                           arrays)
        rep = _store(d).verify()
        assert rep["ok"] == 1 and rep["foreign"] == 1
        assert len(rep["bad"]) == 1
        assert os.path.exists(os.path.join(d, bogus["digest"] + ".aot.bad"))

    def test_pruned_key_regains_its_manifest_line_on_resave(
            self, tmp_path, row_backend):
        d = str(tmp_path)
        store = _store(d)
        _serve_rows(row_backend, store, _rows(2))
        assert store.prune(0) == 1 and not _store_files(d)
        _serve_rows(row_backend, store, _rows(2))
        (name,) = _store_files(d)
        assert any(rec["digest"] == name[:-4]
                   for rec in store._manifest_lines())
        _out, counts, aot = _serve_rows(row_backend, _store(d), _rows(2))
        assert counts["compiles"] == 0 and aot["hits"] == 1

    def test_preload_caps_at_cache_capacity_newest_first(
            self, tmp_path, row_backend):
        d = str(tmp_path)
        _serve_rows(row_backend, _store(d), _rows(2), buckets=(8, 16, 32))
        from euromillioner_tpu_torch.serve.session import ExecutableCache

        eng = InferenceEngine(row_backend, buckets=(8,), warmup=False,
                              aot=_store(d), max_executables=2)
        try:
            cache = eng._exec
            assert isinstance(cache, ExecutableCache)
            assert cache.preload_aot() == 2
            assert len(cache) == 2 and cache.counts()["evictions"] == 0
            assert cache.aot_counts()["hits"] == 2
            newest = [k[0][0] for k in cache._cache]
            assert sorted(newest) == [16, 32]
            # the bucket past the capacity loads lazily from disk
            eng.warmup()
            assert cache.counts()["compiles"] == 0
        finally:
            eng.close()

    def test_prune_lru_drops_oldest_and_rewrites_manifest(
            self, tmp_path, row_backend):
        d = str(tmp_path)
        _serve_rows(row_backend, _store(d), _rows(2), buckets=(8, 16, 32))
        store = _store(d)
        entries = store.entries()
        assert len(entries) == 3
        keep = max(e["bytes"] for e in entries) + 1
        assert store.prune(keep) == 2 and len(store.entries()) == 1
        live = {e["digest"] for e in store.entries()}
        assert {r["digest"] for r in store._manifest_lines()} == live
        assert store.prune(keep) == 0

    def test_max_bytes_prunes_on_save(self, tmp_path, row_backend):
        _serve_rows(row_backend, _store(tmp_path, max_bytes=1), _rows(2),
                    buckets=(8, 16))
        assert len(_store_files(str(tmp_path))) <= 1

    def test_cli_prewarm_ls_verify_prune(self, tmp_path, capsys,
                                         monkeypatch):
        from euromillioner_tpu_torch.cli import main
        from euromillioner_tpu_torch.trees import DMatrix, train

        monkeypatch.setattr(aotstore, "DEFAULT_COMPILER", EXPORT)
        rng = np.random.default_rng(0)
        x = rng.normal(size=(80, 6)).astype(np.float32)
        y = (x[:, 0] > 0).astype(np.float32)
        booster = train({"objective": "binary:logistic", "max_depth": 2,
                         "device": "cpu"}, DMatrix(x, y), 2,
                        verbose_eval=False)
        model_file = str(tmp_path / "gbt.json")
        booster.save_model(model_file)
        d = str(tmp_path / "store")

        def run(*argv):
            rc = main(list(argv))
            return rc, json.loads(
                capsys.readouterr().out.strip().splitlines()[-1])

        rc, rep = run("aot", "prewarm", "--model-type", "gbt",
                      "--model-file", model_file, "--dir", d, "--device",
                      "cpu", "serve.buckets=8,16")
        assert rc == 0 and rep["saved"] == 2 and rep["entries"] == 2
        rc, rep = run("aot", "ls", "--dir", d)
        assert rc == 0 and len(rep["entries"]) == 2
        rc, rep = run("aot", "verify", "--dir", d)
        assert rc == 0 and rep["ok"] == 2 and not rep["bad"]
        name = _store_files(d)[0]
        path = os.path.join(d, name)
        blob = bytearray(open(path, "rb").read())
        blob[len(blob) // 2] ^= 0xFF
        with open(path, "wb") as fh:
            fh.write(bytes(blob))
        rc, rep = run("aot", "verify", "--dir", d)
        assert rc == 1 and rep["ok"] == 1 and len(rep["bad"]) == 1
        assert os.path.exists(path + ".bad")
        rc, rep = run("aot", "prune", "--dir", d, "--max-bytes", "0")
        assert rc == 0 and rep["removed"] == 1 and rep["bytes"] == 0
        # no card and no --device cpu: the port's exit 17
        assert main(["aot", "prewarm", "--model-type", "gbt",
                     "--model-file", model_file, "--dir", d]) == 17

    @pytest.mark.slow
    def test_prewarm_served_artifact_matches_direct_predict(self,
                                                            tmp_path):
        """A prewarmed store serves: the engine loads the prewarmed
        AOTInductor package (zero compiles) and its replies are bit-equal
        to ``Booster.predict``."""
        from euromillioner_tpu_torch.cli import main
        from euromillioner_tpu_torch.trees import Booster, DMatrix, train

        rng = np.random.default_rng(1)
        x = rng.normal(size=(80, 6)).astype(np.float32)
        y = (x[:, 0] > 0).astype(np.float32)
        booster = train({"objective": "binary:logistic", "max_depth": 2,
                         "device": "cpu"}, DMatrix(x, y), 2,
                        verbose_eval=False)
        model_file = str(tmp_path / "gbt.json")
        booster.save_model(model_file)
        d = str(tmp_path / "store")
        assert main(["aot", "prewarm", "--model-type", "gbt",
                     "--model-file", model_file, "--dir", d, "--device",
                     "cpu", "serve.buckets=8"]) == 0
        backend = GBTBackend(Booster.load_model(model_file, device="cpu"))
        got, counts, _a = _serve_rows(backend, AotStore(d), x[:5])
        assert counts["compiles"] == 0
        np.testing.assert_array_equal(got, backend.predict(x[:5]))


# ---------------------------------------------------------------------------
# tree_chunk
# ---------------------------------------------------------------------------

def _synth_booster(n_trees, seed=0):
    from euromillioner_tpu_torch.trees.gbt import Booster

    rng = np.random.default_rng(seed)
    depth, feats, bins = 3, 6, 16
    cuts = [np.sort(rng.normal(size=bins - 1)).astype(np.float32)
            for _ in range(feats)]
    n_nodes = 2 ** (depth + 1) - 1
    trees = {
        "feature": rng.integers(0, feats, (n_trees, n_nodes)).astype(
            np.int32),
        "split_bin": rng.integers(0, bins, (n_trees, n_nodes)).astype(
            np.int32),
        "is_leaf": np.zeros((n_trees, n_nodes), bool),
        "leaf_value": rng.normal(scale=0.2, size=(n_trees, n_nodes)).astype(
            np.float32)}
    trees["is_leaf"][:, 2 ** depth - 1:] = True
    return Booster({"objective": "reg:logistic", "max_depth": depth},
                   cuts, trees, 0.3, device="cpu")


class TestChunkAot:
    @pytest.mark.parametrize("compiler", COMPILERS)
    def test_warm_restart_compiles_nothing_even_grown(self, tmp_path,
                                                      compiler):
        """A store warmed by a 60-tree model serves a grown 90-tree model
        with zero compiles (a chunk-shaped identity), bit-equal to
        ``predict``: the leaf sums stay eager, in tree order."""
        from euromillioner_tpu_torch.trees import DMatrix

        rows = _rows(20, seed=5, feat=6)
        store = _store(tmp_path / "store", compiler)
        b1 = GBTBackend(_synth_booster(60, seed=4), chunk=16,
                        chunk_threshold=32)
        with InferenceEngine(b1, buckets=(8, 32), aot=store) as eng:
            assert eng.exec_cache_counts()["compiles"] == 2  # a chunk/bkt
            np.testing.assert_array_equal(eng.predict(rows),
                                          b1.predict(rows))
        grown = _synth_booster(90, seed=9)
        b2 = GBTBackend(grown, chunk=16, chunk_threshold=32)
        with InferenceEngine(b2, buckets=(8, 32), max_wait_ms=1.0,
                             aot=_store(tmp_path / "store",
                                        compiler)) as eng:
            out = eng.predict(rows)
            assert eng.exec_cache_counts()["compiles"] == 0
            assert eng.stats()["aot"]["hits"] == 2
        np.testing.assert_array_equal(out, grown.predict(DMatrix(rows)))

    def test_chunk_keys_live_in_warm_manifest(self, tmp_path):
        store = _store(tmp_path / "store")
        backend = GBTBackend(_synth_booster(60), chunk=16,
                             chunk_threshold=32)
        with InferenceEngine(backend, buckets=(8,), aot=store):
            pass
        assert len(store.entries()) == 1
        space = json.loads(open(store.manifest_path).readline())["space"]
        assert {k[0] for k in store.manifest_keys(space)} == {"chunk"}
        rep = store.verify()
        assert rep["ok"] == 1 and not rep["bad"]

    def test_different_objective_is_a_different_space(self, tmp_path):
        """A raw-margin model of the same shapes never takes the
        transforming model's entries: the chunk signature rides in the
        space's identity."""
        from euromillioner_tpu_torch.trees import DMatrix

        rows = _rows(8, seed=6, feat=6)
        b1 = GBTBackend(_synth_booster(60), chunk=16, chunk_threshold=32)
        with InferenceEngine(b1, buckets=(8,), aot=_store(tmp_path)):
            pass
        b2 = GBTBackend(_synth_booster(60), output_margin=True, chunk=16,
                        chunk_threshold=32)
        with InferenceEngine(b2, buckets=(8,), aot=_store(tmp_path)) as eng:
            assert eng.stats()["aot"]["hits"] == 0
            out = eng.predict(rows)
        np.testing.assert_array_equal(out, b2.booster.predict(
            DMatrix(rows), output_margin=True))

    def test_aot_cli_prewarm_covers_chunk_programs(self, tmp_path, capsys,
                                                   monkeypatch):
        from euromillioner_tpu_torch.cli import main

        monkeypatch.setattr(aotstore, "DEFAULT_COMPILER", EXPORT)
        model = str(tmp_path / "gbt.json")
        _synth_booster(60).save_model(model)
        d = str(tmp_path / "store")
        assert main(["aot", "prewarm", "--model-type", "gbt",
                     "--model-file", model, "--dir", d, "--device", "cpu",
                     "serve.aot.enabled=true", "serve.buckets=8",
                     "serve.trees.chunk=16",
                     "serve.trees.chunk_threshold=32"]) == 0
        rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rep["saved"] == 1 and rep["errors"] == 0
        assert main(["aot", "ls", "--dir", d]) == 0
        ls = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert len(ls["entries"]) == 1


# ---------------------------------------------------------------------------
# no JAX counterpart
# ---------------------------------------------------------------------------

class TestPortOnly:
    @pytest.mark.parametrize("compiler", COMPILERS)
    def test_store_warmed_by_model_a_serves_model_b_with_b_weights(
            self, tmp_path, compiler):
        """The parameters are inputs of the compiled program: model B of
        model A's structure loads A's entry (zero compiles) and replies
        with B's own weights."""
        a = NNBackend(build_mlp(hidden_sizes=(16,), out_dim=2,
                                in_features=5, device="cpu",
                                generator=torch.Generator().manual_seed(1)),
                      (5,), compute_dtype=torch.float32)
        b = NNBackend(build_mlp(hidden_sizes=(16,), out_dim=2,
                                in_features=5, device="cpu",
                                generator=torch.Generator().manual_seed(2)),
                      (5,), compute_dtype=torch.float32)
        x = _rows(6, seed=7)
        got_a, _c, _a = _serve_rows(a, _store(tmp_path, compiler), x)
        got_b, counts, aot = _serve_rows(b, _store(tmp_path, compiler), x)
        assert counts["compiles"] == 0 and aot["hits"] == 1
        assert not np.allclose(got_a, got_b)
        want = b.predict(x)
        if compiler == EXPORT:
            np.testing.assert_array_equal(got_b, want)
        else:
            np.testing.assert_allclose(got_b, want, rtol=F32_RTOL,
                                       atol=F32_ATOL)

    def test_failed_compile_raises_rather_than_serving_eagerly(
            self, tmp_path, row_backend, monkeypatch):
        """A program that cannot be exported (a branch on a value) is a
        ServeError naming the program: nothing is served in its place and
        nothing is saved."""
        fn, params, tail = row_backend.aot_program("f32")

        def branchy(p, x):
            if bool(x.sum() > 0):  # a host sync on a value
                return fn(p, x)
            return -fn(p, x)

        monkeypatch.setattr(row_backend, "aot_program",
                            lambda profile: (branchy, params, tail))
        with pytest.raises(ServeError, match="compiling the program"):
            InferenceEngine(row_backend, buckets=(8,), aot=_store(tmp_path))
        with InferenceEngine(row_backend, buckets=(8,), warmup=False,
                             aot=_store(tmp_path)) as eng:
            with pytest.raises(ServeError, match="nothing is served"):
                eng.predict(_rows(3))
            assert eng.stats()["errors"] == 1
        assert not _store_files(str(tmp_path))

    @pytest.mark.slow
    def test_warm_store_against_the_jax_package(self, tmp_path):
        """The JAX package serving the same numpy-seeded MLP and the
        ``fused="off"`` LSTM, against the port's replies from a warm
        AOTInductor store: within the JAX package's f32 NN pin."""
        import jax

        from euromillioner_tpu.models.lstm import build_lstm as jax_lstm
        from euromillioner_tpu.models.mlp import build_mlp as jax_mlp
        from euromillioner_tpu.serve import InferenceEngine as JaxEngine
        from euromillioner_tpu.serve import ModelSession
        from euromillioner_tpu.serve import NNBackend as JaxNN
        from euromillioner_tpu.serve import \
            RecurrentBackend as JaxRecurrent
        from euromillioner_tpu.serve import \
            WholeSequenceScheduler as JaxWhole
        from euromillioner_tpu_torch.models.convert import params_from_jax

        rng = np.random.default_rng(11)
        # the MLP: numpy-seeded weights loaded into both packages
        jm = jax_mlp(hidden_sizes=(16,), out_dim=2)
        jp, _ = jm.init(jax.random.PRNGKey(0), (5,))
        jp = jax.tree_util.tree_map(
            lambda a: rng.normal(scale=0.3, size=a.shape).astype(a.dtype),
            jax.device_get(jp))
        pm = build_mlp(hidden_sizes=(16,), out_dim=2, in_features=5,
                       device="cpu")
        pm.load_state_dict(params_from_jax(jp, device="cpu"))
        x = _rows(6, seed=12)
        with JaxEngine(ModelSession(JaxNN(jm, jp, (5,),
                                          compute_dtype=np.float32)),
                       buckets=(8,), max_wait_ms=1.0) as eng:
            want = eng.predict(x)
        backend = NNBackend(pm, (5,), compute_dtype=torch.float32)
        _serve_rows(backend, AotStore(str(tmp_path / "mlp")), x)
        got, counts, _a = _serve_rows(backend,
                                      AotStore(str(tmp_path / "mlp")), x)
        assert counts["compiles"] == 0
        np.testing.assert_allclose(got, want, rtol=F32_RTOL, atol=F32_ATOL)
        # the LSTM behind the batch scheduler, fused="off" in JAX
        jl = jax_lstm(hidden=8, num_layers=1, out_dim=3, fused="off")
        jlp, _ = jl.init(jax.random.PRNGKey(1), (6, 4))
        jlp = jax.tree_util.tree_map(
            lambda a: rng.normal(scale=0.3, size=a.shape).astype(a.dtype),
            jax.device_get(jlp))
        pl = build_lstm(hidden=8, num_layers=1, out_dim=3, in_features=4,
                        device="cpu")
        pl.load_state_dict(params_from_jax(jlp, device="cpu"))
        seqs = _seqs(5, seed=13)
        kw = dict(row_buckets=(4,), time_buckets=(8,), max_wait_ms=1.0,
                  warmup=True)
        with JaxWhole(JaxRecurrent(jl, jlp, feat_dim=4,
                                   compute_dtype=np.float32), **kw) as eng:
            want = np.stack([eng.predict(s) for s in seqs])
        rb = RecurrentBackend(pl, feat_dim=4, compute_dtype=torch.float32)
        for _ in range(2):  # cold, then the warm restart
            with WholeSequenceScheduler(rb, aot=AotStore(
                    str(tmp_path / "lstm")), **kw) as eng:
                got = np.stack([eng.predict(s) for s in seqs])
                compiles = eng._exec.counts()["compiles"]
        assert compiles == 0
        np.testing.assert_allclose(got, want, rtol=F32_RTOL, atol=F32_ATOL)


@pytest.mark.slow
class TestPackagesPerFamily:
    """AOTInductor packages of the remaining row families and of the two
    kernel paths, on the CPU: warm == cold bit for bit, each against the
    eager program at its pinned tolerance."""

    @staticmethod
    def _blob_bytes(d):
        (name,) = _store_files(str(d))
        return (d / name).read_bytes()

    def test_wide_deep_reaches_k4a_inside_the_package(self, tmp_path):
        from euromillioner_tpu_torch.models.wide_deep import WideDeep

        model = WideDeep(compute_dtype=torch.float32, device="cpu",
                         wide_embed_dim=16, embed_dim=8, ball_vocab=16,
                         hidden_sizes=(32,))
        rng = np.random.default_rng(8)
        x = np.concatenate([
            np.stack([rng.integers(1, 8, 8), rng.integers(1, 13, 8),
                      rng.integers(1, 29, 8), rng.integers(2004, 2021, 8)],
                     1), rng.integers(1, 16, size=(8, 7))],
            axis=1).astype(np.float32)
        for profile in ("f32", "bf16"):
            backend = NNBackend(model, (11,), compute_dtype=torch.float32,
                                precision=profile)
            d = tmp_path / profile
            cold, _c, _a = _serve_rows(backend, AotStore(str(d)), x,
                                       precision=profile)
            assert b"emtpu::wide_onehot_fwd" in self._blob_bytes(d)
            warm, counts, _a = _serve_rows(backend, AotStore(str(d)), x,
                                           precision=profile)
            assert counts["compiles"] == 0
            np.testing.assert_array_equal(cold, warm)
            plain, _c, _a = _serve_rows(backend, None, x, precision=profile)
            if profile == "f32":
                np.testing.assert_allclose(warm, plain, rtol=F32_RTOL,
                                           atol=F32_ATOL)
            else:
                rel = np.abs(warm - plain).max() / np.abs(plain).max()
                assert rel <= backend.envelope, rel

    def test_fused_padded_program_reaches_k1_inside_the_package(
            self, tmp_path):
        model = build_lstm(hidden=16, num_layers=2, out_dim=7,
                           in_features=11, device="cpu")
        backend = RecurrentBackend(model, feat_dim=11,
                                   compute_dtype=torch.float32,
                                   precision="fused")
        rng = np.random.default_rng(9)
        seqs = [rng.normal(size=(int(rng.integers(3, 9)), 11)).astype(
            np.float32) for _ in range(4)]
        kw = dict(row_buckets=(4,), time_buckets=(8,), max_wait_ms=1.0,
                  warmup=True)
        outs = []
        for aot in (AotStore(str(tmp_path)), AotStore(str(tmp_path)), None):
            with WholeSequenceScheduler(backend, aot=aot, **kw) as eng:
                outs.append(np.stack([eng.predict(s) for s in seqs]))
        assert b"emtpu::lstm_sequence" in self._blob_bytes(tmp_path)
        np.testing.assert_array_equal(outs[0], outs[1])
        np.testing.assert_allclose(outs[1], outs[2], rtol=F32_RTOL,
                                   atol=F32_ATOL)

    def test_forests_bit_equal_to_predict(self, tmp_path):
        from euromillioner_tpu_torch.serve.session import RFBackend
        from euromillioner_tpu_torch.trees.random_forest import \
            RandomForestModel

        rng = np.random.default_rng(10)
        depth, n_nodes = 3, 15
        cuts = [np.sort(rng.normal(size=15)).astype(np.float32)
                for _ in range(6)]
        x = _rows(8, seed=11, feat=6)
        for classification in (True, False):
            trees = {
                "feature": rng.integers(0, 6, (12, n_nodes)).astype(
                    np.int32),
                "split_bin": rng.integers(0, 16, (12, n_nodes)).astype(
                    np.int32),
                "is_leaf": np.zeros((12, n_nodes), bool),
                "leaf_value": (rng.integers(0, 3, (12, n_nodes))
                               if classification else rng.normal(
                                   size=(12, n_nodes))).astype(np.float32)}
            trees["is_leaf"][:, 7:] = True
            model = RandomForestModel(cuts, trees, depth, classification,
                                      3 if classification else 0,
                                      device="cpu")
            backend = RFBackend(model)
            d = tmp_path / str(classification)
            cold, _c, _a = _serve_rows(backend, AotStore(str(d)), x)
            warm, counts, _a = _serve_rows(backend, AotStore(str(d)), x)
            assert counts["compiles"] == 0
            np.testing.assert_array_equal(cold, warm)
            np.testing.assert_array_equal(warm, model.predict(x))

    def test_classic_ids_equal_predict(self, tmp_path):
        from euromillioner_tpu_torch.classic import LogisticRegression
        from euromillioner_tpu_torch.serve.session import ClassicBackend

        rng = np.random.default_rng(12)
        x = rng.normal(size=(64, 5)).astype(np.float32)
        y = (x[:, 0] > 0).astype(np.int32) + (x[:, 1] > 0.5)
        model = LogisticRegression(device="cpu").fit(x, y)
        backend = ClassicBackend(model)
        cold, _c, _a = _serve_rows(backend, AotStore(str(tmp_path)), x[:8])
        warm, counts, _a = _serve_rows(backend, AotStore(str(tmp_path)),
                                       x[:8])
        assert counts["compiles"] == 0
        np.testing.assert_array_equal(cold, warm)
        np.testing.assert_array_equal(warm, model.predict(x[:8]))
