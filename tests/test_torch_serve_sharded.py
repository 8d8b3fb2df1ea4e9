"""Mesh-sharded serving in the port (``serve.mesh``; the JAX package's
``tests/test_serve_sharded.py``, class for class): config validation,
bucket and slot rounding, data-parallel bit parity with the one-device
engine, model-parallel Wide&Deep within the rel-error envelope (its leaves
placed as the JAX package places them), the LRU race on a two-device
mesh, the ``serve.shard`` fault point, sharded-dispatch observability and
the chunked tree dispatch on the data axis.

Runs in this process on logical CPU devices (``devices=`` lists the CPU
eight times, or ``EUROMILLIONER_CPU_DEVICES``).

Parity, as the JAX package pins it per path:

* data-parallel rows: the mesh engine is bit-identical to the one-device
  engine on the same requests, and to ``predict`` at the bucket (each
  shard runs the one-device program on its rows);
* the sharded step scheduler: bit-identical to the pool program at the
  shard's row count and to the unsharded scheduler;
* model-parallel Wide&Deep: ≤ 1e-2 max rel of the one-device oracle
  (sharded contractions add in another order).
"""

from __future__ import annotations

import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euromillioner_tpu.models.wide_deep import \
    build_wide_deep as jax_build_wide_deep
from euromillioner_tpu.serve import NNBackend as JaxNNBackend
from euromillioner_tpu.serve import build_serving_mesh as jax_serving_mesh
from euromillioner_tpu_torch.config import Config, apply_overrides
from euromillioner_tpu_torch.models.convert import params_from_jax
from euromillioner_tpu_torch.models.lstm import build_lstm
from euromillioner_tpu_torch.models.mlp import build_mlp
from euromillioner_tpu_torch.models.wide_deep import build_wide_deep
from euromillioner_tpu_torch.resilience import FaultPlan, FaultSpec, inject
from euromillioner_tpu_torch.serve.continuous import (RecurrentBackend,
                                                      StepScheduler)
from euromillioner_tpu_torch.serve.engine import InferenceEngine
from euromillioner_tpu_torch.serve.session import (GBTBackend, ModelSession,
                                                   NNBackend, RFBackend,
                                                   build_serving_mesh)
from euromillioner_tpu_torch.serve.transport import (handle_request,
                                                     healthz_body)
from euromillioner_tpu_torch.trees import DMatrix, train
from euromillioner_tpu_torch.trees.random_forest import RandomForestModel
from euromillioner_tpu_torch.utils.errors import ConfigError, ServeError

torch.set_num_threads(2)

N_FEATURES = 9
CPU8 = ["cpu"] * 8
WAIT = 60  # seconds any reply may take


@pytest.fixture(scope="module")
def mesh4():
    return build_serving_mesh((4, 1), devices=CPU8)


@pytest.fixture(scope="module")
def mesh2():
    return build_serving_mesh((2, 1), devices=CPU8)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(300, N_FEATURES)).astype(np.float32)
    w = rng.normal(size=(N_FEATURES,)).astype(np.float32)
    y = (x @ w + 0.3 * rng.normal(size=300) > 0).astype(np.float32)
    q = rng.normal(size=(120, N_FEATURES)).astype(np.float32)
    return x, y, q


@pytest.fixture(scope="module")
def mlp_backend():
    model = build_mlp((16, 16), out_dim=3, in_features=N_FEATURES,
                      device="cpu")
    return NNBackend(model, (N_FEATURES,), compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def booster(data):
    x, y, _ = data
    return train({"objective": "binary:logistic", "max_depth": 3,
                  "device": "cpu"}, DMatrix(x, y), 3, verbose_eval=False)


@pytest.fixture(scope="module")
def lstm_backend():
    model = build_lstm(hidden=32, num_layers=2, out_dim=7, fused="off",
                       device="cpu")
    return RecurrentBackend(model, feat_dim=11, compute_dtype=torch.float32)


def pool_program(backend, seq, rows):
    """``seq``'s reply from the block program run straight through at a
    pool of ``rows`` rows (the port's direct-apply oracle at a shard's
    shape; tests/test_torch_serve_step.py)."""
    x = torch.from_numpy(np.repeat(seq[None], rows, 0))
    _, y = backend.block_fn(backend.init_states(rows), x,
                            torch.ones((rows, 1), dtype=torch.bool))
    return y[0, -1].numpy()


class TestServingMeshConfig:
    def test_default_1x1_builds_no_mesh(self):
        assert build_serving_mesh((1, 1)) is None

    def test_axes_shape(self, mesh4):
        assert mesh4.shape == {"data": 4, "model": 1}

    def test_single_value_normalizes_to_data_axis(self):
        assert build_serving_mesh((2,), devices=CPU8).shape == {
            "data": 2, "model": 1}

    @pytest.mark.parametrize("axes", [(3, 1), (16, 1), (0, 2), (2, -1),
                                      (2, 2, 2), ("2x1",)])
    def test_bad_axes_rejected_with_config_error(self, axes, monkeypatch):
        """Axis sizes that do not fit or divide the 8 devices are a
        front-door ConfigError (exit 17), through ``devices=`` and through
        ``EUROMILLIONER_CPU_DEVICES``."""
        with pytest.raises(ConfigError) as e:
            build_serving_mesh(axes, devices=CPU8)
        assert e.value.exit_code == 17
        monkeypatch.setenv("EUROMILLIONER_CPU_DEVICES", "8")
        with pytest.raises(ConfigError):
            build_serving_mesh(axes, device="cpu")

    def test_cli_override_coerces_mesh_tuple(self):
        cfg = apply_overrides(Config(), ["serve.mesh=2,1"])
        assert cfg.serve.mesh == (2, 1)
        assert Config().serve.mesh == (1, 1)
        cfg = apply_overrides(Config(), ["serve.mesh=4"])
        assert build_serving_mesh(cfg.serve.mesh,
                                  devices=CPU8).shape["data"] == 4
        cfg = apply_overrides(Config(), ["serve.mesh=2x1"])
        with pytest.raises(ConfigError, match="e.g. serve.mesh=4,1"):
            build_serving_mesh(cfg.serve.mesh, devices=CPU8)

    def test_bucket_table_rounds_up(self, mlp_backend, mesh4):
        session = ModelSession(mlp_backend, mesh=mesh4)
        assert session.round_buckets((10, 30)) == (12, 32)
        assert session.round_buckets((8, 32)) == (8, 32)  # already even
        with pytest.raises(ServeError):
            session.round_buckets(())  # still validated first

    def test_slot_pool_rounds_up(self, lstm_backend, mesh4):
        with StepScheduler(lstm_backend, max_slots=6, step_block=4,
                           mesh=mesh4, warmup=False) as sched:
            assert sched.max_slots == 8
            assert sched.stats()["mesh"] == "4x1"

    def test_one_by_one_is_todays_engine(self, mlp_backend, data):
        """serve.mesh=(1,1) builds no mesh: the session is the backend's
        single-device path (no mesh key in stats)."""
        _, _, q = data
        session = ModelSession(mlp_backend, mesh=build_serving_mesh((1, 1)))
        assert session.mesh is None
        with InferenceEngine(session, buckets=(8,), max_wait_ms=1.0,
                             warmup=False) as eng:
            assert eng.backend is mlp_backend
            assert np.array_equal(eng.predict(q[:8]),
                                  mlp_backend.predict(q[:8]))
            assert "mesh" not in eng.stats()
            assert "mesh" not in healthz_body(eng)


class TestDataParallelRowParity:
    def test_mlp_bit_identical_across_sizes(self, mlp_backend, data,
                                            mesh4):
        """Mesh engine == one-device engine at every request size, and ==
        direct predict at the bucket, bit for bit."""
        _, _, q = data
        with InferenceEngine(mlp_backend, buckets=(8, 32), max_wait_ms=1.0,
                             warmup=False) as e1, \
             InferenceEngine(ModelSession(mlp_backend, mesh=mesh4),
                             buckets=(8, 32), max_wait_ms=1.0,
                             warmup=False) as e4:
            for n in (1, 3, 4, 8, 9, 17, 32):
                got = e4.predict(q[:n])
                assert np.array_equal(got, e1.predict(q[:n])), n
                if n in (8, 32):
                    assert np.array_equal(got, mlp_backend.predict(q[:n]))

    def test_gbt_bit_identical(self, booster, data, mesh4):
        _, _, q = data
        backend = GBTBackend(booster)
        with InferenceEngine(ModelSession(backend, mesh=mesh4),
                             buckets=(8, 32), max_wait_ms=1.0,
                             warmup=False) as eng:
            for n in (1, 5, 8, 23):
                assert np.array_equal(eng.predict(q[:n]),
                                      booster.predict(DMatrix(q[:n]))), n

    def test_stats_and_healthz_surface_mesh(self, mlp_backend, data,
                                            mesh4):
        _, _, q = data
        with InferenceEngine(ModelSession(mlp_backend, mesh=mesh4),
                             buckets=(8,), max_wait_ms=1.0,
                             warmup=False) as eng:
            eng.predict(q[:3])
            assert eng.stats()["mesh"] == "4x1"
            assert eng.mesh_desc == "4x1"
            assert healthz_body(eng)["mesh"] == "4x1"
            status, _ = handle_request(eng, {"rows": q[:2].tolist()})
            assert status == 200

    def test_jsonl_records_mesh_and_transfer_time(self, mlp_backend,
                                                  data, mesh4, tmp_path):
        """Every micro-batch record carries the mesh and the sharded
        upload's wall time."""
        _, _, q = data
        path = tmp_path / "metrics.jsonl"
        with InferenceEngine(ModelSession(mlp_backend, mesh=mesh4),
                             buckets=(8,), max_wait_ms=1.0, warmup=False,
                             metrics_jsonl=str(path)) as eng:
            eng.predict(q[:5])
        recs = [json.loads(ln) for ln in path.read_text().splitlines()]
        batches = [r for r in recs if r.get("event") == "batch"]
        assert batches
        assert all(r["mesh"] == "4x1" for r in batches)
        assert all(r["shard_put_ms"] >= 0 for r in batches)

    def test_warmup_runs_the_rounded_buckets(self, mlp_backend, data,
                                             mesh4):
        _, _, q = data
        session = ModelSession(mlp_backend, mesh=mesh4)
        plan = FaultPlan([FaultSpec(point="serve.shard",
                                    raises=RuntimeError, hits=(1,))])
        with inject(plan):
            with InferenceEngine(session, buckets=(6, 10), max_wait_ms=1.0,
                                 warmup=True) as eng:
                assert eng.buckets == (8, 12)
                # the warmup uploads pass no fault point: the first
                # request's upload is the point's first hit
                with pytest.raises(RuntimeError, match="injected fault"):
                    eng.predict(q[:3])
        assert plan.fired_count("serve.shard") == 1
        assert session.compiled_count == 0  # eager: nothing compiled

    def test_meshed_session_is_not_bound_to_the_aot_store(self, mlp_backend,
                                                          mesh4, caplog):
        import logging

        with caplog.at_level(logging.INFO):
            session = ModelSession(mlp_backend, mesh=mesh4, aot=object())
        assert session.aot is None
        assert "meshed session executables are not persisted" in caplog.text


class TestModelParallelWideDeep:
    @pytest.fixture(scope="class")
    def wd(self):
        jmodel = jax_build_wide_deep(target_params=400_000,
                                     hidden_sizes=(64, 32),
                                     compute_dtype=jnp.float32)
        jparams, _ = jmodel.init(jax.random.PRNGKey(1), (11,))
        model = build_wide_deep(target_params=400_000, hidden_sizes=(64, 32),
                                compute_dtype=torch.float32, device="cpu")
        model.load_state_dict(params_from_jax(jax.device_get(jparams),
                                              device="cpu"))
        rng = np.random.default_rng(3)
        n = 24
        x = np.concatenate([
            np.stack([rng.integers(1, 8, n), rng.integers(1, 13, n),
                      rng.integers(1, 29, n),
                      rng.integers(2004, 2021, n)], 1),
            rng.integers(1, 51, size=(n, 5)),
            rng.integers(1, 13, size=(n, 2))], axis=1).astype(np.float32)
        return model, (jmodel, jparams), x

    def test_sharded_params_placed_per_rule_at_restore(self, wd):
        """A model-axis mesh places the wide table, embeddings and kernels
        split over ``model`` as the JAX package places them, each device
        its own contiguous shard; the out_dim=7 head falls back to
        row-parallel."""
        model, (jmodel, jparams), _ = wd
        mesh = build_serving_mesh((2, 4), devices=CPU8)
        backend = NNBackend(model, (11,), compute_dtype=torch.float32,
                            mesh=mesh)
        placed, dims = backend.placed_params("f32")
        jback = JaxNNBackend(jmodel, jparams, (11,),
                             compute_dtype=np.float32,
                             mesh=jax_serving_mesh((2, 4)))
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                jback.params)[0]:
            name = ".".join(str(getattr(k, "key", k)) for k in path)
            spec = tuple(leaf.sharding.spec)
            split = [d for d, a in enumerate(spec) if a]
            assert dims[name] == (split[0] if split else None), name
            for i in range(2):
                for j in range(4):
                    t = placed[i][j][name]
                    assert tuple(t.shape) == tuple(
                        leaf.sharding.shard_shape(leaf.shape)), name
                    assert t.is_contiguous()
        assert dims["wide_table"] == 1
        assert dims["deep.2_Dense.kernel"] == 0
        e = model.wide_embed_dim
        assert placed[0][3]["wide_table"].shape[1] == e // 4
        assert torch.equal(placed[1][3]["wide_table"],
                           model.wide_table[:, 3 * e // 4:])

    def test_envelope_vs_single_device(self, wd):
        """The engine on a model-parallel mesh stays within the 1e-2
        max-rel envelope of the one-device oracle."""
        model, _, x = wd
        oracle = NNBackend(model, (11,), compute_dtype=torch.float32)
        mesh = build_serving_mesh((2, 4), devices=CPU8)
        backend = NNBackend(model, (11,), compute_dtype=torch.float32,
                            mesh=mesh)
        with InferenceEngine(ModelSession(backend, mesh=mesh),
                             buckets=(24,), max_wait_ms=1.0,
                             warmup=False) as eng:
            got = eng.predict(x)
            assert eng.stats()["mesh"] == "2x4"
        want = oracle.predict(x)
        rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-6)
        assert rel.max() <= 1e-2, rel.max()

    def test_model_axis_without_rules_replicates_with_the_warning(
            self, mlp_backend, data, caplog):
        import logging

        _, _, q = data
        mesh = build_serving_mesh((1, 2), devices=CPU8)
        with caplog.at_level(logging.WARNING):
            session = ModelSession(mlp_backend, mesh=mesh)
            with InferenceEngine(session, buckets=(8,), max_wait_ms=1.0,
                                 warmup=False) as eng:
                got = eng.predict(q[:8])
        assert "has no sharding rules; params replicate" in caplog.text
        assert np.array_equal(got, mlp_backend.predict(q[:8]))


class TestShardedStepScheduler:
    def test_bit_identical_to_direct_apply(self, lstm_backend, mesh4):
        rng = np.random.default_rng(5)
        seqs = [rng.normal(size=(int(t), 11)).astype(np.float32)
                for t in (3, 5, 9, 16, 2, 12, 7, 4, 20, 1)]
        with StepScheduler(lstm_backend, max_slots=8, step_block=4,
                           mesh=mesh4, warmup=True) as sched:
            futs = [sched.submit(s) for s in seqs]
            for s, f in zip(seqs, futs):
                assert np.array_equal(f.result(timeout=WAIT),
                                      pool_program(lstm_backend, s, 2))
            st = sched.stats()
        assert st["mesh"] == "4x1"
        assert st["sequences"] == len(seqs)
        assert st["failed"] == 0

    def test_matches_unsharded_scheduler(self, lstm_backend, mesh4):
        """The sharded pool runs the unsharded block program on each
        shard's slots: replies equal the one-device scheduler's."""
        rng = np.random.default_rng(6)
        seqs = [rng.normal(size=(int(t), 11)).astype(np.float32)
                for t in (6, 11, 4, 15)]
        with StepScheduler(lstm_backend, max_slots=8, step_block=4,
                           warmup=False) as plain:
            want = [plain.predict(s) for s in seqs]
        with StepScheduler(lstm_backend, max_slots=8, step_block=4,
                           mesh=mesh4, warmup=False) as sharded:
            for s, w in zip(seqs, want):
                assert np.array_equal(sharded.predict(s), w)

    def test_jsonl_step_records_mesh(self, lstm_backend, mesh4, tmp_path):
        path = tmp_path / "steps.jsonl"
        with StepScheduler(lstm_backend, max_slots=8, step_block=4,
                           mesh=mesh4, warmup=False,
                           metrics_jsonl=str(path)) as sched:
            sched.predict(np.zeros((6, 11), np.float32))
            assert healthz_body(sched)["mesh"] == "4x1"
        recs = [json.loads(ln) for ln in path.read_text().splitlines()]
        steps = [r for r in recs if r.get("event") == "step"]
        assert steps
        assert all(r["mesh"] == "4x1" for r in steps)
        assert all("shard_put_ms" in r for r in steps)

    def test_paging_refuses_a_mesh(self, lstm_backend, mesh4):
        from euromillioner_tpu_torch.serve.continuous import PagingPolicy

        with pytest.raises(ServeError, match="single-device"):
            StepScheduler(lstm_backend, max_slots=8, step_block=4,
                          mesh=mesh4, warmup=False,
                          paging=PagingPolicy(enabled=True))


class TestMeshSessionConcurrency:
    def test_lru_eviction_race_on_two_device_mesh(self, mlp_backend,
                                                  data, mesh2):
        """Two engines share one mesh session bounded to a single cached
        program (disjoint buckets); concurrent submits stay parity-exact
        and the bound holds."""
        _, _, q = data
        session = ModelSession(mlp_backend, max_executables=1, mesh=mesh2)
        with InferenceEngine(mlp_backend, buckets=(4,), max_wait_ms=1.0,
                             warmup=False) as p4, \
             InferenceEngine(mlp_backend, buckets=(8,), max_wait_ms=1.0,
                             warmup=False) as p8:
            want4, want8 = p4.predict(q[:4]), p8.predict(q[:8])
        errors: list[str] = []
        with InferenceEngine(session, buckets=(4,), max_wait_ms=1.0,
                             warmup=False) as eng4, \
             InferenceEngine(session, buckets=(8,), max_wait_ms=1.0,
                             warmup=False) as eng8:

            def worker(eng, rows, want) -> None:
                try:
                    for _ in range(6):
                        got = eng.predict(q[:rows])
                        if not np.array_equal(got, want):
                            errors.append(f"mismatch at rows={rows}")
                except Exception as e:  # noqa: BLE001 — recorded, asserted
                    errors.append(repr(e))

            threads = [threading.Thread(target=worker, args=a)
                       for a in ((eng4, 4, want4), (eng8, 8, want8))
                       for _ in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=WAIT)
        assert not errors, errors[:3]
        assert session.compiled_count <= 1  # the bound held throughout


@pytest.mark.chaos
class TestShardChaos:
    def test_shard_fault_fails_batch_not_session(self, mlp_backend, data,
                                                 mesh4):
        """A fault at the sharded upload fails that micro-batch's futures
        only; the mesh session keeps serving bit-exact."""
        _, _, q = data
        plan = FaultPlan([FaultSpec(point="serve.shard",
                                    raises=RuntimeError, hits=(2,))])
        with inject(plan):
            with InferenceEngine(ModelSession(mlp_backend, mesh=mesh4),
                                 buckets=(8,), max_wait_ms=1.0,
                                 warmup=False) as eng:
                ok1 = eng.predict(q[:3])          # hit 1: serves
                f2 = eng.submit(q[:3])            # hit 2: injected fault
                with pytest.raises(RuntimeError, match="injected fault"):
                    f2.result(timeout=30)
                ok3 = eng.predict(q[:3])          # hit 3: serves again
                st = eng.stats()
        assert plan.fired_count("serve.shard") == 1
        assert np.array_equal(ok1, ok3)
        assert st["errors"] == 1

    def test_shard_fault_in_step_scheduler_rebuilds_pool(self,
                                                         lstm_backend,
                                                         mesh4):
        """A sharded block's fault fails only slot-holding sequences; a
        later sequence completes bit-exact on the rebuilt sharded pool."""
        rng = np.random.default_rng(7)
        a = rng.normal(size=(9, 11)).astype(np.float32)
        b = rng.normal(size=(5, 11)).astype(np.float32)
        plan = FaultPlan([FaultSpec(point="serve.shard",
                                    raises=OSError, hits=(1,))])
        with inject(plan):
            with StepScheduler(lstm_backend, max_slots=8, step_block=4,
                               mesh=mesh4, warmup=False,
                               start=False) as sched:
                fa = sched.submit(a)
                sched.start()
                with pytest.raises(OSError, match="injected fault"):
                    fa.result(timeout=30)
                got = sched.predict(b)
                st = sched.stats()
        assert np.array_equal(got, pool_program(lstm_backend, b, 2))
        assert st["failed"] == 1
        assert st["errors"] == 1
        assert st["active"] == 0


class TestChunkedTreesOnTheMesh:
    @staticmethod
    def _models():
        rng = np.random.default_rng(3)
        x = rng.normal(size=(256, 6)).astype(np.float32)
        y = (x[:, 0] + x[:, 1] > 0).astype(np.float32)
        booster = train({"objective": "binary:logistic", "max_depth": 3,
                         "device": "cpu"}, DMatrix(x, y), 40,
                        verbose_eval=False)
        return x, booster

    def test_mesh_data_axis_bit_equal(self):
        """serve.mesh=(2,1) with serve.trees.chunk: each shard runs the
        chunk loop on its rows, bit-identical to the one-device chunked
        program."""
        x, booster = self._models()
        ref_b = GBTBackend(booster, chunk=16, chunk_threshold=32)
        with InferenceEngine(ref_b, buckets=(8, 32)) as eng:
            ref = eng.predict(x[:24])
        mesh_b = GBTBackend(booster, chunk=16, chunk_threshold=32)
        mesh = build_serving_mesh((2, 1), devices=CPU8)
        with InferenceEngine(ModelSession(mesh_b, mesh=mesh),
                             buckets=(8, 32)) as eng:
            out = eng.predict(x[:24])
            st = eng.stats()
        np.testing.assert_array_equal(ref, out)
        assert st["mesh"] == "2x1"
        assert st["trees"]["chunk"] == 16

    def test_mesh_model_axis_rejected(self):
        _, booster = self._models()
        backend = GBTBackend(booster, chunk=16, chunk_threshold=32)
        mesh = build_serving_mesh((2, 4), devices=CPU8)
        with pytest.raises(ConfigError, match="serve.trees.chunk"):
            ModelSession(backend, mesh=mesh)


def test_rf_replies_bit_equal_on_the_mesh(mesh4):
    rng = np.random.default_rng(9)
    x = rng.normal(size=(128, 4)).astype(np.float32)
    y = rng.integers(0, 3, 128)
    from euromillioner_tpu_torch.trees import train_classifier

    forest = train_classifier(x, y, 3, num_trees=4, max_depth=3,
                              device="cpu")
    assert isinstance(forest, RandomForestModel)
    with InferenceEngine(ModelSession(RFBackend(forest), mesh=mesh4),
                         buckets=(8, 32), max_wait_ms=1.0,
                         warmup=False) as eng:
        got = eng.predict(x[:20])
    assert np.array_equal(got, forest.predict(x[:20]))


@pytest.mark.slow
class TestShardedSoak:
    def test_mixed_length_soak_on_mesh(self, lstm_backend, mesh4):
        """300 mixed-length sequences through the sharded slot pool:
        every reply bit-identical to the pool program, no slot leaks."""
        rng = np.random.default_rng(11)
        lens = np.where(rng.random(300) < 0.85,
                        rng.integers(2, 17, 300), rng.integers(48, 65, 300))
        seqs = [rng.normal(size=(int(t), 11)).astype(np.float32)
                for t in lens]
        with StepScheduler(lstm_backend, max_slots=16, step_block=4,
                           mesh=mesh4, warmup=True) as sched:
            futs = [sched.submit(s) for s in seqs]
            for s, f in zip(seqs, futs):
                assert np.array_equal(f.result(timeout=120),
                                      pool_program(lstm_backend, s, 4))
            st = sched.stats()
        assert st["sequences"] == 300
        assert st["failed"] == 0
        assert st["active"] == 0
