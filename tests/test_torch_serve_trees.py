"""Chunked ensemble dispatch (``serve.trees.chunk``; trees/chunked.py and
serve/session.py) against the JAX package's, on the CPU.

The JAX package's ``tests/test_serve_trees.py`` classes
``TestChunkedProgram``, ``TestChunkedServing`` and ``TestChunkChaos``, on
the same synthetic tree tables built into both packages' models:
- the chunked programs' outputs BIT-equal to ``predict`` (the -0.0 tail
  pad and the sequential margin carry; exact vote counts) and to the JAX
  package's chunked programs;
- the engine's chunked replies bit-equal to ``predict`` and to the
  unchunked engine; a regressor's refusal and its opt-in approximate mean
  inside the (rf, chunked_mean) envelope;
- the ledger's ``tree_tables`` peak within two blocks, unwound after;
- ``stats()["trees"]``, ``/healthz``'s ``tree_chunks`` and the
  ``serve_tree_chunks_total`` / ``serve_trees`` families only while the
  chunked path is active;
- a ``serve.chunk`` fault fails only its batch.
The JAX cases on a serving mesh (``serve.mesh``) wait for that part of
the port (ROADMAP queue 1 item 13); the AOT store's (``TestChunkAot``)
are in tests/test_torch_aot.py. The buckets here hold the 70 rows in one,
so each request is one micro-batch (a larger request would be cut into
bucket-sized ones).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from euromillioner_tpu.trees import binning as jax_binning
from euromillioner_tpu.trees.gbt import Booster as JaxBooster
from euromillioner_tpu.trees.random_forest import \
    RandomForestModel as JaxForest
from euromillioner_tpu_torch.config import Config, apply_overrides
from euromillioner_tpu_torch.core.precision import serve_envelope
from euromillioner_tpu_torch.obs.top import format_line, summarize_bucket
from euromillioner_tpu_torch.resilience import FaultPlan, FaultSpec, inject
from euromillioner_tpu_torch.serve.engine import InferenceEngine
from euromillioner_tpu_torch.serve.session import (GBTBackend, RFBackend,
                                                   load_backend)
from euromillioner_tpu_torch.serve.transport import healthz_body
from euromillioner_tpu_torch.trees import DMatrix
from euromillioner_tpu_torch.trees.chunked import (BLOCK_KEYS, pad_block,
                                                   slice_blocks)
from euromillioner_tpu_torch.trees.gbt import Booster
from euromillioner_tpu_torch.trees.random_forest import RandomForestModel
from euromillioner_tpu_torch.utils.errors import TrainError

torch.set_num_threads(2)

N_FEATS = 6
BINS = 16
BUCKETS = (8, 128)  # 70 rows fit one bucket: no request is split
WAIT = 60  # seconds any reply may take


def _tables(n_trees, depth, seed, leaf):
    rng = np.random.default_rng(seed)
    cuts = jax_binning.quantile_cuts(
        rng.normal(size=(128, N_FEATS)).astype(np.float32), BINS)
    n_nodes = 2 ** (depth + 1) - 1
    trees = {
        "feature": rng.integers(0, N_FEATS,
                                (n_trees, n_nodes)).astype(np.int32),
        "split_bin": rng.integers(0, BINS,
                                  (n_trees, n_nodes)).astype(np.int32),
        "is_leaf": np.zeros((n_trees, n_nodes), bool),
        "leaf_value": leaf(rng, (n_trees, n_nodes)),
    }
    trees["is_leaf"][:, 2 ** depth - 1:] = True
    return cuts, trees


def synth_booster(n_trees, depth=3, seed=0, base_margin=0.3, jax=False):
    """The JAX test's synthetic booster (stacked complete trees), as the
    port's Booster on the CPU or, with ``jax``, the JAX package's."""
    cuts, trees = _tables(n_trees, depth, seed, lambda rng, shape: rng.normal(
        scale=0.2, size=shape).astype(np.float32))
    params = {"objective": "reg:logistic", "max_depth": depth}
    if jax:
        return JaxBooster(params, cuts, trees, base_margin)
    return Booster(params, cuts, trees, base_margin, device="cpu")


def synth_forest(n_trees, depth=3, num_classes=4, seed=0,
                 classification=True, jax=False):
    def leaf(rng, shape):
        if classification:
            return rng.integers(0, num_classes, shape).astype(np.float32)
        return rng.normal(size=shape).astype(np.float32)

    cuts, trees = _tables(n_trees, depth, seed, leaf)
    classes = num_classes if classification else 0
    if jax:
        return JaxForest(cuts, trees, depth, classification, classes)
    return RandomForestModel(cuts, trees, depth, classification, classes,
                             device="cpu")


@pytest.fixture(scope="module")
def rows():
    return np.random.default_rng(1).normal(
        size=(70, N_FEATS)).astype(np.float32)


def run_chunks(ch, rows):
    """The chunk loop by hand: every block through ``chunk_apply`` from
    ``init_carry``, then ``finish_apply``."""
    x = torch.from_numpy(ch.prepare(rows))
    carry = torch.from_numpy(ch.init_carry(len(rows)))
    with torch.inference_mode():
        for blk in ch.blocks:
            carry = ch.chunk_apply({k: torch.from_numpy(v)
                                    for k, v in blk.items()}, carry, x)
        return ch.finish_apply(carry).numpy()


def run_jax_chunks(ch, rows):
    import jax

    x = jax.device_put(ch.prepare(rows))
    carry = jax.device_put(ch.init_carry(len(rows)))
    step = jax.jit(ch.chunk_apply)
    for blk in ch.blocks:
        carry = step(blk, carry, x)
    return np.asarray(jax.jit(ch.finish_apply)(carry))


def engine(backend, **kw):
    return InferenceEngine(backend, buckets=kw.pop("buckets", BUCKETS),
                           max_wait_ms=1.0, **kw)


class TestChunkedProgram:
    def test_gbt_chunked_margins_bit_equal(self, rows):
        """Per-chunk carry == whole-ensemble sum, bitwise — including a
        tail chunk padded with -0.0 no-op trees (90 trees at chunk 16
        pad the last chunk with 6) — and the JAX package's chunked margins
        bit for bit (both add the leaves one tree at a time in f32)."""
        bst = synth_booster(90)
        ch = bst.chunked_predict_program(N_FEATS, 16)
        assert ch.n_chunks == 6 and ch.n_trees == 90
        got = run_chunks(ch, rows)
        assert got.tobytes() == bst.predict(DMatrix(rows)).tobytes()
        margin = bst.chunked_predict_program(N_FEATS, 16, output_margin=True)
        jch = synth_booster(90, jax=True).chunked_predict_program(
            N_FEATS, 16, output_margin=True)
        for a, b in zip(ch.blocks, jch.blocks):
            assert all(np.array_equal(a[k], b[k]) for k in BLOCK_KEYS)
        assert run_chunks(margin, rows).tobytes() == \
            run_jax_chunks(jch, rows).astype(np.float32).tobytes()

    def test_gbt_output_margin_variant(self, rows):
        bst = synth_booster(40)
        ch = bst.chunked_predict_program(N_FEATS, 8, output_margin=True)
        want = bst.predict(DMatrix(rows), output_margin=True)
        assert run_chunks(ch, rows).tobytes() == want.tobytes()

    def test_chunk_below_two_refused(self):
        with pytest.raises(TrainError, match="chunk"):
            synth_booster(8).chunked_predict_program(N_FEATS, 1)
        with pytest.raises(TrainError, match="chunk"):
            synth_forest(8).chunked_predict_program(N_FEATS, 0)

    def test_rf_classification_votes_bit_equal(self, rows):
        """Exact integer vote counts make any accumulation order
        bit-identical; pad trees vote class -1 and match no class. The
        JAX package's chunked votes agree."""
        rf = synth_forest(50, num_classes=5)
        ch = rf.chunked_predict_program(N_FEATS, 16)
        assert ch.n_chunks == 4
        got = run_chunks(ch, rows)
        assert got.dtype == np.int32
        assert np.array_equal(got, rf.predict(rows))
        jch = synth_forest(50, num_classes=5,
                           jax=True).chunked_predict_program(N_FEATS, 16)
        assert np.array_equal(got, run_jax_chunks(jch, rows))

    def test_rf_regression_not_chunkable(self):
        """The whole-forest mean's reduce order is not a sequential
        carry's: the factory refuses rather than break the bit pin."""
        rf = synth_forest(50, classification=False)
        assert rf.chunked_predict_program(N_FEATS, 16) is None

    def test_blocks_share_one_shape(self):
        ch = synth_booster(90).chunked_predict_program(N_FEATS, 16)
        shapes = {tuple(a.shape for a in blk.values())
                  for blk in ch.blocks}
        assert len(shapes) == 1  # one program serves every chunk
        assert ch.block_bytes > 0
        # the tail: 10 trees, then 6 pad trees, all-leaf with -0.0 leaves
        tail = ch.blocks[-1]
        assert tail["is_leaf"][10:].all()
        assert np.signbit(tail["leaf_value"][10:]).all()
        assert not tail["leaf_value"][10:].any()


class TestChunkedServing:
    def test_engine_bit_equal_to_predict_and_unchunked(self, rows):
        bst = synth_booster(90)
        direct = bst.predict(DMatrix(rows))
        chunked = GBTBackend(bst, chunk=16, chunk_threshold=32)
        assert chunked.chunked is not None
        with engine(chunked) as eng:
            out = eng.submit(rows).result(WAIT)
            st = eng.stats()
        assert np.array_equal(out, direct)
        with engine(GBTBackend(synth_booster(90))) as eng:
            assert np.array_equal(eng.submit(rows).result(WAIT), out)
        # obs surface: chunk size, chunk dispatches, upload wall
        assert st["trees"]["chunk"] == 16
        assert st["trees"]["n_chunks"] == 6
        assert st["trees"]["dispatches"] >= 1
        assert st["trees"]["chunks"] == 6 * st["trees"]["dispatches"]
        assert st["trees"]["chunk_h2d_ms"] >= 0.0

    def test_rf_classification_engine_bit_equal(self, rows):
        rf = synth_forest(50, num_classes=5)
        backend = RFBackend(rf, chunk=16, chunk_threshold=32)
        assert backend.chunked is not None
        with engine(backend) as eng:
            out = eng.submit(rows).result(WAIT)
        assert out.dtype == np.int32
        assert np.array_equal(out, rf.predict(rows))

    def test_rf_regression_falls_back_loudly(self, rows, caplog):
        import logging

        rf = synth_forest(50, classification=False)
        with caplog.at_level(logging.WARNING,
                             logger="euromillioner_tpu_torch"):
            backend = RFBackend(rf, chunk=16, chunk_threshold=32)
        assert backend.chunked is None
        assert any("REGRESSOR" in r.message for r in caplog.records)
        with engine(backend, buckets=(8, 128)) as eng:
            assert np.array_equal(eng.submit(rows).result(WAIT),
                                  rf.predict(rows))

    def test_rf_regression_approx_mean_inside_envelope(self, rows):
        """``approx_mean``: the sum-carry mean serves as the backend's
        ``chunked_mean`` profile, inside the pinned (rf, chunked_mean)
        envelope of the whole-forest predict, sampled by the engine; the
        JAX package's approximate mean gives the same bits."""
        rf = synth_forest(50, classification=False)
        backend = RFBackend(rf, chunk=16, chunk_threshold=32,
                            approx_mean=True)
        assert backend.chunked is not None
        assert backend.precision == "chunked_mean"
        env = serve_envelope("rf", "chunked_mean")
        assert env == 1e-5
        with engine(backend) as eng:
            out = eng.submit(rows).result(WAIT)
            st = eng.stats()
        want = rf.predict(rows)
        rel = np.abs(out - want).max() / np.abs(want).max()
        assert rel <= env, rel
        assert st["precision"]["profile"] == "chunked_mean"
        assert st["precision"]["drift_checks"] >= 1
        assert st["precision"]["envelope_breaches"] == 0
        jch = synth_forest(50, classification=False, jax=True
                           ).chunked_predict_program(N_FEATS, 16,
                                                     approx_mean=True)
        assert run_chunks(backend.chunked, rows).tobytes() == \
            run_jax_chunks(jch, rows).astype(np.float32).tobytes()

    def test_default_and_threshold_keep_todays_path(self, rows):
        """chunk=0 (default) and ensembles at/below the threshold build
        the whole-ensemble program — no chunk state, no stats key."""
        assert GBTBackend(synth_booster(90)).chunked is None
        assert GBTBackend(synth_booster(32), chunk=16,
                          chunk_threshold=32).chunked is None
        with engine(GBTBackend(synth_booster(32)), buckets=(8,)) as eng:
            eng.submit(rows[:8]).result(WAIT)
            st = eng.stats()
            body = healthz_body(eng)
            text = eng.telemetry.render()
        assert "trees" not in st
        assert "tree_chunks" not in body
        assert "serve_tree_chunks_total" not in text
        assert "serve_trees" not in text
        assert "tree_tables" not in st["budget"]["peak"]

    def test_ledger_peak_at_most_two_chunks(self, rows):
        backend = GBTBackend(synth_booster(90), chunk=16,
                             chunk_threshold=32)
        with engine(backend) as eng:
            eng.submit(rows).result(WAIT)
            st = eng.stats()
            desc = eng.precision_desc
        bb = backend.chunked.block_bytes
        peak = st["budget"]["peak"]["tree_tables"]
        assert 0 < peak <= 2 * bb
        assert st["budget"]["bytes"]["tree_tables"] == 0  # unwound
        # the resident figure: the 2-chunk window, not the ensemble
        assert st["budget"]["bytes"]["params"] == 2 * bb
        assert desc["serve_param_mb"] == round(2 * bb / 2**20, 3)

    def test_config_overrides_reach_load_backend(self, tmp_path, rows):
        cfg = apply_overrides(Config(), ["serve.trees.chunk=16",
                                         "serve.trees.chunk_threshold=32"])
        assert cfg.serve.trees.chunk == 16
        path = str(tmp_path / "gbt.json")
        synth_booster(90).save_model(path)
        backend = load_backend("gbt", model_file=path, cfg=cfg,
                               device="cpu")
        assert backend.chunked is not None
        assert backend.chunked.chunk == 16
        rf_path = str(tmp_path / "rf.json")
        synth_forest(50, classification=False).save_model(rf_path)
        cfg = apply_overrides(cfg, ["serve.trees.approx_mean=true"])
        rf = load_backend("rf", model_file=rf_path, cfg=cfg, device="cpu")
        assert rf.precision == "chunked_mean"

    def test_healthz_and_probe_surface(self, rows):
        backend = GBTBackend(synth_booster(90), chunk=16,
                             chunk_threshold=32)
        with engine(backend) as eng:
            eng.submit(rows).result(WAIT)
            body = healthz_body(eng)
        assert body["tree_chunks"] >= 6
        # unchunked hosts omit the field
        with engine(GBTBackend(synth_booster(8)), buckets=(8,)) as eng:
            old = healthz_body(eng)
        assert "tree_chunks" not in old

    def test_metrics_counter_and_gauges(self, rows):
        """The counter and gauges on /metrics, the counter equal to the
        backend's own count; obs-top renders the stats snapshot's
        ``chk=``."""
        backend = GBTBackend(synth_booster(90), chunk=16,
                             chunk_threshold=32)
        with engine(backend) as eng:
            eng.submit(rows).result(WAIT)
            text = eng.telemetry.render()
            st = eng.stats()
        assert "serve_tree_chunks_total" in text
        assert 'serve_trees{family="gbt",stat="chunk"} 16' in text
        assert int(eng.telemetry.tree_chunks.get()) == st["trees"]["chunks"]
        snap = {"ts": 12.0, "event": "stats", "p50_ms": 1.0, "p99_ms": 2.0,
                "errors": 0, "queue_depth": 0, "trees": st["trees"]}
        assert f"chk={st['trees']['chunks']}" in format_line(
            summarize_bucket(12, [snap]))


class TestChunkChaos:
    def test_chunk_fault_fails_only_that_batch(self, rows):
        """A serve.chunk fire fails the one micro-batch riding the chunk
        loop — the carry is dropped, the ledger unwinds, and the engine
        keeps serving; a fault-free rerun is bit-identical."""
        bst = synth_booster(90)
        direct = bst.predict(DMatrix(rows[:8]))
        backend = GBTBackend(bst, chunk=16, chunk_threshold=32)
        plan = FaultPlan([FaultSpec(point="serve.chunk",
                                    raises=RuntimeError, hits=(3,))])
        with inject(plan):
            with engine(backend, buckets=(8,), warmup=False) as eng:
                with pytest.raises(RuntimeError):
                    eng.submit(rows[:8]).result(WAIT)
                # the very next batch completes
                out = eng.submit(rows[:8]).result(WAIT)
                st = eng.stats()
        assert plan.fired_count("serve.chunk") == 1
        assert np.array_equal(out, direct)
        assert st["errors"] == 1
        assert st["budget"]["bytes"]["tree_tables"] == 0  # unwound
        with engine(GBTBackend(synth_booster(90), chunk=16,
                               chunk_threshold=32), buckets=(8,)) as eng:
            assert np.array_equal(eng.submit(rows[:8]).result(WAIT), direct)


def test_pad_block_and_slice_blocks_match_jax():
    """The host blocks are the JAX package's, byte for byte (the same
    C-contiguous copies, pads and dtypes)."""
    from euromillioner_tpu.trees import chunked as jax_chunked

    _, trees = _tables(37, 2, 3, lambda rng, shape: rng.normal(
        size=shape).astype(np.float32))
    for pad_value in (-0.0, -1.0, 0.0):
        got = slice_blocks(trees, 2, 37, 8, pad_value)
        want = jax_chunked.slice_blocks(trees, 2, 37, 8, pad_value)
        assert len(got) == len(want) == 5
        for a, b in zip(got, want):
            for k in BLOCK_KEYS:
                assert a[k].dtype == b[k].dtype
                assert a[k].tobytes() == b[k].tobytes()
    one = {k: v[:3] for k, v in trees.items()}
    a = pad_block(one, 2, 7, -0.0)
    b = jax_chunked.pad_block(one, 2, 7, -0.0)
    assert all(a[k].tobytes() == b[k].tobytes() for k in BLOCK_KEYS)
