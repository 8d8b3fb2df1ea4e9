"""The row families' narrow serving tiers in the port (``bf16`` and
``int8w`` of the mlp and Wide&Deep: ``NNBackend.serve_params`` /
``serve_apply``, ``WideDeep.quantized_apply``, the row engine's
``serve.profiles`` children) against the JAX package's same profile and
against the port's own f32 oracle, on the CPU, from JAX-initialised
params."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euromillioner_tpu.core import precision as jax_prec
from euromillioner_tpu.models.mlp import build_mlp as jax_build_mlp
from euromillioner_tpu.models.wide_deep import WideDeep as JaxWideDeep
from euromillioner_tpu.serve.session import NNBackend as JaxNNBackend
from euromillioner_tpu_torch import cli
from euromillioner_tpu_torch.config import Config, apply_overrides
from euromillioner_tpu_torch.core import precision as prec
from euromillioner_tpu_torch.core.precision import SERVE_ENVELOPES, rel_error
from euromillioner_tpu_torch.models import wide_deep as port_wide_deep
from euromillioner_tpu_torch.models.convert import params_from_jax
from euromillioner_tpu_torch.models.mlp import build_mlp
from euromillioner_tpu_torch.models.wide_deep import WideDeep
from euromillioner_tpu_torch.serve.engine import InferenceEngine
from euromillioner_tpu_torch.serve.session import NNBackend, load_backend
from euromillioner_tpu_torch.serve.transport import (handle_request,
                                                     healthz_body)
from euromillioner_tpu_torch.train import checkpoint as port_ck
from euromillioner_tpu_torch.train.optim import adam
from euromillioner_tpu_torch.train.trainer import Trainer
from euromillioner_tpu_torch.utils.errors import ConfigError, ServeError

torch.set_num_threads(2)

BUCKET = 8
# the small exact-vocabulary Wide&Deep of tests/test_serve_quant.py
WD_SMALL = {"wide_embed_dim": 16, "embed_dim": 8, "ball_vocab": 16,
            "hidden_sizes": (32,), "out_dim": 7}
# an mlp whose kernels the int8w size rule quantizes (>= 512 elements)
MLP_HIDDEN = (64, 32)
FAMILIES = ["mlp", "wide_deep"]
PROFILES = ["bf16", "int8w"]
# The port's narrow replies against the JAX package's same profile on the
# same params, relative to the replies' scale (seeds 0-2). Measured: mlp
# bf16 bit-equal; Wide&Deep bf16 within 2.5e-3 (its towers round to bf16
# at other places in XLA than in PyTorch: under one bf16 ulp, 2^-8, which
# is the pin); int8w (the quantized trees are bit-equal) within 2.3e-7,
# f32 sums in another order, pinned at 2e-6.
VS_JAX_TOL = {("mlp", "bf16"): 0.0, ("wide_deep", "bf16"): 2.0 ** -8,
              ("mlp", "int8w"): 2e-6, ("wide_deep", "int8w"): 2e-6}


def _wd_rows(n, seed=3):
    rng = np.random.default_rng(seed)
    return np.concatenate([
        np.stack([rng.integers(1, 8, n), rng.integers(1, 13, n),
                  rng.integers(1, 29, n), rng.integers(2004, 2021, n)], 1),
        rng.integers(1, 51, size=(n, 5)), rng.integers(1, 13, size=(n, 2)),
    ], axis=1).astype(np.float32)


def _rows(family, n=2 * BUCKET, seed=3):
    if family == "wide_deep":
        return _wd_rows(n, seed)
    return np.random.default_rng(seed).normal(size=(n, 10)).astype(
        np.float32)


@pytest.fixture(scope="module", params=FAMILIES)
def pair(request):
    """(family, JAX NNBackend, port NNBackend building both narrow tiers)
    over the same JAX-initialised f32 params."""
    family = request.param
    if family == "wide_deep":
        jm = JaxWideDeep(compute_dtype=jnp.float32, **WD_SMALL)
        pm = WideDeep(compute_dtype=torch.float32, device="cpu", **WD_SMALL)
        feat = (11,)
    else:
        jm = jax_build_mlp(MLP_HIDDEN)
        pm = build_mlp(MLP_HIDDEN, device="cpu")
        feat = (10,)
    params, _ = jm.init(jax.random.PRNGKey(0), feat)
    params = jax.device_get(params)
    pm.load_state_dict(params_from_jax(params, "cpu"))
    jb = JaxNNBackend(jm, params, feat, compute_dtype=np.float32)
    pb = NNBackend(pm, feat, compute_dtype=torch.float32,
                   profiles=PROFILES)
    return family, jb, pb


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) and not jax_prec.is_quantized(v):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _jax_reply(jb, profile, x):
    fn = jax.jit(jb.serve_apply(profile))
    return np.asarray(fn(jb.serve_params(profile), jnp.asarray(x)))


def _port_reply(pb, profile, x):
    return pb.serve_apply(profile)(torch.from_numpy(x)).numpy()


# -- the trees ---------------------------------------------------------------

def test_narrow_trees_bit_equal_to_jax(pair):
    """bf16 casts and int8w quantizations (per Wide&Deep's quant_rules,
    else the size rule on the Dense stack) leaf by leaf, and each leaf
    dequantized back."""
    family, jb, pb = pair
    for profile in PROFILES:
        want = _flat(jax.device_get(jb.serve_params(profile)))
        got = pb.serve_params(profile)
        assert set(got) == set(want), profile
        for key, w in want.items():
            g = got[key]
            assert prec.is_quantized(g) == jax_prec.is_quantized(w), key
            if prec.is_quantized(g):
                np.testing.assert_array_equal(g[prec.INT8_Q].numpy(),
                                              np.asarray(w[jax_prec.INT8_Q]))
                np.testing.assert_array_equal(
                    g[prec.INT8_SCALE].numpy(),
                    np.asarray(w[jax_prec.INT8_SCALE]))
            else:
                np.testing.assert_array_equal(
                    g.float().numpy(), np.asarray(w, np.float32), key)
            np.testing.assert_array_equal(
                prec.dequantize_leaf(g).float().numpy(),
                np.asarray(jax_prec.dequantize_leaf(w), np.float32), key)
    quantized = {k for k, v in pb.serve_params("int8w").items()
                 if prec.is_quantized(v)}
    if family == "wide_deep":
        assert quantized == {k for k in got if not k.endswith("bias")}
    else:
        assert quantized == {"0_Dense.kernel", "1_Dense.kernel"}


def test_int8w_params_are_about_a_quarter_of_f32(pair):
    from euromillioner_tpu_torch.serve.engine import param_bytes

    _, _, pb = pair
    f32 = param_bytes(pb.serve_params("f32"))
    assert param_bytes(pb.serve_params("bf16")) == f32 // 2
    assert param_bytes(pb.serve_params("int8w")) < 0.45 * f32


# -- the replies -------------------------------------------------------------

@pytest.mark.parametrize("profile", PROFILES)
def test_narrow_replies_match_jax(pair, profile):
    family, jb, pb = pair
    x = _rows(family)
    got, want = _port_reply(pb, profile, x), _jax_reply(jb, profile, x)
    assert got.shape == want.shape and got.dtype == np.float32
    assert rel_error(got, want) <= VS_JAX_TOL[(family, profile)]


@pytest.mark.parametrize("profile", PROFILES)
def test_narrow_replies_inside_the_envelope_of_the_f32_oracle(pair,
                                                              profile):
    """Inside SERVE_ENVELOPES of ``predict`` at the same rows, and not the
    f32 replies themselves (no narrow tier quietly serves f32)."""
    family, _, pb = pair
    x = _rows(family)
    err = rel_error(_port_reply(pb, profile, x), pb.predict(x))
    assert 0.0 < err <= SERVE_ENVELOPES[(pb.family, profile)]
    assert np.array_equal(_port_reply(pb, "f32", x), pb.predict(x))


def test_quantized_apply_takes_float_and_partly_quantized_trees():
    """WideDeep.quantized_apply against the JAX package's on a float tree
    and on a tree with only the wide table quantized; it never reaches
    the one-hot kernels' wrapper."""
    jm = JaxWideDeep(compute_dtype=jnp.float32, **WD_SMALL)
    params = jax.device_get(jm.init(jax.random.PRNGKey(1), (11,))[0])
    pm = WideDeep(compute_dtype=torch.float32, device="cpu", **WD_SMALL)
    flat = params_from_jax(params, "cpu")
    pm.load_state_dict(flat)
    x = _wd_rows(12, seed=4)
    for names in (["ball_embed"], ["wide_table"], None):
        jtree = (params if names is None
                 else jax_prec.quantize_int8w(params, names=names))
        ptree = (flat if names is None
                 else prec.quantize_int8w(flat, names=names))
        want = np.asarray(jm.quantized_apply(jtree, jnp.asarray(x)))
        got = pm.quantized_apply(ptree, torch.from_numpy(x)).numpy()
        assert rel_error(got, want) <= VS_JAX_TOL[("wide_deep", "int8w")]
    # the float tree is the f32 forward up to the gather-sum order
    assert rel_error(pm.quantized_apply(flat, torch.from_numpy(x)),
                     pm.apply(torch.from_numpy(x)).detach()) <= 2e-6


def test_int8w_wide_deep_never_reaches_the_kernel_wrapper(monkeypatch):
    """The int8w tier is the gather program: with the one-hot kernels'
    wrapper refusing every call it still serves, while bf16 reaches it."""
    model = WideDeep(compute_dtype=torch.float32, device="cpu", **WD_SMALL)
    pb = NNBackend(model, (11,), compute_dtype=torch.float32,
                   profiles=PROFILES)

    def refuse(*a, **k):
        raise AssertionError("int8w reached wide_onehot_matmul")

    monkeypatch.setattr(port_wide_deep, "wide_onehot_matmul", refuse)
    assert np.isfinite(_port_reply(pb, "int8w", _wd_rows(BUCKET))).all()
    with pytest.raises(AssertionError, match="reached"):
        _port_reply(pb, "bf16", _wd_rows(BUCKET))


# -- the engine and its profile children ------------------------------------

def _engine(backend, **kw):
    return InferenceEngine(backend, buckets=(BUCKET,), max_wait_ms=2.0,
                           **kw)


@pytest.mark.parametrize("profile", PROFILES)
def test_engine_serves_a_narrow_profile_and_samples_drift(pair, profile):
    """A full bucket replies bit-equal to the profile's program at that
    shape; the first batch's drift against the f32 oracle is recorded."""
    _, _, pb = pair
    x = _rows(pair[0], BUCKET)
    with _engine(pb, precision=profile) as eng:
        got = eng.predict(x)
        st = eng.stats()
        desc = eng.precision_desc
    assert np.array_equal(got, _port_reply(pb, profile, x))
    drift = st["precision"]
    assert drift["profile"] == profile and drift["drift_checks"] == 1
    assert drift["envelope_breaches"] == 0
    assert 0.0 < drift["drift_max"] <= SERVE_ENVELOPES[(pb.family, profile)]
    assert desc["precision"] == profile and desc["envelope"] == \
        SERVE_ENVELOPES[(pb.family, profile)]


def test_profiles_route_each_request_to_its_child(pair):
    """serve.profiles=bf16,int8w over an f32 engine: each request served
    by the profile it names, per-profile stats, /healthz's profiles, and
    an unserved profile refused by name."""
    family, _, pb = pair
    x = _rows(family, BUCKET)
    with _engine(pb, profiles=PROFILES) as eng:
        assert sorted(eng.children) == PROFILES
        replies = {p: eng.predict(x, profile=p) for p in PROFILES}
        replies["f32"] = eng.predict(x)
        status, body = handle_request(eng, {"rows": x.tolist(),
                                            "profile": "int8w"})
        bad, why = handle_request(eng, {"rows": x.tolist(),
                                        "profile": "fused"})
        health = healthz_body(eng)
        st = eng.stats()
    assert np.array_equal(replies["f32"], pb.predict(x))
    for p in PROFILES:
        assert np.array_equal(replies[p], _port_reply(pb, p, x)), p
    assert status == 200 and np.array_equal(
        np.asarray(body["predictions"], np.float32), replies["int8w"])
    assert bad == 400 and "unknown precision profile" in why["error"]
    assert health["profiles"] == ["f32", *PROFILES]
    assert st["profiles"]["f32"]["completed"] == 1
    assert st["profiles"]["bf16"]["completed"] == 1
    assert st["profiles"]["int8w"]["completed"] == 2
    assert st["profiles"]["int8w"]["drift"]["drift_checks"] >= 1


def test_profiles_are_validated_before_anything_is_built(pair):
    _, _, pb = pair
    with pytest.raises(ConfigError, match="fp8"):
        _engine(pb, profiles=("fp8",))
    with pytest.raises(ConfigError, match="fused"):
        _engine(pb, profiles=("fused",))
    with pytest.raises(ServeError, match="unknown precision profile"):
        with _engine(pb, warmup=False) as eng:
            eng.submit(_rows(pair[0], 1), profile="bf16")


def test_narrow_tiers_are_built_at_construction(pair, monkeypatch):
    """Every profile's tree and program exists once the backend is built:
    an engine later builds nothing (a cast or quantization failing then
    would not matter)."""
    family, jb, _ = pair
    model = (WideDeep(compute_dtype=torch.float32, device="cpu", **WD_SMALL)
             if family == "wide_deep" else build_mlp(MLP_HIDDEN, device="cpu"))
    pb = NNBackend(model, (11,) if family == "wide_deep" else (10,),
                   compute_dtype=torch.float32, precision="bf16",
                   profiles=("int8w",))
    assert set(pb._serve_params) == set(pb._serve_apply) == {
        "f32", "bf16", "int8w"}

    def refuse(*a, **k):
        raise AssertionError("built lazily")

    monkeypatch.setattr("euromillioner_tpu_torch.serve.session."
                        "quantize_int8w", refuse)
    monkeypatch.setattr("euromillioner_tpu_torch.serve.session.cast_floats",
                        refuse)
    with _engine(pb, profiles=("int8w", "f32")) as eng:
        assert eng.precision == "bf16"
        assert np.isfinite(eng.predict(_rows(family, 3),
                                       profile="int8w")).all()


# -- load_backend and the CLI ------------------------------------------------

@pytest.fixture(scope="module")
def mlp_ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("mlp_ck")
    model = build_mlp(MLP_HIDDEN, generator=torch.Generator().manual_seed(2),
                      device="cpu")
    port_ck.save_checkpoint(str(d), Trainer(model, adam(1e-3)).init_state(),
                            step=1)
    return str(d)


MLP_FLAGS = ["model.hidden_sizes=64,32", "model.compute_dtype=float32"]


@pytest.mark.parametrize("profile", ["f32", *PROFILES])
def test_load_backend_serves_the_mlp_at_each_profile(mlp_ckpt, profile):
    cfg = apply_overrides(Config(), [*MLP_FLAGS,
                                     f"serve.precision={profile}"])
    backend = load_backend("mlp", mlp_ckpt, cfg, device="cpu")
    assert backend.precision == profile and backend.family == "nn"
    x = _rows("mlp", BUCKET, seed=6)
    with _engine(backend) as eng:
        got = eng.predict(x)
    want = backend.predict(x)
    if profile == "f32":
        assert np.array_equal(got, want)
    else:
        assert 0.0 < rel_error(got, want) <= SERVE_ENVELOPES[("nn", profile)]


@pytest.mark.parametrize("argv", [
    ["serve.precision=bf16"], ["serve.precision=int8w"],
    ["serve.profiles=bf16,int8w"]], ids=["bf16", "int8w", "profiles"])
def test_cli_serves_the_mlp(mlp_ckpt, argv, capsys):
    capsys.readouterr()
    assert cli.main(["serve", "--model-type", "mlp", "--checkpoint",
                     mlp_ckpt, "--smoke", "6", "--device", "cpu",
                     *MLP_FLAGS, *argv]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["failed"] == 0
    assert np.isfinite(np.asarray(summary["predictions"])).all()


@pytest.mark.parametrize("profile", PROFILES)
def test_cli_serves_wide_deep_at_narrow_profiles(tmp_path, profile, capsys):
    flags = ["model.wide_deep_target_params=200000", "model.embed_dim=8"]
    cfg = apply_overrides(Config(), flags)
    from euromillioner_tpu_torch.models.registry import build_model

    cfg.model.name = "wide_deep"
    model = build_model(cfg.model, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    port_ck.save_checkpoint(str(tmp_path), Trainer(
        model, adam(1e-3)).init_state(), step=1)
    capsys.readouterr()
    assert cli.main(["serve", "--model-type", "wide_deep", "--checkpoint",
                     str(tmp_path), "--smoke", "4", "--device", "cpu",
                     *flags, f"serve.precision={profile}"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["failed"] == 0
    assert summary["stats"]["precision"]["profile"] == profile
