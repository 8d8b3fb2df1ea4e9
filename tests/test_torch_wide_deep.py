"""The port's Wide&Deep (euromillioner_tpu_torch/models/wide_deep.py)
against the JAX package's, on the CPU, at the JAX tests' tiny config: the
cross ids, the size arithmetic at the 100M default, the forward against
both JAX formulations (the XLA one-hot path and the fused kernel path in
interpret mode), the gradients, one Adam step through each package's
Trainer (the bf16 one on a year-2004 row, which the input cast would
alias), and TrainState checkpoints both ways."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import euromillioner_tpu.ops.wide_onehot as jax_wide_onehot
from euromillioner_tpu.core.precision import Precision as JaxPrecision
from euromillioner_tpu.data.dataset import Batch as JaxBatch
from euromillioner_tpu.models.wide_deep import \
    build_wide_deep as jax_build_wide_deep
from euromillioner_tpu.nn.module import param_count
from euromillioner_tpu.train.checkpoint import \
    load_checkpoint as jax_load_checkpoint
from euromillioner_tpu.train.checkpoint import \
    save_checkpoint as jax_save_checkpoint
from euromillioner_tpu.train.optim import adam as jax_adam
from euromillioner_tpu.train.trainer import Trainer as JaxTrainer
from euromillioner_tpu_torch.core.precision import Precision
from euromillioner_tpu_torch.data.dataset import Batch
from euromillioner_tpu_torch.models import wide_deep as port
from euromillioner_tpu_torch.models.convert import (params_from_jax,
                                                    params_to_numpy)
from euromillioner_tpu_torch.models.lstm import build_lstm
from euromillioner_tpu_torch.train import checkpoint as port_ck
from euromillioner_tpu_torch.train.optim import adam
from euromillioner_tpu_torch.train.trainer import Trainer
from euromillioner_tpu_torch.utils.errors import ConfigError

torch.set_num_threads(2)

TINY = {"target_params": 300_000, "embed_dim": 8, "hidden_sizes": (16,)}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# bf16 towers: the forward measured bit-equal to the JAX package's at both
# ball vocabularies; pinned at one bf16 ulp of the output's scale
BF16_FWD_TOL = 2.0 ** -8
# one bf16 Adam step: loss measured 6.2e-8 relative (pin 1e-6); updated
# params 2.4e-5 of their scale (pin 1e-4); the first moments, (1 - b1) x
# the gradient, 7.7e-3 of their scale where a bias gradient's batch sum
# rounds to bf16 one ulp apart (pin two bf16 ulps, 2^-6)
BF16_STEP_TOL = {"loss": 1e-6, "params": 1e-4, "mu": 2.0 ** -6}


def _rows(b, seed=1):
    """Featurized rows as bench.py draws them: dow, month, day, year
    2004-2020, five balls 1-50, two stars 1-12."""
    rng = np.random.default_rng(seed)
    x = np.concatenate([
        np.stack([rng.integers(1, 8, b), rng.integers(1, 13, b),
                  rng.integers(1, 29, b), rng.integers(2004, 2021, b)], 1),
        rng.integers(1, 51, size=(b, 5)), rng.integers(1, 13, size=(b, 2)),
    ], axis=1).astype(np.float32)
    x[0, 3] = 2004.0  # bf16 holds it as 2000: a cast before lookup aliases
    return x


@functools.lru_cache(maxsize=None)
def _jax_init(ball_vocab):
    jm = jax_build_wide_deep(ball_vocab=ball_vocab, **TINY)
    init = jax.jit(lambda key: jm.init(key, (11,))[0])
    return jax.device_get(init(jax.random.PRNGKey(0)))


def _pair(dtype="f32", ball_vocab=64):
    """(jax model, jax params, port model holding the same params)."""
    jdt, tdt = DTYPES[dtype]
    jm = jax_build_wide_deep(ball_vocab=ball_vocab, compute_dtype=jdt, **TINY)
    params = _jax_init(ball_vocab)
    tm = port.build_wide_deep(ball_vocab=ball_vocab, compute_dtype=tdt,
                              device="cpu", **TINY)
    tm.load_state_dict(params_from_jax(params, device="cpu"))
    return jm, params, tm


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


@pytest.mark.parametrize("ball_vocab", [16, 64])
def test_cross_ids_bit_equal(ball_vocab):
    jm, _, tm = _pair(ball_vocab=ball_vocab)
    rng = np.random.default_rng(7)
    x = np.concatenate([_rows(40), rng.normal(0, 40, size=(24, 11))]
                       ).astype(np.float32)  # negatives and values past V
    want = jax.jit(jm._cross_ids)(jnp.asarray(x))
    got = tm._cross_ids(torch.from_numpy(x))
    for w, g in zip(want, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (tm.pair_vocab, tm.date_vocab, tm.num_crosses, tm.wide_buckets) == (
        jm.pair_vocab, jm.date_vocab, jm.num_crosses, jm.wide_buckets)


def test_size_arithmetic_at_the_100m_default():
    """The E solve and the count at the flagship size, without building
    it: E = 1040, 99,919,262 parameters, as the JAX package solves."""
    assert port.solve_wide_embed_dim() == 1040
    assert jax_build_wide_deep().wide_embed_dim == 1040
    assert port.wide_deep_param_count(1040) == 99_919_262
    assert port.solve_wide_embed_dim(300_000, embed_dim=8,
                                     hidden_sizes=(16,)) == 8


@pytest.mark.parametrize("ball_vocab", [16, 64])
def test_tiny_config_matches_jax_in_size(ball_vocab):
    jm, params, tm = _pair(ball_vocab=ball_vocab)
    assert tm.wide_embed_dim == jm.wide_embed_dim
    shapes = {k: v.shape for k, v in _flat(params).items()}
    assert {k: tuple(v.shape) for k, v in tm.state_dict().items()} == shapes
    n = sum(p.numel() for p in tm.parameters())
    assert n == param_count(params) == port.wide_deep_param_count(
        tm.wide_embed_dim, 8, ball_vocab, (16,), 7)


@pytest.fixture
def force_fused(monkeypatch):
    """The JAX model's fused kernel path, in interpret mode (as
    tests/test_wide_onehot.py forces it)."""
    monkeypatch.setattr(jax_wide_onehot, "fused_wide_available",
                        lambda *a, **k: True)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("ball_vocab", [16, 64])
@pytest.mark.parametrize("jax_path", ["xla", "fused"])
def test_forward_matches_jax(request, dtype, ball_vocab, jax_path):
    jm, params, tm = _pair(dtype, ball_vocab)
    x = _rows(32)
    if jax_path == "fused":
        request.getfixturevalue("force_fused")
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x))
                      .astype(jnp.float32))
    got = tm.apply(torch.from_numpy(x)).float().detach().numpy()
    assert got.shape == (32, 7)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        assert np.abs(got - want).max() <= BF16_FWD_TOL * np.abs(want).max()


def test_forward_flattens_leading_dims():
    _, _, tm = _pair()
    x = torch.from_numpy(_rows(12))
    np.testing.assert_array_equal(
        tm.apply(x.reshape(3, 4, 11)).detach().numpy(),
        tm.apply(x).reshape(3, 4, 7).detach().numpy())


def test_gradients_match_jax_grad():
    jm, params, tm = _pair()
    x, y = _rows(16), np.random.default_rng(2).normal(size=(16, 7))
    y = y.astype(np.float32)

    def loss(p):
        return jnp.mean((jm.apply(p, jnp.asarray(x)) - y) ** 2)

    want = _flat(jax.device_get(jax.jit(jax.grad(loss))(params)))
    named = dict(tm.named_parameters())
    out = tm.apply(torch.from_numpy(x))
    grads = torch.autograd.grad(((out - torch.from_numpy(y)) ** 2).mean(),
                                list(named.values()))
    for (k, _), g in zip(named.items(), grads):
        np.testing.assert_allclose(g.numpy(), want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


@functools.lru_cache(maxsize=None)
def _steps(dtype):
    """One Adam step from the same params and batch through each package's
    Trainer: (jax state, jax loss, port state, port loss). Callers only
    read the result."""
    jdt, tdt = DTYPES[dtype]
    jm = jax_build_wide_deep(compute_dtype=jdt, **TINY)
    jt = JaxTrainer(jm, jax_adam(1e-3), precision=JaxPrecision(
        compute_dtype=jdt))
    state = jt.init_state(jax.random.PRNGKey(0), (11,))
    x = _rows(16)
    y = np.random.default_rng(3).normal(size=(16, 7)).astype(np.float32)
    mask = np.ones(16, np.float32)
    jnew, jloss = jax.jit(jt._step)(
        state, JaxBatch(*map(jnp.asarray, (x, y, mask))),
        jax.random.PRNGKey(1))
    tm = port.build_wide_deep(compute_dtype=tdt, device="cpu", **TINY)
    tt = Trainer(tm, adam(1e-3), precision=Precision(compute_dtype=tdt))
    tstate = tt.init_state(params_from_jax(jax.device_get(state.params),
                                           device="cpu"))
    tnew, tloss = tt.train_step(tstate, Batch(*map(torch.from_numpy,
                                                   (x, y, mask))))
    return jax.device_get(jnew), float(jloss), tnew, float(tloss)


def test_trainer_step_matches_jax_step_f32():
    jnew, jloss, tnew, tloss = _steps("f32")
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    for name, tree in (("params", tnew.params), ("mu", tnew.opt_state["mu"]),
                       ("nu", tnew.opt_state["nu"])):
        want = _flat(jnew.params if name == "params" else jnew.opt_state[name])
        for k, v in tree.items():
            np.testing.assert_allclose(v.numpy(), want[k], rtol=1e-5,
                                       atol=1e-7, err_msg=f"{name} {k}")


def test_trainer_step_bf16_on_a_year_2004_row_matches_jax_step():
    """The bf16 towers read the year uncast (cast_inputs = False): the
    step matches the JAX Trainer's within the pinned bf16 tolerances."""
    jnew, jloss, tnew, tloss = _steps("bf16")
    assert abs(tloss - jloss) <= BF16_STEP_TOL["loss"] * abs(jloss)
    for name, tree in (("params", tnew.params), ("mu", tnew.opt_state["mu"])):
        want = _flat(jnew.params if name == "params" else jnew.opt_state[name])
        for k, v in tree.items():
            err = np.abs(v.numpy() - want[k]).max()
            assert err <= BF16_STEP_TOL[name] * np.abs(want[k]).max(), (name,
                                                                        k, err)


def test_trainer_casts_inputs_only_for_models_that_ask():
    x = torch.tensor([[2004.0] * 11])
    wd = Trainer(port.build_wide_deep(device="cpu", **TINY), adam(1e-3),
                 precision=Precision(compute_dtype=torch.bfloat16))
    assert wd._cast_x(x) is x
    lstm = Trainer(build_lstm(8, 1, 7, device="cpu"), adam(1e-3),
                   precision=Precision(compute_dtype=torch.bfloat16))
    cast = lstm._cast_x(x)
    assert cast.dtype == torch.bfloat16 and float(cast[0, 0]) == 2000.0


def test_unsupported_compute_dtype_raises():
    with pytest.raises(ConfigError, match="float16"):
        port.build_wide_deep(compute_dtype=torch.float16, device="cpu",
                             **TINY)


def test_jax_train_state_restores_in_the_port(tmp_path):
    jnew, _, _, _ = _steps("f32")
    jax_save_checkpoint(str(tmp_path), jnew, step=1)
    tm = port.build_wide_deep(compute_dtype=torch.float32, device="cpu",
                              **TINY)
    trainer = Trainer(tm, adam(1e-3), precision=Precision(
        compute_dtype=torch.float32))
    path = port_ck.latest_checkpoint(str(tmp_path))
    restored = port_ck.load_train_state(path, trainer.init_state())
    for name, tree in (("params", restored.params),
                       ("mu", restored.opt_state["mu"]),
                       ("nu", restored.opt_state["nu"])):
        want = _flat(jnew.params if name == "params" else jnew.opt_state[name])
        assert set(tree) == set(want)
        for k, v in tree.items():
            np.testing.assert_array_equal(v.numpy(), want[k])
    assert int(restored.step) == int(restored.opt_state["count"]) == 1
    # the serving restore reads the same params
    params = port_ck.load_checkpoint(path)
    for k, v in params.items():
        np.testing.assert_array_equal(v.numpy(), _flat(jnew.params)[k])


def test_port_train_state_loads_in_jax(tmp_path):
    _, _, tnew, _ = _steps("f32")
    path = port_ck.save_checkpoint(str(tmp_path), tnew, step=1)
    jm = jax_build_wide_deep(compute_dtype=jnp.float32, **TINY)
    jt = JaxTrainer(jm, jax_adam(1e-3), precision=JaxPrecision(
        compute_dtype=jnp.float32))
    like = jax.eval_shape(lambda: jt.init_state(jax.random.PRNGKey(5),
                                                (11,)))
    got = jax.device_get(jax_load_checkpoint(path, like))
    for k, v in _flat(got.params).items():
        np.testing.assert_array_equal(v, tnew.params[k].numpy())
    for moment in ("mu", "nu"):
        for k, v in _flat(got.opt_state[moment]).items():
            np.testing.assert_array_equal(v, tnew.opt_state[moment][k].numpy())
    assert int(got.opt_state["count"]) == 1 and int(got.step) == 1
    assert params_to_numpy(tnew.params).keys() == got.params.keys()
