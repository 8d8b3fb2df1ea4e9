"""The port's LSTM layer and lstm model helpers against the JAX package's,
on the same weights (initialised in JAX, carried across with
models/convert.params_from_jax) and the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euromillioner_tpu.models import lstm as jax_lstm
from euromillioner_tpu.nn.recurrent import LSTM as JaxLSTM
from euromillioner_tpu_torch.models import lstm as port_lstm
from euromillioner_tpu_torch.models.convert import (params_from_jax,
                                                    params_to_numpy)
from euromillioner_tpu_torch.nn.recurrent import LSTM

torch.set_num_threads(2)

# f32 on both sides; summation order of the GEMMs differs between XLA CPU
# and PyTorch CPU. Measured max abs diff 1.2e-7 (LSTM.apply, h8 and h128,
# 9 steps); pinned at the JAX package's NN trajectory pin.
ATOL = 1e-6
RTOL = 1e-5
FEAT = 11


def _pair(hidden, peepholes=True, return_sequences=True, feat=FEAT):
    """(JAX layer, its params, port layer holding the same weights)."""
    jl = JaxLSTM(hidden, return_sequences=return_sequences,
                 peepholes=peepholes, fused="off")
    params, _ = jl.init(jax.random.PRNGKey(hidden), (6, feat))
    tl = LSTM(feat, hidden, return_sequences=return_sequences,
              peepholes=peepholes, generator=torch.Generator(),
              device="cpu")
    tl.load_state_dict(params_from_jax(jax.device_get(params), "cpu"))
    return jl, params, tl


def _x(batch, steps, feat=FEAT, seed=0):
    return np.random.default_rng(seed).normal(
        size=(batch, steps, feat)).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("hidden", [8, 128])
@pytest.mark.parametrize("return_sequences", [True, False])
def test_apply_matches_jax(hidden, return_sequences):
    jl, params, tl = _pair(hidden, return_sequences=return_sequences)
    x = _x(16, 9)
    _close(tl.apply(torch.from_numpy(x)), jl.apply(params, jnp.asarray(x)))


@pytest.mark.parametrize("hidden", [8, 128])
def test_scan_with_state_matches_jax(hidden):
    jl, params, tl = _pair(hidden)
    x = _x(16, 7, seed=1)
    rng = np.random.default_rng(2)
    h0, c0 = (rng.normal(scale=0.5, size=(16, hidden)).astype(np.float32)
              for _ in range(2))
    (hj, cj), yj = jl.scan_with_state(params, jnp.asarray(x),
                                      (jnp.asarray(h0), jnp.asarray(c0)))
    (ht, ct), yt = tl.scan_with_state(
        torch.from_numpy(x), (torch.from_numpy(h0), torch.from_numpy(c0)))
    for got, want in ((ht, hj), (ct, cj), (yt, yj)):
        _close(got, want)


@pytest.mark.parametrize("hidden", [8, 128])
def test_fused_sequence_matches_jax(hidden):
    """The port's fused_sequence (the kernel's plain version on the CPU)
    against the JAX package's: its Pallas kernel in interpret mode where
    the shapes tile (h128), else the scan it is pinned to (h8)."""
    jl, params, tl = _pair(hidden, peepholes=hidden == 128)
    x = _x(16, 5, seed=3)
    if hidden % 128 == 0:
        want = jl.fused_sequence(params, jnp.asarray(x))
    else:
        want = jl.apply(params, jnp.asarray(x))
    _close(tl.fused_sequence(torch.from_numpy(x)), want)


def _model_pair(hidden=8, layers=2):
    jm = jax_lstm.build_lstm(hidden=hidden, num_layers=layers, out_dim=7,
                             fused="off")
    params, _ = jm.init(jax.random.PRNGKey(7), (16, FEAT))
    tm = port_lstm.build_lstm(hidden, layers, 7, device="cpu")
    tm.load_state_dict(params_from_jax(jax.device_get(params), "cpu"))
    return jm, params, tm


@pytest.mark.parametrize("fused", [False, True])
def test_padded_apply_ragged_matches_jax(fused):
    jm, params, tm = _model_pair()
    x = _x(8, 16, seed=4)
    last = np.array([15, 0, 3, 7, 11, 1, 8, 14], np.int32)
    want = jax_lstm.padded_apply(jm, params, jnp.asarray(x),
                                 jnp.asarray(last))
    got = port_lstm.padded_apply(tm, torch.from_numpy(x),
                                 torch.from_numpy(last), fused=fused)
    assert tuple(got.shape) == (8, 7)
    _close(got, want)


def test_padded_apply_equals_natural_length_rows():
    """Padding never reaches a row's output: each row equals the model
    applied to that row alone at its true length."""
    _, _, tm = _model_pair()
    x = torch.from_numpy(_x(4, 12, seed=5))
    last = [11, 2, 6, 0]
    got = port_lstm.padded_apply(tm, x, last)
    for i, li in enumerate(last):
        torch.testing.assert_close(got[i], tm.apply(x[i:i + 1, :li + 1])[0],
                                   rtol=RTOL, atol=ATOL)


def test_whole_model_matches_jax_apply():
    jm, params, tm = _model_pair(hidden=16)
    x = _x(5, 10, seed=6)
    _close(tm.apply(torch.from_numpy(x)), jm.apply(params, jnp.asarray(x)))


def test_make_sequences_equal_exactly():
    feats = np.random.default_rng(8).integers(
        1, 50, size=(40, 11)).astype(np.float32)
    for seq_len in (1, 8, 39):
        xj, yj = jax_lstm.make_sequences(feats, seq_len)
        xt, yt = port_lstm.make_sequences(feats, seq_len)
        assert xt.dtype == xj.dtype and yt.dtype == yj.dtype
        np.testing.assert_array_equal(xt, xj)
        np.testing.assert_array_equal(yt, yj)
    with pytest.raises(ValueError):
        port_lstm.make_sequences(feats, 40)


def test_param_names_and_shapes_match_jax_init():
    """Initialisers match the JAX package in names and shapes (values come
    from different generators)."""
    jm, params, _ = _model_pair(hidden=32, layers=2)
    tm = port_lstm.build_lstm(32, 2, 7, device="cpu")
    want = jax.tree.map(lambda a: np.asarray(a).shape,
                        jax.device_get(params))
    got = jax.tree.map(lambda a: a.shape, params_to_numpy(tm))
    assert got == want


def test_initialiser_distributions():
    tm = port_lstm.build_lstm(64, 1, 7, device="cpu",
                              generator=torch.Generator().manual_seed(1))
    layer = tm.get_submodule("0_LSTM")
    wh = layer.wh.detach()
    # orthogonal (H, 4H): orthonormal rows
    torch.testing.assert_close(wh @ wh.T, torch.eye(64), rtol=0, atol=1e-5)
    # glorot uniform bound, forget bias 1.0 in [H:2H], small peepholes
    assert float(layer.wx.detach().abs().max()) <= np.sqrt(6.0 / (FEAT + 256))
    bias = layer.bias.detach()
    assert bool((bias[64:128] == 1).all()) and float(bias.abs().sum()) == 64
    assert 0.005 < float(layer.p_i.detach().std()) < 0.02


def test_same_seed_same_weights_on_any_device_arg():
    a = port_lstm.build_lstm(8, 1, 7, device="cpu",
                             generator=torch.Generator().manual_seed(3))
    b = port_lstm.build_lstm(8, 1, 7, device=torch.device("cpu"),
                             generator=torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)


def test_params_round_trip_through_numpy():
    _, params, tm = _model_pair()
    back = params_to_numpy(tm)
    flat_want = jax.tree_util.tree_leaves_with_path(jax.device_get(params))
    assert len(flat_want) == len(tm.state_dict())
    for path, leaf in flat_want:
        node = back
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
