"""The serving tiers' param and activation transforms
(euromillioner_tpu_torch/core/precision.py) against the JAX package's on
the same arrays: bit-equal, since every step is one IEEE operation (abs,
max, divide, round half to even, clip, multiply) in the same order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euromillioner_tpu.core import precision as jax_prec
from euromillioner_tpu_torch.core import precision as prec


def _tree(seed=0):
    """A nested JAX-style params tree and the port's flat state dict of
    the same arrays: a zero column (scale floor), a 3-D leaf, vectors."""
    rng = np.random.default_rng(seed)
    tree = {"0_LSTM": {"wx": rng.normal(scale=3, size=(11, 64)),
                       "wh": rng.normal(size=(16, 64)),
                       "bias": rng.normal(size=(64,)),
                       "p_i": rng.normal(size=(16,))},
            "1_Wide": {"table": rng.normal(size=(3, 40, 8))},
            "2_Dense": {"kernel": rng.normal(size=(16, 7))}}
    tree = jax.tree.map(lambda a: a.astype(np.float32), tree)
    tree["0_LSTM"]["wx"][:, 3] = 0.0
    flat = {f"{m}.{n}": torch.from_numpy(a.copy())
            for m, leaves in tree.items() for n, a in leaves.items()}
    return jax.tree.map(jnp.asarray, tree), flat


def _pairs(jtree, flat):
    for m, leaves in jtree.items():
        for n, leaf in leaves.items():
            yield f"{m}.{n}", leaf, flat[f"{m}.{n}"]


@pytest.mark.parametrize("kw", [{"min_size": 16}, {"min_size": 512},
                                {"names": ["2_Dense", "table"]}])
def test_quantize_int8w_bit_equal_to_jax(kw):
    jtree, flat = _tree()
    jq = jax_prec.quantize_int8w(jtree, **kw)
    pq = prec.quantize_int8w(flat, **kw)
    assert set(pq) == set(flat)
    for key, want, got in _pairs(jq, pq):
        assert prec.is_quantized(got) == jax_prec.is_quantized(want), key
        if prec.is_quantized(got):
            assert got[prec.INT8_Q].dtype == torch.int8
            assert got[prec.INT8_SCALE].dtype == torch.float32
            np.testing.assert_array_equal(got[prec.INT8_Q].numpy(),
                                          np.asarray(want[jax_prec.INT8_Q]))
            np.testing.assert_array_equal(
                got[prec.INT8_SCALE].numpy(),
                np.asarray(want[jax_prec.INT8_SCALE]))
        else:
            assert torch.equal(got, flat[key])


@pytest.mark.parametrize("dtype", [(jnp.float32, torch.float32),
                                   (jnp.bfloat16, torch.bfloat16)])
def test_dequantize_int8w_bit_equal_to_jax(dtype):
    jdt, tdt = dtype
    jtree, flat = _tree(1)
    jd = jax_prec.dequantize_int8w(jax_prec.quantize_int8w(jtree,
                                                           min_size=16), jdt)
    pd = prec.dequantize_int8w(prec.quantize_int8w(flat, min_size=16), tdt)
    for key, want, got in _pairs(jd, pd):
        assert got.dtype == tdt, key
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", [(jnp.float32, torch.float32),
                                   (jnp.bfloat16, torch.bfloat16)])
def test_fake_quant_int8_bit_equal_to_jax(dtype):
    jdt, tdt = dtype
    x = np.random.default_rng(2).normal(size=(4, 8, 11)).astype(np.float32)
    want = jax_prec.fake_quant_int8(jnp.asarray(x).astype(jdt))
    got = prec.fake_quant_int8(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    # an all-zero block stays zero (the scale's 1e-12 floor)
    assert not prec.fake_quant_int8(torch.zeros(3, dtype=tdt)).any()


def test_cast_floats_casts_float_leaves_only():
    _, flat = _tree()
    flat["step"] = torch.tensor(3, dtype=torch.int32)
    out = prec.cast_floats(flat, torch.bfloat16)
    assert out["step"] is flat["step"]
    for k, v in out.items():
        if k != "step":
            assert v.dtype == torch.bfloat16
            assert torch.equal(v, flat[k].to(torch.bfloat16))
