"""The port's wide one-hot contraction (euromillioner_tpu_torch/ops/
wide_onehot.py, the plain versions of K4a and K4b) against the JAX
package's Pallas pair in interpret mode, on the CPU; and the wrappers'
contract.

The CUDA kernels themselves are held to the plain versions on the card by
chip_smoke.py."""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euromillioner_tpu.ops.wide_onehot import \
    wide_onehot_matmul as jax_wide_onehot_matmul
from euromillioner_tpu_torch.ops import wide_onehot as port
from euromillioner_tpu_torch.utils.errors import ConfigError

torch.set_num_threads(2)

# tests/test_wide_onehot.py's shape: ids over the full vocabulary repeat
# (64 draws from 256 per position)
K, V, E, B = 3, 256, 32, 64
DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]
# ids drawn from V // 8 values repeat ~8 times each: the Pallas dW (an XLA
# dot in interpret mode) then sums a row's terms in another order than the
# batch order. Measured 1.2e-7 of a row's sum of magnitudes in f32 (0 in
# bf16); pinned at ~10x.
HEAVY_REPEAT_TOL = 1e-6


def _case(seed=0, vocab=V):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, size=(B, K)).astype(np.int32)
    w = rng.normal(size=(K, V, E)).astype(np.float32)
    g = rng.normal(size=(B, E)).astype(np.float32)
    return ids, w, g


def _jax_fwd_vjp(w, ids, g, jdt):
    out, vjp = jax.vjp(lambda w_: jax_wide_onehot_matmul(w_, ids),
                       jnp.asarray(w).astype(jdt))
    (dw,) = vjp(jnp.asarray(g))
    return (np.asarray(out),
            np.asarray(dw.astype(jnp.float32)))


@functools.lru_cache(maxsize=None)
def _reference(jdt):
    """The Pallas pair's forward and dW on ``_case()``, once per dtype."""
    ids, w, g = _case()
    return _jax_fwd_vjp(w, jnp.asarray(ids), g, jdt)


@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=["f32", "bf16"])
def test_plain_versions_bit_equal_to_pallas_interpret(jdt, tdt):
    ids, w, g = _case()
    want_out, want_dw = _reference(jdt)
    wt = torch.from_numpy(w).to(tdt)
    out = port.wide_onehot_fwd(wt, torch.from_numpy(ids))
    # _vjp_bwd rounds the f32 cotangent to the table's dtype first
    dw = port.wide_onehot_dw(torch.from_numpy(ids),
                             torch.from_numpy(g).to(tdt), V)
    assert out.dtype == torch.float32 and dw.dtype == tdt
    np.testing.assert_array_equal(out.numpy(), want_out)
    np.testing.assert_array_equal(dw.float().numpy(), want_dw)


@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=["f32", "bf16"])
def test_function_gradient_bit_equal_to_jax_vjp(jdt, tdt):
    ids, w, g = _case()
    want_out, want_dw = _reference(jdt)
    wt = torch.from_numpy(w).to(tdt).requires_grad_()
    out = port.wide_onehot_matmul(wt, torch.from_numpy(ids))
    (grad,) = torch.autograd.grad((out * torch.from_numpy(g)).sum(), [wt])
    np.testing.assert_array_equal(out.detach().numpy(), want_out)
    assert grad.dtype == tdt
    np.testing.assert_array_equal(grad.float().numpy(), want_dw)


@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=["f32", "bf16"])
def test_dw_under_heavy_repeats_within_pin(jdt, tdt):
    ids, w, g = _case(2, vocab=V // 8)
    _, want_dw = _jax_fwd_vjp(w, jnp.asarray(ids), g, jdt)
    ids_t = torch.from_numpy(ids)
    dh = torch.from_numpy(g).to(tdt)
    dw = port.wide_onehot_dw(ids_t, dh, V).float().numpy()
    scale = port.wide_onehot_dw(ids_t, dh.float().abs(), V).numpy()
    err = np.abs(dw - want_dw) / np.maximum(scale, 1e-30)
    assert err.max() <= HEAVY_REPEAT_TOL, err.max()


def test_ids_get_no_gradient():
    ids, w, g = _case(3)
    ids_t = torch.from_numpy(ids)
    ctx = types.SimpleNamespace(saved_tensors=(ids_t,), vocab=V,
                                w_dtype=torch.float32)
    dw, d_ids = port.WideOnehotMatmul.backward(ctx, torch.from_numpy(g))
    assert d_ids is None
    np.testing.assert_array_equal(
        dw.numpy(), port.wide_onehot_dw_reference(ids_t, torch.from_numpy(g),
                                                  V).numpy())
    # the table is not saved for the backward: only the ids are
    wt = torch.from_numpy(w).requires_grad_()
    out = port.wide_onehot_matmul(wt, ids_t)
    assert [t.dtype for t in out.grad_fn.saved_tensors] == [torch.int32]


def test_out_of_range_ids_add_nothing():
    """An id outside [0, V) has an all-zero one-hot row on the TPU; the
    plain versions skip it the same way."""
    ids, w, g = _case(0)
    ids[0, 0], ids[5, 2], ids[9, 1] = -1, V, V + 7
    want_out, want_dw = _jax_fwd_vjp(w, jnp.asarray(ids), g, jnp.float32)
    ids_t = torch.from_numpy(ids)
    np.testing.assert_array_equal(
        port.wide_onehot_fwd(torch.from_numpy(w), ids_t).numpy(), want_out)
    np.testing.assert_array_equal(
        port.wide_onehot_dw(ids_t, torch.from_numpy(g), V).numpy(), want_dw)


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    ids, w, g = _case(5)
    ids_t, w_t, g_t = map(torch.from_numpy, (ids, w, g))
    before = (port.WIDE_ONEHOT_FWD.launches, port.WIDE_ONEHOT_DW.launches)
    out = port.wide_onehot_fwd(w_t, ids_t)
    dw = port.wide_onehot_dw(ids_t, g_t, V)
    assert torch.equal(out, port.wide_onehot_fwd_reference(w_t, ids_t))
    assert torch.equal(dw, port.wide_onehot_dw_reference(ids_t, g_t, V))
    assert (port.WIDE_ONEHOT_FWD.launches,
            port.WIDE_ONEHOT_DW.launches) == before == (0, 0)
    assert not port.WIDE_ONEHOT_FWD.loaded and not port.WIDE_ONEHOT_DW.loaded


@pytest.mark.parametrize("call", ["fwd", "dw", "function"])
def test_unsupported_table_dtype_raises(call):
    ids = torch.zeros((4, K), dtype=torch.int32)
    w = torch.zeros((K, V, E), dtype=torch.float16)
    dh = torch.zeros((4, E), dtype=torch.float16)
    fn = {"fwd": lambda: port.wide_onehot_fwd(w, ids),
          "dw": lambda: port.wide_onehot_dw(ids, dh, V),
          "function": lambda: port.wide_onehot_matmul(w, ids)}[call]
    with pytest.raises(ConfigError, match="float16"):
        fn()


@pytest.mark.parametrize("bad,err", [
    ("ids_dtype", TypeError), ("ids_rank", ValueError),
    ("positions", ValueError), ("dh_rows", ValueError),
    ("meta", ValueError)])
def test_input_checks(bad, err):
    ids = torch.zeros((4, K), dtype=torch.int32)
    w = torch.zeros((K, V, E))
    dh = torch.zeros((4, E))
    if bad == "ids_dtype":
        ids = ids.long()
    elif bad == "ids_rank":
        ids = ids[:, 0]
    elif bad == "positions":
        ids = torch.zeros((4, K + 1), dtype=torch.int32)
    elif bad == "dh_rows":
        dh = dh[:3]
    else:
        ids, w, dh = (t.to("meta") for t in (ids, w, dh))
    with pytest.raises(err):
        if bad == "dh_rows":
            port.wide_onehot_dw(ids, dh, V)
        else:
            port.wide_onehot_fwd(w, ids)


class _CudaTensorLike:
    """What the wrappers read of a tensor, placed on a CUDA device (this
    CPU-only build cannot make a real one)."""

    def __init__(self, shape, dtype):
        self.shape, self.dtype = torch.Size(shape), dtype
        self.device = torch.device("cuda", 0)

    def dim(self):
        return len(self.shape)

    def is_contiguous(self):
        return True


@pytest.mark.parametrize("call", ["fwd", "dw"])
def test_cuda_tensor_without_a_card_raises(call):
    """A CUDA tensor goes to the kernel, never to the plain version: with
    no card the wrapper raises."""
    kernel = port.WIDE_ONEHOT_FWD if call == "fwd" else port.WIDE_ONEHOT_DW
    launches = kernel.launches
    ids = _CudaTensorLike((4, K), torch.int32)
    with pytest.raises((RuntimeError, AssertionError)):
        if call == "fwd":
            port.wide_onehot_fwd(_CudaTensorLike((K, V, E), torch.bfloat16),
                                 ids)
        else:
            port.wide_onehot_dw(ids, _CudaTensorLike((4, E), torch.bfloat16),
                                V)
    assert kernel.launches == launches


class _Addr:
    def __init__(self, ptr):
        self.ptr = ptr

    def data_ptr(self):
        return self.ptr


@pytest.mark.parametrize("e,itemsize,ptr,want", [
    (1040, 2, 256, 8), (1040, 4, 256, 4), (20, 2, 256, 4), (20, 4, 256, 4),
    (300, 2, 256, 4), (7, 2, 256, 1), (1040, 2, 258, 1), (1040, 2, 260, 2)])
def test_vector_width(e, itemsize, ptr, want):
    assert port._vec(e, itemsize, _Addr(ptr)) == want
