"""The port's GBT histogram (euromillioner_tpu_torch/ops/fused_histogram.py,
K3's plain version) against the JAX package's scatter formulation and its
Pallas kernel in interpret mode, on the CPU; and the wrapper's contract.

The CUDA kernel itself is held to the plain version on the card by
chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euromillioner_tpu.ops.fused_histogram import \
    fused_histogram as jax_fused_histogram
from euromillioner_tpu.trees import growth as jax_growth
from euromillioner_tpu_torch.ops import fused_histogram as port

torch.set_num_threads(2)

# one compiled program per shape (eager dispatch compiles every op apart)
jax_scatter = jax.jit(jax_growth._node_histograms_scatter,
                      static_argnums=(5, 6))
jax_pallas = jax.jit(jax_fused_histogram, static_argnums=(4, 5))

# the five shapes of tests/test_fused_histogram.py, the reference pipeline's
# deepest split level, and one bin count above the TPU kernel's 256 cap
SHAPES = [(1000, 6, 37, 4), (1500, 6, 37, 4), (1024, 3, 128, 1),
          (2048, 8, 256, 8), (100, 2, 5, 2), (1193, 10, 44, 8),
          (3000, 4, 300, 4)]
# interpret mode is slow: the small shapes only
INTERPRET_SHAPES = [(1000, 6, 37, 4), (100, 2, 5, 2)]


def _case(n, f, n_bins, n_nodes, seed=0):
    rng = np.random.default_rng(seed)
    binned = rng.integers(0, n_bins, size=(n, f)).astype(np.int32)
    local = rng.integers(0, n_nodes, size=n).astype(np.int32)
    grad = rng.normal(size=n).astype(np.float32)
    hess = rng.uniform(0.1, 1.0, size=n).astype(np.float32)
    weight = rng.integers(0, 2, size=n).astype(np.float32)
    return binned, local, weight, grad, hess


def _port(binned, local, weight, grad, hess, n_bins, n_nodes):
    return port.fused_histogram(
        torch.from_numpy(binned), torch.from_numpy(local),
        torch.from_numpy(grad * weight), torch.from_numpy(hess * weight),
        n_bins, n_nodes).numpy()


@pytest.mark.parametrize("n,f,n_bins,n_nodes", SHAPES)
def test_plain_version_bit_equal_to_jax_scatter(n, f, n_bins, n_nodes):
    """index_add_ over the flat (node, feature, bin) index adds in the
    same row order as the JAX scatter: the sums agree bit for bit."""
    binned, local, weight, grad, hess = _case(n, f, n_bins, n_nodes)
    g_ref, h_ref = jax_scatter(
        *map(jnp.asarray, (binned, local, weight, grad, hess)),
        n_nodes, n_bins)
    hist = _port(binned, local, weight, grad, hess, n_bins, n_nodes)
    assert hist.shape == (f, 2 * n_nodes, n_bins)
    per_node = hist.reshape(f, n_nodes, 2, n_bins).transpose(1, 0, 2, 3)
    np.testing.assert_array_equal(per_node[:, :, 0], np.asarray(g_ref))
    np.testing.assert_array_equal(per_node[:, :, 1], np.asarray(h_ref))


@pytest.mark.parametrize("n,f,n_bins,n_nodes", INTERPRET_SHAPES)
def test_plain_version_matches_pallas_kernel(n, f, n_bins, n_nodes):
    """Against the Pallas kernel (interpret mode) in its own layout; the
    tolerance is that of its bf16 hi/lo split (tests/test_fused_histogram
    .py)."""
    binned, local, weight, grad, hess = _case(n, f, n_bins, n_nodes, seed=1)
    want = jax_pallas(
        jnp.asarray(binned), jnp.asarray(local), jnp.asarray(grad * weight),
        jnp.asarray(hess * weight), n_bins, n_nodes)
    got = _port(binned, local, weight, grad, hess, n_bins, n_nodes)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-4)


def test_out_of_range_nodes_and_bins_add_nothing():
    """Rows routed outside [0, n_nodes) or binned outside [0, n_bins) are
    ignored by the kernel; the plain version agrees where indices are in
    range, and zero weights make padded rows inert."""
    binned = torch.tensor([[3, 1], [3, 1], [0, 4]], dtype=torch.int32)
    local = torch.tensor([0, 1, 1], dtype=torch.int32)
    gw = torch.tensor([1.0, 2.0, 0.0])
    hw = torch.tensor([10.0, 20.0, 0.0])
    hist = port.fused_histogram(binned, local, gw, hw, 5, 2)
    assert hist.shape == (2, 4, 5)
    assert hist[0, 0, 3] == 1.0 and hist[0, 1, 3] == 10.0
    assert hist[0, 2, 3] == 2.0 and hist[0, 3, 3] == 20.0
    assert hist.sum() == 66.0


@pytest.mark.parametrize("n,f,n_bins,n_nodes", [
    (1193, 10, 44, 1), (1193, 10, 44, 8), (200_000, 28, 256, 1),
    (200_000, 28, 256, 64), (3000, 4, 300, 4), (10, 3, 5000, 2)])
def test_launch_plan_fits_the_card(n, f, n_bins, n_nodes):
    """Every block's four warp copies fit the shared-memory budget, every
    chunk holds at least _MIN_CHUNK_ROWS rows (or all of them), and the
    grid stays near its target."""
    chunks, node_tile, bin_tile = port.launch_plan(n, f, n_bins, n_nodes)
    assert 1 <= node_tile <= n_nodes and 1 <= bin_tile <= n_bins
    assert 4 * port._WARPS * node_tile * 2 * bin_tile <= port._SMEM_BYTES
    assert chunks == 1 or -(-n // chunks) >= port._MIN_CHUNK_ROWS
    tiles = -(-n_nodes // node_tile) * -(-n_bins // bin_tile)
    assert chunks <= max(1, -(-port._TARGET_BLOCKS // (f * tiles)))


@pytest.mark.parametrize("bad,err", [
    ("binned_dtype", TypeError), ("gw_dtype", TypeError),
    ("local_shape", ValueError), ("binned_rank", ValueError)])
def test_wrapper_checks_its_inputs(bad, err):
    binned = torch.zeros((4, 2), dtype=torch.int32)
    local = torch.zeros(4, dtype=torch.int32)
    gw = hw = torch.zeros(4)
    if bad == "binned_dtype":
        binned = binned.long()
    elif bad == "gw_dtype":
        gw = gw.double()
    elif bad == "local_shape":
        local = local[:3]
    else:
        binned = binned[:, 0]
    with pytest.raises(err):
        port.fused_histogram(binned, local, gw, hw, 3, 1)


def test_other_devices_raise_instead_of_falling_back():
    args = [torch.empty((4, 2), dtype=torch.int32, device="meta"),
            torch.empty(4, dtype=torch.int32, device="meta"),
            torch.empty(4, device="meta"), torch.empty(4, device="meta")]
    with pytest.raises(ValueError, match="unsupported device"):
        port.fused_histogram(*args, 3, 1)


class _CudaTensorLike:
    """What the wrapper reads of a tensor, placed on a CUDA device (this
    CPU-only build cannot make a real one)."""

    def __init__(self, shape, dtype):
        self.shape, self.dtype = torch.Size(shape), dtype
        self.device = torch.device("cuda", 0)

    def dim(self):
        return len(self.shape)

    def is_contiguous(self):
        return True


def test_cuda_tensor_without_a_card_raises():
    """A CUDA tensor goes to the kernel, never to the plain version: with
    no card the launch raises."""
    launches = port.FUSED_HISTOGRAM.launches
    args = [_CudaTensorLike((4, 2), torch.int32),
            _CudaTensorLike((4,), torch.int32),
            _CudaTensorLike((4,), torch.float32),
            _CudaTensorLike((4,), torch.float32)]
    with pytest.raises((RuntimeError, AssertionError)):
        port.fused_histogram(*args, 3, 1)
    assert port.FUSED_HISTOGRAM.launches == launches


# -- the set form (the random forest's one launch per level) -----------------

def _sets_case(n, f, n_bins, n_nodes, sets, seed=0):
    rng = np.random.default_rng(seed)
    binned = rng.integers(0, n_bins, size=(n, f)).astype(np.int32)
    local = rng.integers(0, n_nodes, size=(sets, n)).astype(np.int32)
    gw = (rng.poisson(1.0, size=(sets, n))
          * rng.integers(0, 2, size=(sets, n))).astype(np.float32)
    hw = rng.normal(size=(sets, n)).astype(np.float32)
    return [torch.from_numpy(a) for a in (binned, local, gw, hw)]


@pytest.mark.parametrize("n,f,n_bins,n_nodes,sets", [
    (1000, 6, 37, 4, 3), (1193, 10, 33, 8, 6), (100, 2, 5, 1, 1),
    (300, 4, 300, 2, 5), (50, 3, 8, 2, 0)])
def test_set_form_plain_version_equals_per_set_calls(n, f, n_bins, n_nodes,
                                                     sets):
    """Set s of the set form is fused_histogram on set s's inputs, bit for
    bit (integer counts in one slot, normal values in the other)."""
    binned, local, gw, hw = _sets_case(n, f, n_bins, n_nodes, sets)
    got = port.fused_histogram_sets(binned, local, gw, hw, n_bins, n_nodes)
    assert got.shape == (sets, f, 2 * n_nodes, n_bins)
    assert got.dtype == torch.float32
    for s in range(sets):
        want = port.fused_histogram(binned, local[s], gw[s], hw[s], n_bins,
                                    n_nodes)
        assert torch.equal(got[s], want)


@pytest.mark.parametrize("bad,err", [
    ("one_set_local", ValueError), ("rows", ValueError),
    ("gw_sets", ValueError), ("hw_dtype", TypeError)])
def test_set_form_checks_its_inputs(bad, err):
    binned, local, gw, hw = _sets_case(8, 2, 3, 1, 2)
    if bad == "one_set_local":
        local = local[0]
    elif bad == "rows":
        local, gw, hw = local[:, :7], gw[:, :7], hw[:, :7]
    elif bad == "gw_sets":
        gw = gw[:1]
    else:
        hw = hw.double()
    with pytest.raises(err):
        port.fused_histogram_sets(binned, local, gw, hw, 3, 1)


def test_set_form_on_a_cuda_tensor_without_a_card_raises():
    """The set form's CUDA tensors go to its kernel (its own launch
    counter), never to the plain version."""
    launches = (port.FUSED_HISTOGRAM_SETS.launches,
                port.FUSED_HISTOGRAM.launches)
    args = [_CudaTensorLike((4, 2), torch.int32),
            _CudaTensorLike((3, 4), torch.int32),
            _CudaTensorLike((3, 4), torch.float32),
            _CudaTensorLike((3, 4), torch.float32)]
    with pytest.raises((RuntimeError, AssertionError)):
        port.fused_histogram_sets(*args, 3, 1)
    assert (port.FUSED_HISTOGRAM_SETS.launches,
            port.FUSED_HISTOGRAM.launches) == launches
