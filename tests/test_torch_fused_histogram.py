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


# the launch shapes of the main paths: the reference pipeline's levels, the
# scaled GBT's, the random forest's levels 0-8 (RF_SHAPE) and the CLI
# forest's deepest, the bin counts above 256, a level cut into bin tiles,
# levels of depth 14 and 15 (cut into one-bin tiles, and into node tiles),
# and an empty input
PLAN_SHAPES = (
    [(1193, 10, 44, 1 << d) for d in range(4)]
    + [(200_000, 28, 256, 1 << d) for d in range(7)]
    + [(100_000, 28, 32, 1 << d) for d in range(9)]
    + [(1193, 10, 32, 256), (50_000, 8, 300, 4), (50_000, 8, 256, 128),
       (3000, 4, 300, 4), (10, 3, 5000, 2), (0, 3, 8, 2),
       (50_000, 8, 256, 1 << 14), (50_000, 8, 32, 1 << 15),
       (200_000, 28, 256, 1 << 15), (100_000, 28, 32, 1 << 15)])
PLAN_SETS = (1, 2, 20, 40, 300)


@pytest.mark.parametrize("n,f,n_bins,n_nodes", PLAN_SHAPES)
def test_launch_plan_fits_the_card(n, f, n_bins, n_nodes):
    """Every block's tiles, staged rows and split fit the 227 KB a block
    may use, at any set count; the tiles cut the bins and the features
    into whole tiles and groups; copies x owners divides the warps and
    fills them when there are several owners; every chunk holds at least
    _MIN_CHUNK_ROWS rows (or all of them)."""
    for sets in PLAN_SETS:
        plan = port.launch_plan(n, f, n_bins, n_nodes, sets)
        assert port.smem_bytes(plan) <= 227 * 1024
        assert 1 <= plan.sets <= sets
        assert plan.rows % 32 == 0 and 32 <= plan.rows <= port._MAX_ROWS
    plan = port.launch_plan(n, f, n_bins, n_nodes)
    assert 1 <= plan.bin_tile <= n_bins and 1 <= plan.features <= f
    assert 1 <= plan.node_tile <= n_nodes
    # nodes are cut into tiles only where one bin of all of them does not fit
    assert plan.node_tile == n_nodes or plan.bin_tile == n_bins
    warps = plan.copies * plan.owners
    assert port._WARPS % warps == 0
    assert (plan.owners == 1 and not plan.by_feature) \
        or warps == port._WARPS
    assert plan.chunks == 1 or -(-n // plan.chunks) >= port._MIN_CHUNK_ROWS


@pytest.mark.parametrize("n,f,n_bins,n_nodes", PLAN_SHAPES)
def test_launch_plan_gives_each_cell_one_owner(n, f, n_bins, n_nodes):
    """Walked from the warps' side as the kernel lays them out (warp w is
    feature slot w % slots of owner w // slots % owners of copy
    w // (slots * owners); an owner takes the nodes of its node tile whose
    place in the tile is equal to it modulo owners, or, with one feature in
    the block and the lanes on rows, the cells whose id ^ (id >> log2
    owners) is), every (node, bin) cell of every feature of a block has
    exactly one owner in each copy, for a full and the last feature group,
    bin tile and node tile; the tiles and feature groups cover each node,
    bin and feature once."""
    plan = port.launch_plan(n, f, n_bins, n_nodes)
    slots = port._WARPS // (plan.copies * plan.owners)
    shift = plan.owners.bit_length() - 1

    def last(size, tile):
        return size - (-(-size // tile) - 1) * tile

    for nk in {plan.node_tile, last(n_nodes, plan.node_tile)}:
        for nb in {plan.bin_tile, last(n_bins, plan.bin_tile)}:
            node = np.arange(nk)[:, None]
            cell = node * nb + np.arange(nb)[None, :]
            for nf in {plan.features, last(f, plan.features)}:
                by_cell = nf == 1 and not plan.by_feature
                owner = (cell ^ (cell >> shift) if by_cell
                         else np.broadcast_to(node, cell.shape)) % plan.owners
                count = np.zeros((plan.copies, nf, nk, nb), np.int64)
                for w in range(port._WARPS):
                    slot, o, c = (w % slots, w // slots % plan.owners,
                                  w // (slots * plan.owners))
                    for j in range(slot, nf, slots):
                        count[c, j] += owner == o
                assert (count == 1).all()
    for size, tile in ((n_nodes, plan.node_tile), (n_bins, plan.bin_tile),
                       (f, plan.features)):
        covered = np.zeros(size, np.int64)
        for t0 in range(0, size, tile):
            covered[t0:t0 + tile] += 1
        assert (covered == 1).all()


@pytest.mark.parametrize("n,f,n_bins,n_nodes", PLAN_SHAPES)
def test_launch_plan_of_a_set_does_not_depend_on_the_set_count(
        n, f, n_bins, n_nodes):
    """The fields that order a set's sums (order_fields: chunks, copies,
    owners, bin and node tiles, and with several owners the feature group
    and the staged rows) are the same at any set count, so set s of a
    launch adds as a one-set launch on its inputs does."""
    one = port.launch_plan(n, f, n_bins, n_nodes)
    assert one.sets == 1
    for sets in PLAN_SETS:
        plan = port.launch_plan(n, f, n_bins, n_nodes, sets)
        assert port.order_fields(plan) == port.order_fields(one)


class _Launched:
    """Records a kernel entry point's launch arguments."""

    def __init__(self):
        self.args = []

    def __call__(self, *args):
        self.args.append(args)


@pytest.mark.parametrize("n,f,n_bins,n_nodes", PLAN_SHAPES)
def test_set_form_launches_the_one_set_plan(n, f, n_bins, n_nodes,
                                            monkeypatch):
    """The two wrappers hand their kernels the same order of sums: the set
    form's launch carries the one-set launch's order_fields, with its set
    count and its own plan's sets per block."""
    one, sets = _Launched(), _Launched()
    monkeypatch.setattr(port.FUSED_HISTOGRAM, "launch", one)
    monkeypatch.setattr(port.FUSED_HISTOGRAM_SETS, "launch", sets)
    monkeypatch.setattr(port.torch, "empty",
                        lambda shape, **kw: _CudaTensorLike(shape, kw.get(
                            "dtype", torch.float32)))
    s = 20
    port.fused_histogram(_CudaTensorLike((n, f), torch.int32),
                         _CudaTensorLike((n,), torch.int32),
                         _CudaTensorLike((n,), torch.float32),
                         _CudaTensorLike((n,), torch.float32),
                         n_bins, n_nodes)
    port.fused_histogram_sets(_CudaTensorLike((n, f), torch.int32),
                              _CudaTensorLike((s, n), torch.int32),
                              _CudaTensorLike((s, n), torch.float32),
                              _CudaTensorLike((s, n), torch.float32),
                              n_bins, n_nodes)
    (a,), (b,) = one.args, sets.args
    assert a[7:11] == (n, f, n_bins, n_nodes) and b[7:12] == (*a[7:11], s)
    assert port.order_fields(port.Plan(*b[12:21])) \
        == port.order_fields(port.Plan(*a[11:19], 1))
    assert tuple(b[12:21]) == tuple(port.launch_plan(n, f, n_bins, n_nodes,
                                                     s))
    assert a[19] == b[21] == 0


@pytest.mark.parametrize("sets", [0, 3])
def test_a_given_plan_is_launched(sets, monkeypatch):
    """A plan handed to the wrapper (to time it against launch_plan's) is
    the one launched; one that does not fit a block, or has more sets per
    block than the launch has sets, is refused before any launch."""
    launched = _Launched()
    kernel = port.FUSED_HISTOGRAM_SETS if sets else port.FUSED_HISTOGRAM
    monkeypatch.setattr(kernel, "launch", launched)
    monkeypatch.setattr(port.torch, "empty",
                        lambda shape, **kw: _CudaTensorLike(shape, kw.get(
                            "dtype", torch.float32)))
    n, f, n_bins, n_nodes = 200_000, 28, 256, 8
    lead = (sets,) if sets else ()
    args = (_CudaTensorLike((n, f), torch.int32),
            _CudaTensorLike(lead + (n,), torch.int32),
            _CudaTensorLike(lead + (n,), torch.float32),
            _CudaTensorLike(lead + (n,), torch.float32), n_bins, n_nodes)
    call = port.fused_histogram_sets if sets else port.fused_histogram
    plan = port.launch_plan(n, f, n_bins, n_nodes)._replace(owners=1)
    call(*args, plan=plan)
    (got,) = launched.args
    # the one-set entry takes every field but the sets per block
    fields = tuple(plan) if sets else tuple(plan)[:-1]
    first = 12 if sets else 11
    assert tuple(got[first:first + len(fields)]) == fields
    for bad in (plan._replace(copies=16),
                plan._replace(sets=max(2, sets + 1))):
        with pytest.raises(ValueError, match="does not fit"):
            call(*args, plan=bad)
    assert len(launched.args) == 1


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

    def data_ptr(self):
        return 0


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
