"""The port's fused-LSTM forward (euromillioner_tpu_torch/ops/fused_lstm.py)
against the JAX package's Pallas kernel, run in interpret mode on the CPU.

On CPU tensors the port's wrappers take the kernel's plain version, so
these tests hold that plain version (and the wrapper plumbing around the
CUDA kernel) to the reference; the CUDA kernel itself is held to the plain
version on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euromillioner_tpu.ops import fused_lstm as jax_ops
from euromillioner_tpu_torch.ops import fused_lstm as port

torch.set_num_threads(2)

# f32 on both sides; only the order of the H-long dot products differs
# (XLA CPU vs PyTorch CPU). Measured max abs diff 3.6e-7 over hs, cs and
# gates (values up to ~1); pinned at the JAX package's NN trajectory pin.
ATOL = 1e-6
RTOL = 1e-5


def _inputs(batch, steps, hidden, peepholes, seed=0):
    rng = np.random.default_rng(seed)
    x_proj = rng.normal(size=(steps, batch, 4 * hidden)).astype(np.float32)
    wh = (rng.normal(size=(hidden, 4 * hidden))
          / np.sqrt(hidden)).astype(np.float32)
    peep = np.zeros((4, hidden), np.float32)
    if peepholes:
        peep[:3] = rng.normal(scale=0.1, size=(3, hidden))
    return x_proj, wh, peep


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("steps,peepholes", [(5, True), (5, False),
                                             (16, True)])
def test_plain_version_matches_pallas_fwd(steps, peepholes):
    """hs, cs and gates at B=16, H=128; T=16 runs the Pallas kernel as two
    8-step time blocks."""
    x_proj, wh, peep = _inputs(16, steps, 128, peepholes)
    want = jax_ops._fwd(jnp.asarray(x_proj), jnp.asarray(wh),
                        jnp.asarray(peep), peepholes=peepholes)
    got = port.lstm_sequence_reference(*_torch(x_proj, wh, peep), peepholes)
    for name, g, w in zip(("hs", "cs", "gates"), got, want):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_lstm_sequence_matches_jax_lstm_sequence():
    x_proj, wh, peep = _inputs(16, 7, 128, True, seed=1)
    want = jax_ops.lstm_sequence(jnp.asarray(x_proj), jnp.asarray(wh),
                                 jnp.asarray(peep), True)
    got = port.lstm_sequence(*_torch(x_proj, wh, peep), True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_cpu_tensors_never_touch_the_kernel():
    """The device rule: a CPU tensor takes the plain version — no build,
    no launch counted — and both wrappers agree with it exactly."""
    x_proj, wh, peep = [torch.from_numpy(a)
                        for a in _inputs(8, 4, 32, True, seed=2)]
    before = port.FUSED_LSTM_FWD.launches
    hs = port.lstm_sequence(x_proj, wh, peep, True)
    full = port.lstm_forward(x_proj, wh, peep, True)
    ref = port.lstm_sequence_reference(x_proj, wh, peep, True)
    assert port.FUSED_LSTM_FWD.launches == before
    assert not port.FUSED_LSTM_FWD.loaded
    assert torch.equal(hs, ref[0])
    for g, w in zip(full, ref):
        assert torch.equal(g, w)


def test_residuals_have_the_pallas_layout():
    x_proj, wh, peep = [torch.from_numpy(a)
                        for a in _inputs(8, 3, 16, True, seed=3)]
    hs, cs, gates = port.lstm_forward(x_proj, wh, peep, True)
    assert hs.shape == cs.shape == (3, 8, 16)
    assert gates.shape == (3, 8, 64)
    # activated gates: i, f, o in (0, 1); g in (-1, 1); h = o * tanh(c)
    i, f, g, o = gates.split(16, dim=-1)
    assert bool(((i > 0) & (i < 1) & (f > 0) & (f < 1)
                 & (o > 0) & (o < 1)).all())
    assert bool((g.abs() <= 1).all())
    torch.testing.assert_close(hs, o * torch.tanh(cs), rtol=0, atol=1e-6)


@pytest.mark.parametrize("bad", ["wh", "peep", "x_proj"])
def test_shape_mismatch_raises(bad):
    x_proj, wh, peep = [torch.from_numpy(a)
                        for a in _inputs(4, 2, 8, True, seed=4)]
    args = {"x_proj": x_proj, "wh": wh, "peep": peep}
    args[bad] = args[bad][..., :-1]
    with pytest.raises(ValueError):
        port.lstm_sequence(args["x_proj"], args["wh"], args["peep"], True)


def test_other_devices_raise_instead_of_falling_back():
    x_proj, wh, peep = [torch.empty(s, device="meta")
                        for s in ((2, 4, 32), (8, 32), (4, 8))]
    with pytest.raises(ValueError, match="unsupported device"):
        port.lstm_sequence(x_proj, wh, peep, True)


# bf16 on both sides with the kernels' semantics (f32 carry, h rounded to
# bf16 as the dot operand, f32 sums): only the order of the H-long dots
# differs, which flips a rounding now and then. Measured at B=16, H=128,
# T=8 and 16: at most 2 of 131,072 elements differ, each by one bf16 ulp
# (gates 3.9e-3 at 1.0). Pinned: each element within one ulp (2^-7 of its
# value, the ulp's bound) and at most 1e-3 of the elements off at all.
# Before the fix (a bf16 carry) 64% of hs differed by up to 7.8e-3.
BF16_ULP_RTOL = 2.0 ** -7
BF16_ATOL = 1e-6
BF16_SHARE = 1e-3


@pytest.mark.parametrize("steps,peepholes", [(16, True), (8, False)])
def test_plain_version_matches_pallas_fwd_bf16(steps, peepholes):
    """The plain K1 computes what the Pallas kernel computes in bf16:
    hs, cs and gates at B=16, H=128 from the same bf16 inputs."""
    x_proj, wh, peep = _inputs(16, steps, 128, peepholes)
    bf = jnp.bfloat16
    want = jax_ops._fwd(jnp.asarray(x_proj).astype(bf),
                        jnp.asarray(wh).astype(bf), jnp.asarray(peep),
                        peepholes=peepholes)
    got = port.lstm_sequence_reference(
        torch.from_numpy(x_proj).bfloat16(), torch.from_numpy(wh).bfloat16(),
        torch.from_numpy(peep), peepholes)
    for name, g, w in zip(("hs", "cs", "gates"), got, want):
        assert g.dtype == torch.bfloat16, name
        g = g.float().numpy()
        w = np.asarray(w.astype(jnp.float32))
        np.testing.assert_allclose(g, w, rtol=BF16_ULP_RTOL, atol=BF16_ATOL,
                                   err_msg=name)
        assert (g != w).mean() <= BF16_SHARE, f"{name}: {(g != w).mean()}"


def test_plain_version_f32_is_the_scan_step():
    """In f32 the plain K1 is the scan's cell step bit for bit."""
    from euromillioner_tpu_torch.nn.recurrent import lstm_cell

    x_proj, wh, peep = _torch(*_inputs(8, 6, 32, True, seed=5))
    hs, cs, _ = port.lstm_sequence_reference(x_proj, wh, peep, True)
    h = c = torch.zeros((8, 32))
    for k in range(6):
        h, c, _ = lstm_cell(x_proj[k], h, c, wh, (peep[0], peep[1], peep[2]))
        assert torch.equal(hs[k], h) and torch.equal(cs[k], c)


@pytest.mark.parametrize("case,error", [
    ({"x_proj": torch.float16, "wh": torch.float16}, "float32 or bfloat16"),
    ({"x_proj": torch.bfloat16}, "wh is torch.float32"),
    ({"x_proj": torch.bfloat16, "wh": torch.bfloat16,
      "peep": torch.bfloat16}, "peep is torch.bfloat16"),
    ({"wh": torch.bfloat16}, "wh is torch.bfloat16"),
])
def test_cuda_contract_refuses_what_the_kernels_do_not_take(case, error):
    """x_proj sets the dtype (f32 or bf16), wh shares it, peep is f32; a
    mismatch raises, naming the tensor, and nothing is cast."""
    dev = torch.device("meta")
    shapes = {"x_proj": (2, 4, 32), "wh": (8, 32), "peep": (4, 8)}
    named = [(n, torch.empty(s, dtype=case.get(n, torch.float32),
                             device=dev)) for n, s in shapes.items()]
    with pytest.raises(TypeError, match=error):
        port._check_cuda(dev, named)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_contract_names_the_instantiation(dtype):
    dev = torch.device("meta")
    named = [("x_proj", torch.empty((2, 4, 32), dtype=dtype, device=dev)),
             ("wh", torch.empty((8, 32), dtype=dtype, device=dev)),
             ("peep", torch.empty((4, 8), device=dev))]
    assert port._check_cuda(dev, named) == dtype
    assert port._FWD_KERNELS[dtype].symbol.endswith(
        {torch.float32: "_f32", torch.bfloat16: "_bf16"}[dtype])
    assert (port._FWD_KERNELS[dtype].source,
            port._BWD_KERNELS[dtype].source) == ("fused_lstm.cu",
                                                 "fused_lstm_bwd.cu")
