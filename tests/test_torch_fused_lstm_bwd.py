"""The port's fused-LSTM backward (K2's plain version) and the K1+K2
autograd Function (euromillioner_tpu_torch/ops/fused_lstm.py) against the
JAX package's Pallas ``_bwd`` and ``jax.grad`` of ``lstm_sequence``, run in
interpret mode on the CPU, and against torch autograd through the scan.

On CPU tensors the wrappers take the kernels' plain versions; the CUDA
kernels themselves are held to those plain versions on the card by
chip_smoke.py."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euromillioner_tpu.ops import fused_lstm as jax_ops
from euromillioner_tpu_torch.nn.recurrent import LSTM, lstm_cell
from euromillioner_tpu_torch.ops import fused_lstm as port
from euromillioner_tpu_torch.utils.errors import ConfigError

torch.set_num_threads(2)

# f32 on both sides; only summation order differs (the dh carry's 4H-long
# dots, dwh's T*B-long sums). Measured max abs diff 2.4e-6 against the
# Pallas _bwd (dwh at T=16, its largest values, inside the rtol term) and
# 8.3e-7 against jax.grad; pinned at the JAX package's NN trajectory pin.
ATOL = 1e-6
RTOL = 1e-5
# layer gradients of a summed loss reach ~9 (wx, bias); measured max
# rel-to-scale diff 1.9e-7 against torch autograd through the scan.
# Pinned at ~10x, well inside the JAX package's own fused-vs-scan
# gradient pin (rtol 5e-4, atol 1e-5).
GRAD_REL = 2e-6


def _inputs(batch, steps, hidden, peepholes, seed=0):
    rng = np.random.default_rng(seed)
    x_proj = rng.normal(size=(steps, batch, 4 * hidden)).astype(np.float32)
    wh = (rng.normal(size=(hidden, 4 * hidden))
          / np.sqrt(hidden)).astype(np.float32)
    peep = np.zeros((4, hidden), np.float32)
    if peepholes:
        peep[:3] = rng.normal(scale=0.1, size=(3, hidden))
    g_hs = rng.normal(size=(steps, batch, hidden)).astype(np.float32)
    return x_proj, wh, peep, g_hs


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("steps,peepholes", [(5, True), (5, False),
                                             (16, True), (16, False)])
def test_plain_backward_matches_pallas_bwd(steps, peepholes):
    """dxp, dwh and dpeep at B=16, H=128 from the same residuals; T=16
    runs the Pallas kernel as two 8-step time blocks (the dh/dc carry
    handoff across blocks)."""
    x_proj, wh, peep, g_hs = _inputs(16, steps, 128, peepholes)
    res = jax_ops._fwd(jnp.asarray(x_proj), jnp.asarray(wh),
                       jnp.asarray(peep), peepholes=peepholes)
    want = jax_ops._bwd(jnp.asarray(wh), jnp.asarray(peep), res,
                        jnp.asarray(g_hs), peepholes=peepholes)
    got = port.lstm_backward(*_t(wh, peep),
                             tuple(torch.from_numpy(np.array(r))
                                   for r in res),
                             torch.from_numpy(g_hs), peepholes)
    for name, g, w in zip(("dxp", "dwh", "dpeep"), got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


@pytest.mark.parametrize("peepholes", [True, False])
def test_function_grads_match_jax_grad(peepholes):
    """d/d(x_proj, wh, peep) of sum(hs * g) through LSTMSequence (plain
    versions on the CPU) against jax.grad of the custom-VJP
    lstm_sequence (Pallas in interpret mode)."""
    x_proj, wh, peep, g_hs = _inputs(16, 5, 128, peepholes, seed=1)

    def jloss(xp, w, p):
        return (jax_ops.lstm_sequence(xp, w, p, peepholes) * g_hs).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x_proj), jnp.asarray(wh), jnp.asarray(peep))
    args = [a.requires_grad_() for a in _t(x_proj, wh, peep)]
    hs = port.LSTMSequence.apply(*args, peepholes)
    (hs * torch.from_numpy(g_hs)).sum().backward()
    for name, a, w in zip(("dxp", "dwh", "dpeep"), args, want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


@pytest.mark.parametrize("peepholes", [True, False])
@pytest.mark.parametrize("return_sequences", [True, False])
def test_layer_grads_fused_on_match_scan_autograd(peepholes,
                                                  return_sequences):
    """Every parameter's gradient of an LSTM layer under fused='on' (the
    Function) against fused='off' (autograd through the scan)."""
    gen = torch.Generator().manual_seed(3)
    layer = LSTM(11, 32, return_sequences=return_sequences,
                 peepholes=peepholes, generator=gen, device="cpu")
    x = torch.randn((8, 6, 11), generator=gen)
    g = torch.randn((8, 6, 32) if return_sequences else (8, 32),
                    generator=gen)
    grads = {}
    for mode in ("on", "off"):
        layer.fused = mode
        layer.zero_grad(set_to_none=True)
        (layer.apply(x, train=True) * g).sum().backward()
        grads[mode] = {n: p.grad.clone() for n, p in layer.named_parameters()}
    assert set(grads["on"]) == {"wx", "wh", "bias"} | (
        {"p_i", "p_f", "p_o"} if peepholes else set())
    for name, want in grads["off"].items():
        err = float((grads["on"][name] - want).abs().max()
                    / want.abs().max())
        assert err < GRAD_REL, f"{name}: rel err {err}"


def _runs_function(layer, x) -> bool:
    """Whether the layer's autograd graph holds the Function's node."""
    seen, stack = set(), [layer.apply(x, train=True).grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        if type(fn).__name__ == "LSTMSequenceBackward":
            return True
        stack.extend(f for f, _ in fn.next_functions)
    return False


@pytest.mark.parametrize("mode,fused", [("on", True), ("auto", False),
                                        ("off", False)])
def test_fused_modes_on_cpu(mode, fused):
    """On a CPU tensor 'on' runs the Function (its plain versions, as the
    JAX package runs interpret mode); 'auto' and 'off' scan."""
    layer = LSTM(11, 16, return_sequences=True, fused=mode,
                 generator=torch.Generator().manual_seed(0), device="cpu")
    x = torch.randn((4, 3, 11), generator=torch.Generator().manual_seed(1))
    assert _runs_function(layer, x) == fused
    layer.fused = "off"
    before = port.FUSED_LSTM_FWD.launches, port.FUSED_LSTM_BWD.launches
    with torch.no_grad():
        ref = layer.apply(x)
    layer.fused = mode
    with torch.no_grad():
        got = layer.apply(x)
    torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
    assert (port.FUSED_LSTM_FWD.launches,
            port.FUSED_LSTM_BWD.launches) == before


@pytest.mark.parametrize("mode", ["auto", "on"])
@pytest.mark.parametrize("dtype,hidden,reason", [
    (torch.float16, 512, "float32 or bfloat16"),
    (torch.float32, port.MAX_HIDDEN_BWD + 1, "shared-memory cap")])
def test_fused_modes_refuse_what_the_card_cannot_run(mode, dtype, hidden,
                                                      reason):
    """On a CUDA tensor the kernels cannot take, 'auto' raises as 'on'
    does, with its own reason — neither scans on the card. Only the
    tensor's device type and dtype are read, so a stand-in carries them."""
    layer = LSTM(11, 8, fused=mode, generator=torch.Generator(),
                 device="cpu")
    layer.hidden = hidden
    card = types.SimpleNamespace(device=torch.device("cuda", 0), dtype=dtype)
    with pytest.raises(ConfigError, match=reason):
        layer._use_fused(card)
    layer.fused = "off"
    assert layer._use_fused(card) is False


@pytest.mark.parametrize("mode,fused", [("auto", True), ("on", True),
                                        ("off", False)])
def test_fused_modes_on_the_card(mode, fused):
    layer = LSTM(11, 8, fused=mode, generator=torch.Generator(),
                 device="cpu")
    layer.hidden = 512
    card = types.SimpleNamespace(device=torch.device("cuda", 0),
                                 dtype=torch.float32)
    assert layer._use_fused(card) is fused
    assert port.kernel_refusal(torch.float32, 512) is None


def test_fused_mode_is_validated():
    with pytest.raises(ValueError, match="auto|on|off"):
        LSTM(11, 8, fused="yes", generator=torch.Generator(), device="cpu")


def test_cpu_tensors_never_touch_the_backward_kernel():
    x_proj, wh, peep, g_hs = _t(*_inputs(8, 4, 32, True, seed=2))
    res = port.lstm_forward(x_proj, wh, peep, True)
    before = port.FUSED_LSTM_BWD.launches
    got = port.lstm_backward(wh, peep, res, g_hs, True)
    want = port.lstm_backward_reference(wh, peep, res, g_hs, True)
    assert port.FUSED_LSTM_BWD.launches == before
    assert not port.FUSED_LSTM_BWD.loaded
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bool((got[2][3] == 0).all())  # dpeep's padding row


@pytest.mark.parametrize("bad", ["g_hs", "cs", "wh"])
def test_backward_shape_mismatch_raises(bad):
    x_proj, wh, peep, g_hs = _t(*_inputs(4, 2, 8, True, seed=4))
    hs, cs, gates = port.lstm_forward(x_proj, wh, peep, True)
    args = {"g_hs": g_hs, "cs": cs, "wh": wh}
    args[bad] = args[bad][..., :-1]
    with pytest.raises(ValueError):
        port.lstm_backward(args["wh"], peep, (hs, args["cs"], gates),
                           args["g_hs"], True)


def test_backward_on_other_devices_raises():
    t, b, h = 2, 4, 8
    meta = [torch.empty(s, device="meta") for s in
            ((t, b, h), (t, b, h), (t, b, 4 * h), (h, 4 * h), (4, h),
             (t, b, h))]
    hs, cs, gates, wh, peep, g_hs = meta
    with pytest.raises(ValueError, match="unsupported device"):
        port.lstm_backward(wh, peep, (hs, cs, gates), g_hs, True)


@pytest.mark.parametrize("mode", ["auto", "on"])
def test_bf16_passes_the_kernel_refusal(mode):
    """The default compute dtype runs the kernels on the card."""
    layer = LSTM(11, 8, fused=mode, generator=torch.Generator(),
                 device="cpu")
    layer.hidden = 512
    card = types.SimpleNamespace(device=torch.device("cuda", 0),
                                 dtype=torch.bfloat16)
    assert layer._use_fused(card) is True
    assert port.kernel_refusal(torch.bfloat16, 512) is None


# bf16 on both sides from identical residuals: the gate gradients are f32,
# dxp rounds to bf16 and the dh carry takes the rounded dgates, so a
# rounding flipped by another summation order can move later steps' dxp by
# one ulp. Measured at B=16, H=128, T=8 and 16, relative to each output's
# scale: dxp 1.7e-3, dwh 4.1e-3 (one ulp of its largest value, in bf16 on
# both sides), dpeep (f32) 6.0e-5. Pinned: dxp and dwh at one bf16 ulp at
# the scale (2^-7), dpeep at 5e-4.
BF16_BWD_REL = {"dxp": 2.0 ** -7, "dwh": 2.0 ** -7, "dpeep": 5e-4}


@pytest.mark.parametrize("steps,peepholes", [(16, True), (8, False)])
def test_plain_backward_matches_pallas_bwd_bf16(steps, peepholes):
    x_proj, wh, peep, g_hs = _inputs(16, steps, 128, peepholes)
    bf = jnp.bfloat16
    whb = jnp.asarray(wh).astype(bf)
    res = jax_ops._fwd(jnp.asarray(x_proj).astype(bf), whb,
                       jnp.asarray(peep), peepholes=peepholes)
    want = jax_ops._bwd(whb, jnp.asarray(peep), res,
                        jnp.asarray(g_hs).astype(bf), peepholes=peepholes)
    got = port.lstm_backward(
        torch.from_numpy(wh).bfloat16(), torch.from_numpy(peep),
        tuple(torch.from_numpy(np.array(r.astype(jnp.float32))).bfloat16()
              for r in res),
        torch.from_numpy(g_hs).bfloat16(), peepholes)
    for name, g, w in zip(("dxp", "dwh", "dpeep"), got, want):
        assert g.dtype == (torch.float32 if name == "dpeep"
                           else torch.bfloat16), name
        w = np.asarray(w.astype(jnp.float32))
        # without peepholes dpeep is all zeros on both sides
        rel = np.abs(g.float().numpy() - w).max() / (np.abs(w).max() or 1.0)
        assert rel <= BF16_BWD_REL[name], f"{name}: rel {rel}"


# The JAX package's TestBf16Envelope (tests/test_fused_lstm.py) for the
# port: gradients through the K1+K2 Function in bf16 (plain versions on
# the CPU) against autograd through the f32 scan, relative to scale, at
# that test's B=16, T=4, H=128 and its pin of 1e-2: measured dxp 6.1e-3,
# dwh 6.7e-3, dpeep 4.9e-3. The same shape in f32 measured 2.2e-7, inside
# 1e-5: the envelope is bf16 rounding, not a fault.
BF16_GRAD_REL = 1e-2


def test_bf16_function_grads_inside_the_envelope_of_the_f32_scan():
    b, t, h = 16, 4, 128
    layer = LSTM(h, h, generator=torch.Generator().manual_seed(0),
                 device="cpu")
    xp = torch.randn((t, b, 4 * h), generator=torch.Generator().manual_seed(7))
    peep = layer._peep_rows().detach()

    def grads(dtype, scan):
        args = [a.detach().to(d).clone().requires_grad_() for a, d in
                ((xp, dtype), (layer.wh, dtype), (peep, torch.float32))]
        if scan:
            hk = ck = torch.zeros((b, h))
            outs = []
            for k in range(t):
                hk, ck, _ = lstm_cell(args[0][k], hk, ck, args[1],
                                      tuple(args[2][:3]))
                outs.append(hk)
            hs = torch.stack(outs)
        else:
            hs = port.LSTMSequence.apply(*args, True)
        (hs.float() ** 2).sum().backward()
        return [a.grad.float() for a in args]

    ref = grads(torch.float32, scan=True)
    for dtype, tol in ((torch.bfloat16, BF16_GRAD_REL), (torch.float32, 1e-5)):
        for name, g, r in zip(("dxp", "dwh", "dpeep"),
                              grads(dtype, scan=False), ref):
            rel = float((g - r).abs().max() / r.abs().max())
            assert rel < tol, f"{dtype} {name}: rel {rel}"
