"""Truncated-BPTT training (train/tbptt.py, ``cli train --tbptt``) against
the JAX package's: the same seeded numpy inputs and the same parameters
(initialised in JAX and carried across with ``params_from_jax``, or the
port's CLI init carried to JAX), on the CPU.

The JAX package's ``tests/test_tbptt.py`` cases, each held against the
JAX functions:
- the state carry is exact: chunked forward == full-sequence forward;
- one chunk of length T is one ordinary full-BPTT step;
- training on a learnable recurrence converges;
- the backward horizon is the chunk;
- fold_history keeps chronology and next-draw targets, trimming the
  oldest rows;
- the same TrainErrors at the same inputs.
Then ``train --model lstm --tbptt`` against a JAX replay of the same run,
and the TrainState checkpoints across both packages.
"""

from __future__ import annotations

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euromillioner_tpu.data.pipeline import \
    pipeline_from_html as jax_pipeline_from_html
from euromillioner_tpu.config import Config as JaxConfig
from euromillioner_tpu.models import build_tbptt_lstm as jax_build_tbptt_lstm
from euromillioner_tpu.models import build_lstm as jax_build_lstm
from euromillioner_tpu.nn import losses as jax_losses
from euromillioner_tpu.train import optim as jax_optim
from euromillioner_tpu.train import tbptt as jax_tbptt
from euromillioner_tpu.train.checkpoint import \
    load_checkpoint as jax_load_checkpoint
from euromillioner_tpu.train.checkpoint import \
    save_checkpoint as jax_save_checkpoint
from euromillioner_tpu.train.trainer import TrainState as JaxTrainState
from euromillioner_tpu.utils.errors import TrainError as JaxTrainError
from euromillioner_tpu_torch import cli
from euromillioner_tpu_torch.models.convert import (params_from_jax,
                                                    params_to_numpy)
from euromillioner_tpu_torch.models.lstm import (build_lstm,
                                                 build_tbptt_lstm,
                                                 init_step_states, step_apply)
from euromillioner_tpu_torch.nn import losses
from euromillioner_tpu_torch.train import checkpoint as port_ck
from euromillioner_tpu_torch.train import optim
from euromillioner_tpu_torch.train.tbptt import (apply_with_states,
                                                 fold_history, init_states,
                                                 lstm_layers,
                                                 make_tbptt_train_step)
from euromillioner_tpu_torch.train.trainer import TrainState
from euromillioner_tpu_torch.utils.errors import TrainError

torch.set_num_threads(2)

GOLDEN = pathlib.Path(__file__).parent / "golden" / "euromillions.html"
# f32 on both sides; XLA CPU and PyTorch CPU sum the products in other
# orders. Measured: the small model's forward within 3.8e-8 abs, its
# one-chunk gradients and SGD update within 7.5e-9, the chunk loss equal.
# Pinned at the JAX package's NN trajectory pin (rtol 1e-5, atol 1e-6).
RTOL = 1e-5
ATOL = 1e-6
# the CLI run: 22 adam updates at hidden 16 on the golden history;
# measured per-epoch mse within 1.93e-7 relative of the JAX replay, the
# saved params within 6.5e-8 abs
CLI_RTOL = 1e-5


def _close(got, want, err_msg=""):
    if isinstance(got, torch.Tensor):
        got = got.detach().cpu().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL,
                               err_msg=err_msg)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def small_model():
    """The JAX test's model (hidden 16, 2 layers, out 3) and its params,
    and the port's model holding the same params."""
    jm = jax_build_tbptt_lstm(hidden=16, num_layers=2, out_dim=3)
    jp, _ = jm.init(jax.random.PRNGKey(0), (8, 5))
    tm = build_tbptt_lstm(16, 2, 3, in_features=5, device="cpu")
    tm.load_state_dict(params_from_jax(jax.device_get(jp), "cpu"))
    return jm, jp, tm


def _params(tm):
    return {k: v.detach().clone() for k, v in tm.named_parameters()}


def _data(b=4, t=16, f=5, d=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, f)).astype(np.float32)
    y = rng.normal(size=(b, t, d)).astype(np.float32)
    return x, y


def _jax_full_loss(jm):
    def loss(p, x, y):
        out, _ = jax_tbptt.apply_with_states(
            jm, p, x, jax_tbptt.init_states(jm, x.shape[0]))
        return jax_losses.mse(out.astype(jnp.float32), y)
    return jax.jit(jax.value_and_grad(loss))


def test_state_carry_matches_full_forward(small_model):
    """Two half-chunks with the carried state reproduce the full-sequence
    forward (truncation changes gradients, never the forward pass), and
    the port's forward is the JAX package's; one step at a time through
    ``step_apply`` too."""
    jm, jp, tm = small_model
    x, _ = _data()
    xt = torch.from_numpy(x)
    with torch.no_grad():
        full, _ = apply_with_states(tm, None, xt, init_states(tm, 4))
        states = init_states(tm, 4)
        out1, states = apply_with_states(tm, None, xt[:, :8], states)
        out2, _ = apply_with_states(tm, None, xt[:, 8:], states)
        steps, states = [], init_step_states(tm, 4)
        for t in range(x.shape[1]):
            states, y_t = step_apply(tm, states, xt[:, t])
            steps.append(y_t)
    np.testing.assert_allclose(torch.cat([out1, out2], 1).numpy(),
                               full.numpy(), atol=1e-6)
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full.numpy(),
                               atol=1e-6)
    want, _ = jax.jit(lambda p, x: jax_tbptt.apply_with_states(
        jm, p, x, jax_tbptt.init_states(jm, 4)))(jp, jnp.asarray(x))
    _close(full, want, "full forward vs JAX")


def test_single_chunk_equals_full_bptt(small_model):
    """chunk_len == T: one chunk, one update — the same loss and params as
    an ordinary value-and-grad + SGD step, in the port and in JAX."""
    jm, jp, tm = small_model
    x, y = _data()
    params = _params(tm)
    opt = optim.sgd(0.1)
    step = make_tbptt_train_step(tm, opt, losses.mse, chunk_len=x.shape[1])
    new_params, _, chunk_losses = step(
        params, opt.init(params), torch.from_numpy(x), torch.from_numpy(y))
    assert tuple(chunk_losses.shape) == (1,)
    live = {k: v.requires_grad_() for k, v in _params(tm).items()}
    out, _ = apply_with_states(tm, live, torch.from_numpy(x),
                               init_states(tm, 4))
    ref = losses.mse(out, torch.from_numpy(y))
    grads = torch.autograd.grad(ref, list(live.values()))
    assert float(chunk_losses[0]) == float(ref.detach())
    for (k, p), g in zip(live.items(), grads):
        torch.testing.assert_close(new_params[k], p.detach() - 0.1 * g,
                                   rtol=0, atol=1e-7)
    jloss, jgrads = _jax_full_loss(jm)(jp, jnp.asarray(x), jnp.asarray(y))
    _close(chunk_losses[0], jloss, "loss vs JAX")
    want = _flat(jax.tree.map(lambda p, g: p - 0.1 * g, jp, jgrads))
    for k, v in want.items():
        _close(new_params[k], v, f"{k} vs JAX")


def test_chunked_training_converges(small_model):
    """Four-chunk TBPTT on a learnable recurrence (y_t = running mean of
    feature 0) cuts the per-chunk loss by more than half; its first pass's
    chunk losses are the JAX program's on the same params."""
    jm1 = jax_build_tbptt_lstm(hidden=32, num_layers=1, out_dim=1)
    jp1, _ = jm1.init(jax.random.PRNGKey(1), (8, 4))
    tm1 = build_tbptt_lstm(32, 1, 1, in_features=4, device="cpu")
    tm1.load_state_dict(params_from_jax(jax.device_get(jp1), "cpu"))
    rng = np.random.default_rng(1)
    x = rng.normal(size=(8, 64, 4)).astype(np.float32)
    y = (np.cumsum(x[..., 0], axis=1)
         / np.arange(1, 65)[None, :])[..., None].astype(np.float32)
    jstep = jax_tbptt.make_tbptt_train_step(jm1, jax_optim.sgd(0.05),
                                            jax_losses.mse, chunk_len=16,
                                            donate=False)
    _, _, jlosses = jstep(jp1, jax_optim.sgd(0.05).init(jp1),
                          jnp.asarray(x), jnp.asarray(y))
    params = _params(tm1)
    opt = optim.sgd(0.05)
    opt_state = opt.init(params)
    step = make_tbptt_train_step(tm1, opt, losses.mse, chunk_len=16)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    first = None
    for i in range(60):
        params, opt_state, chunk_losses = step(params, opt_state, xt, yt)
        if i == 0:
            _close(chunk_losses, jlosses, "first pass's chunk losses")
            first = float(chunk_losses[0])
    last = float(chunk_losses.mean())
    assert last < 0.5 * first, (first, last)


def _grad_recorder():
    """A no-op optimizer whose state sums the raw gradients: what the
    TBPTT pass backpropagates, with every parameter left as it was."""
    def init(p):
        return {k: torch.zeros_like(v) for k, v in p.items()}

    def update(grads, state, p):
        return ({k: torch.zeros_like(g) for k, g in grads.items()},
                {k: state[k] + g for k, g in grads.items()})

    return optim.Optimizer(init, update, "grad_recorder")


def test_gradient_horizon_is_truncated(small_model):
    """The defining TBPTT semantic: the backward horizon is the chunk.
    Recorded gradients (params frozen) equal full-BPTT gradients — the
    port's autograd and ``jax.grad`` — when chunk_len == T, and differ
    from them when the sequence is split; the split's chunk losses still
    partition the full loss."""
    jm, jp, tm = small_model
    x, y = _data()
    opt = _grad_recorder()

    def run(chunk_len):
        params = _params(tm)
        step = make_tbptt_train_step(tm, opt, losses.mse,
                                     chunk_len=chunk_len)
        _, grads, chunk_losses = step(params, opt.init(params),
                                      torch.from_numpy(x),
                                      torch.from_numpy(y))
        return grads, chunk_losses

    grads_full, loss_full = run(x.shape[1])
    grads_half, loss_half = run(x.shape[1] // 2)
    _, jgrads = _jax_full_loss(jm)(jp, jnp.asarray(x), jnp.asarray(y))
    for k, v in _flat(jgrads).items():
        _close(grads_full[k], v, f"{k} vs jax.grad")
    np.testing.assert_allclose(float(loss_half.mean()), float(loss_full[0]),
                               rtol=1e-6)
    wh_full = grads_full["0_LSTM.wh"].numpy()
    wh_half = grads_half["0_LSTM.wh"].numpy()
    assert np.abs(wh_full - wh_half).max() > 1e-6, \
        "chunked gradient identical to full BPTT — horizon not truncated"


def test_fold_history_semantics():
    feats = np.arange(22 * 11, dtype=np.float32).reshape(22, 11)
    x, y = fold_history(feats, lanes=3)
    jx, jy = jax_tbptt.fold_history(feats, lanes=3)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    assert x.shape == (3, 7, 11) and y.shape == (3, 7, 7)
    np.testing.assert_array_equal(x[0, 0], feats[0])
    np.testing.assert_array_equal(y[0, 0], feats[1, 4:11])
    np.testing.assert_array_equal(x[1, 0], feats[7])
    with pytest.raises(TrainError):
        fold_history(feats[:2], lanes=5)


def test_fold_history_trims_oldest_not_newest():
    """A history that does not divide by the lanes loses its OLDEST rows;
    the newest draws survive."""
    feats = np.arange(24 * 11, dtype=np.float32).reshape(24, 11)
    x, y = fold_history(feats, lanes=3)  # 23 usable -> 21 kept, 2 dropped
    jx, jy = jax_tbptt.fold_history(feats, lanes=3)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    assert x.shape == (3, 7, 11)
    np.testing.assert_array_equal(x[0, 0], feats[2])
    np.testing.assert_array_equal(x[2, -1], feats[22])
    np.testing.assert_array_equal(y[2, -1], feats[23, 4:11])


def test_validation_errors(small_model):
    """The JAX package's TrainErrors at the same inputs: T not a multiple
    of the chunk, an LSTM without return_sequences, chunk_len < 1, a state
    count mismatch, no LSTM at all, lanes < 1."""
    _, _, tm = small_model
    x, y = _data()
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    params = _params(tm)
    opt = optim.sgd(0.1)
    step = make_tbptt_train_step(tm, opt, losses.mse, chunk_len=5)
    with pytest.raises(TrainError, match="not a multiple"):
        step(params, opt.init(params), xt, yt)
    plain = build_lstm(8, 1, 3, fused="off", in_features=5, device="cpu")
    with pytest.raises(TrainError, match="return_sequences"):
        apply_with_states(plain, None, xt, init_states(plain, 4))
    assert len(lstm_layers(tm)) == 2
    with pytest.raises(TrainError, match="chunk_len"):
        make_tbptt_train_step(tm, opt, losses.mse, chunk_len=0)
    with pytest.raises(TrainError, match="state count"):
        apply_with_states(tm, params, xt, states=[])
    from euromillioner_tpu_torch.models.mlp import build_mlp

    with pytest.raises(TrainError, match="at least one LSTM"):
        make_tbptt_train_step(build_mlp((4,), device="cpu"), opt,
                              losses.mse, chunk_len=4)
    with pytest.raises(TrainError, match="lanes"):
        fold_history(np.zeros((8, 11), np.float32), lanes=0)
    # and the JAX package raises at the same inputs
    jplain = jax_build_lstm(hidden=8, num_layers=1, out_dim=3, fused="off")
    jpp, _ = jplain.init(jax.random.PRNGKey(0), (8, 5))
    with pytest.raises(JaxTrainError, match="return_sequences"):
        jax_tbptt.apply_with_states(jplain, jpp, jnp.asarray(x),
                                    jax_tbptt.init_states(jplain, 4))
    with pytest.raises(JaxTrainError, match="lanes"):
        jax_tbptt.fold_history(np.zeros((8, 11), np.float32), lanes=0)


# -- train --tbptt through the CLI ------------------------------------------

TB_ARGV = ["train", "--model", "lstm", "--tbptt", "--html-file", str(GOLDEN),
           "--device", "cpu", "train.epochs=2", "model.lstm_hidden=16",
           "model.lstm_layers=1", "model.compute_dtype=float32",
           "train.tbptt_chunk_len=25", "train.tbptt_lanes=4"]


def _jax_replay(init_params):
    """The JAX package's ``_train_tbptt`` on the same run, from the port
    CLI's initial params: per-epoch (train mse, test mse) and the final
    TrainState."""
    cfg = JaxConfig()
    tr, va = jax_pipeline_from_html(GOLDEN.read_text(encoding="utf-8"),
                                    cfg.data)
    x, y = jax_tbptt.fold_history(tr.full_rows(), 4)
    t = (x.shape[1] // 25) * 25
    xj, yj = jnp.asarray(x[:, -t:]), jnp.asarray(y[:, -t:])
    xv, yv = jax_tbptt.fold_history(va.full_rows(), 1)
    model = jax_build_tbptt_lstm(hidden=16, num_layers=1, out_dim=7)
    opt = jax_optim.adam(1e-3)
    params = jax.tree.map(jnp.asarray, init_params)
    state = opt.init(params)
    step = jax_tbptt.make_tbptt_train_step(model, opt, jax_losses.mse,
                                           chunk_len=25, donate=False)

    @jax.jit
    def val_loss(p):
        out, _ = jax_tbptt.apply_with_states(
            model, p, jnp.asarray(xv), jax_tbptt.init_states(model, 1))
        return jax_losses.mse(out.astype(jnp.float32), jnp.asarray(yv))

    rounds = []
    for _ in range(2):
        params, state, chunk_losses = step(params, state, xj, yj)
        rounds.append((float(chunk_losses.mean()), float(val_loss(params))))
    return rounds, JaxTrainState(params=params, opt_state=state,
                                 step=jnp.asarray(2, jnp.int32))


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """The port's ``train --tbptt`` with a JSONL record per epoch and a
    checkpoint, and the port's initial params for the same seed."""
    d = tmp_path_factory.mktemp("tbptt")
    jsonl = d / "m.jsonl"
    assert cli.main(TB_ARGV + ["--save", str(d / "ck"),
                               f"train.metrics_jsonl={jsonl}"]) == 0
    init = build_tbptt_lstm(16, 1, 7, generator=torch.Generator()
                            .manual_seed(0), device="cpu")
    records = [json.loads(ln) for ln in jsonl.read_text().splitlines()]
    return d, records, params_to_numpy(init)


def test_cli_tbptt_matches_the_jax_run(cli_run, tmp_path):
    """``train --model lstm --tbptt`` (chunk 25, 4 lanes): the eval
    records' per-epoch mse against the JAX package's TBPTT run from the
    same initial params, within CLI_RTOL; the saved TrainState is the JAX
    run's final state (JAX loads the port's checkpoint), and a JAX save
    of that state restores in the port."""
    d, records, init = cli_run
    rounds, jstate = _jax_replay(init)
    assert [r["round"] for r in records] == [0, 1]
    for r, (train_mse, test_mse) in zip(records, rounds):
        np.testing.assert_allclose(r["train-mse"], train_mse, rtol=CLI_RTOL)
        np.testing.assert_allclose(r["test-mse"], test_mse, rtol=CLI_RTOL)
    path = port_ck.latest_checkpoint(str(d / "ck"))
    assert path.endswith("step_00000002")
    # JAX loads the port's checkpoint into its own TrainState structure
    got = jax.device_get(jax_load_checkpoint(path, jstate))
    for k, v in _flat(jax.device_get(jstate.params)).items():
        np.testing.assert_allclose(_flat(got.params)[k], v, rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    # step counts epochs, the optimizer's count its 22 updates
    assert int(got.step) == 2 and int(got.opt_state["count"]) == 22
    # and the port restores a JAX save of its own run
    jax_save_checkpoint(str(tmp_path), jstate, step=2)
    model = build_tbptt_lstm(16, 1, 7, device="cpu")
    params = {k: v.detach().clone() for k, v in model.named_parameters()}
    like = TrainState(params=params, opt_state=optim.adam(1e-3).init(params),
                      step=torch.zeros((), dtype=torch.int32))
    back = port_ck.load_train_state(
        port_ck.latest_checkpoint(str(tmp_path)), like)
    mine = port_ck.load_train_state(path, like)
    for k, v in back.params.items():
        _close(mine.params[k], v, k)
    for moment in ("mu", "nu"):
        for k, v in back.opt_state[moment].items():
            _close(mine.opt_state[moment][k], v, f"{moment}.{k}")
    assert int(back.step) == 2 and int(back.opt_state["count"]) == 22


def test_cli_tbptt_logs_and_distributed_warning(tmp_path, caplog):
    """The eval lines and the trimming line as the JAX CLI logs them, and
    ``--distributed`` trains the same single-device program with the JAX
    CLI's "mesh ignored" warning."""
    import logging

    with caplog.at_level(logging.INFO):
        assert cli.main(TB_ARGV + ["--distributed", "train.epochs=1"]) == 0
    msgs = [r.message for r in caplog.records]
    assert any("mesh ignored" in m for m in msgs)
    assert any(m.startswith("trimming 23 oldest steps/lane") for m in msgs)
    lines = [m for m in msgs if m.startswith("[")]
    assert len(lines) == 1
    assert "train-mse:" in lines[0] and "test-mse:" in lines[0]
