"""The port's training path (losses, metrics, optimizers, Trainer,
TrainState checkpoints, ``cli train``) against the JAX package's, on the
same parameters (initialised in JAX, carried across with
``params_from_jax``) and the same numpy batches."""

import json
import logging
import os
import pathlib
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euromillioner_tpu.core.precision import PARITY as JAX_PARITY
from euromillioner_tpu.data.dataset import Batch as JaxBatch
from euromillioner_tpu.data.dataset import Dataset as JaxDataset
from euromillioner_tpu.models.lstm import build_lstm as jax_build_lstm
from euromillioner_tpu.nn import losses as jax_losses
from euromillioner_tpu.train import optim as jax_optim
from euromillioner_tpu.train.checkpoint import \
    load_checkpoint as jax_load_checkpoint
from euromillioner_tpu.train.checkpoint import \
    save_checkpoint as jax_save_checkpoint
from euromillioner_tpu.train.metrics import eval_line as jax_eval_line
from euromillioner_tpu.train.trainer import Trainer as JaxTrainer
from euromillioner_tpu_torch import cli
from euromillioner_tpu_torch.core.precision import PARITY
from euromillioner_tpu_torch.data.dataset import Batch, Dataset
from euromillioner_tpu_torch.data.pipeline import pipeline_from_html
from euromillioner_tpu_torch.models.convert import params_from_jax
from euromillioner_tpu_torch.models.lstm import build_lstm, make_sequences
from euromillioner_tpu_torch.nn import losses
from euromillioner_tpu_torch.train import checkpoint as port_ck
from euromillioner_tpu_torch.train import optim
from euromillioner_tpu_torch.train.metrics import eval_line
from euromillioner_tpu_torch.train.trainer import (Trainer, check_predicts,
                                                   epoch_seeds)
from euromillioner_tpu_torch.utils.errors import TrainError

torch.set_num_threads(2)

GOLDEN = pathlib.Path(__file__).parent / "golden"
# f32 on both sides; reductions and GEMMs sum in another order in XLA CPU
# than in PyTorch CPU. Measured: optimizer updates bit-equal; losses and
# metrics within 2.4e-7 abs; one Trainer step's loss, params and adam
# moments within 2.6e-7 abs. Pinned at the JAX package's NN trajectory pin.
ATOL = 1e-6
RTOL = 1e-5


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _close(got, want, err_msg=""):
    if isinstance(got, torch.Tensor):
        got = got.detach().cpu().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL,
                               err_msg=err_msg)


# -- losses, metrics ---------------------------------------------------------

@pytest.mark.parametrize("name", ["mse", "rmse", "logloss", "error_rate"])
@pytest.mark.parametrize("masked", [False, True])
def test_losses_match_jax(name, masked):
    rng = np.random.default_rng(0)
    prob = rng.uniform(size=(12, 7)).astype(np.float32)
    label = (rng.uniform(size=(12, 7)) > 0.5).astype(np.float32)
    mask = np.r_[np.ones(9), np.zeros(3)].astype(np.float32) if masked else None
    got = getattr(losses, name)(torch.from_numpy(prob),
                                torch.from_numpy(label),
                                None if mask is None else torch.from_numpy(mask))
    want = getattr(jax_losses, name)(jnp.asarray(prob), jnp.asarray(label),
                                     None if mask is None else jnp.asarray(mask))
    _close(got, want, name)


def test_masked_mean_floors_its_denominator_at_one():
    zero = torch.zeros(4)
    assert float(losses.mse(torch.ones(4, 3), torch.zeros(4, 3), zero)) == 0.0


def test_eval_line_layout():
    results = {"train": {"rmse": 25.123456789}, "test": {"rmse": 1.5}}
    assert eval_line(3, results) == jax_eval_line(3, results) == \
        "[3]\ttrain-rmse:25.123457\ttest-rmse:1.500000"


# -- optimizers --------------------------------------------------------------

@pytest.mark.parametrize("name,kw", [
    ("sgd", {}), ("sgd", {"weight_decay": 0.1}), ("momentum", {}),
    ("momentum", {"nesterov": True}), ("rmsprop", {}), ("adam", {}),
    ("adam", {"weight_decay": 0.01})])
def test_optimizer_updates_match_jax(name, kw):
    """Two updates on the same numpy gradients: updates, params and state."""
    rng = np.random.default_rng(1)
    params = {"a": rng.normal(size=(5, 3)).astype(np.float32),
              "b": rng.normal(size=(3,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(2)]
    mine = getattr(optim, name)(0.01, **kw)
    theirs = getattr(jax_optim, name)(0.01, **kw)
    p = {k: torch.from_numpy(v) for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    s, js = mine.init(p), theirs.init(jp)
    for g in grads:
        upd, s = mine.update({k: torch.from_numpy(v) for k, v in g.items()},
                             s, p)
        jupd, js = theirs.update({k: jnp.asarray(v) for k, v in g.items()},
                                 js, jp)
        p, jp = optim.apply_updates(p, upd), jax_optim.apply_updates(jp, jupd)
        for k in params:
            _close(upd[k], jupd[k], f"update {k}")
            _close(p[k], jp[k], f"param {k}")
    for key, value in js.items() if isinstance(js, dict) else ():
        if isinstance(value, dict):
            for k in value:
                _close(s[key][k], value[k], f"{key}.{k}")
        else:
            assert int(s[key]) == int(value) == 2


def test_adam_is_not_torch_adam():
    """eps outside the bias correction: the first step on a gradient of
    1e-6 is lr * 0.76, where torch.optim.Adam's m_hat / (sqrt(v_hat) + eps)
    gives lr * g / (|g| + eps) = lr * 0.99."""
    p = {"w": torch.zeros(1)}
    g = 1e-6
    upd, _ = optim.adam(1.0).update({"w": torch.full((1,), g)},
                                    optim.adam(1.0).init(p), p)
    torch_adam_step = -g / (abs(g) + 1e-8)
    assert abs(float(upd["w"]) - torch_adam_step) > 0.2
    np.testing.assert_allclose(float(upd["w"]), -0.7597, rtol=1e-3)


def test_unknown_optimizer():
    with pytest.raises(ValueError, match="unknown optimizer"):
        optim.from_config("lion", 1e-3)


def _two_updates(opt):
    """The second update of ``opt`` from fixed params and gradients."""
    rng = np.random.default_rng(5)
    p = {"w": torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32))}
    s = opt.init(p)
    for _ in range(2):
        g = {"w": torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32))}
        upd, s = opt.update(g, s, p)
    return upd["w"]


@pytest.mark.parametrize("name,override", [
    ("adam", "beta1=0.5"), ("adam", "beta2=0.9"), ("adam", "weight_decay=0.1"),
    ("momentum", "momentum=0.5"), ("momentum", "weight_decay=0.1"),
    ("sgd", "weight_decay=0.1"), ("rmsprop", "weight_decay=0.1")])
def test_train_config_reaches_the_optimizer(name, override):
    """Each train.* optimizer field moves the update, and the defaults
    give the maker's own defaults."""
    from euromillioner_tpu_torch.config import Config, apply_overrides

    base = apply_overrides(Config(), [f"train.optimizer={name}"]).train
    tuned = apply_overrides(Config(), [f"train.optimizer={name}",
                                       f"train.{override}"]).train
    default = _two_updates(optim.from_config(name, base.learning_rate))
    assert torch.equal(_two_updates(optim.from_train_config(base)), default)
    assert not torch.allclose(_two_updates(optim.from_train_config(tuned)),
                              default)


# -- one Trainer step --------------------------------------------------------

def _batch(seed, b=16, t=8, pad=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, 11)).astype(np.float32)
    y = rng.normal(loc=20, scale=10, size=(b, 7)).astype(np.float32)
    x[b - pad:], y[b - pad:] = x[0], y[0]
    mask = np.r_[np.ones(b - pad), np.zeros(pad)].astype(np.float32)
    return x, y, mask


def _rolled(model):
    """The JAX model with its scans left rolled (unroll 1): the same
    arithmetic, a smaller program for XLA to compile."""
    for _, layer in model.named_layers():
        if hasattr(layer, "unroll"):
            layer.unroll = 1
    return model


@pytest.fixture(scope="module")
def jax_pair():
    """A 2-layer h32 LSTM initialised in JAX, and one JAX Trainer step."""
    model = _rolled(jax_build_lstm(hidden=32, num_layers=2, fused="off"))
    tr = JaxTrainer(model, jax_optim.adam(1e-3), precision=JAX_PARITY)
    state = tr.init_state(jax.random.PRNGKey(4), (8, 11))
    x, y, mask = _batch(0)
    new, loss = jax.jit(tr._step)(
        state, JaxBatch(x=jnp.asarray(x), y=jnp.asarray(y),
                        mask=jnp.asarray(mask)), jax.random.PRNGKey(0))
    return tr, state, jax.device_get(new), float(loss)


@pytest.mark.parametrize("fused", ["on", "off"])
def test_train_step_matches_jax_step(jax_pair, fused):
    """Loss, updated params and adam moments after one step; 'on' runs
    the K1+K2 Function (plain versions on the CPU), 'off' the scan."""
    _, state, jnew, jloss = jax_pair
    model = build_lstm(32, 2, 7, fused=fused, device="cpu")
    trainer = Trainer(model, optim.adam(1e-3), precision=PARITY)
    st = trainer.init_state(params_from_jax(jax.device_get(state.params),
                                            "cpu"))
    x, y, mask = _batch(0)
    new, loss = trainer.train_step(st, trainer._place(Batch(x, y, mask)))
    _close(loss, jloss, "loss")
    want = _flat(jnew.params)
    assert set(new.params) == set(want)
    for k, v in want.items():
        _close(new.params[k], v, k)
        _close(new.opt_state["mu"][k], _flat(jnew.opt_state["mu"])[k], k)
        _close(new.opt_state["nu"][k], _flat(jnew.opt_state["nu"])[k], k)
    assert int(new.step) == int(jnew.step) == 1
    assert int(new.opt_state["count"]) == 1


# one bf16 step (the default compute dtype) with fused='on': the JAX side
# runs the Pallas pair in interpret mode, the port the plain K1/K2 with the
# kernels' semantics. Measured at H=128, B=16, T=8: loss 6.1e-8 relative;
# adam's mu (0.1 x the gradient) at most 6.6e-3 of its scale (the biases,
# whose sums round to bf16 at another place in XLA than in PyTorch: one
# bf16 ulp), the LSTM weights 8.9e-5; updated params 3.8e-5 absolute.
# Pinned as the Wide&Deep bf16 step is: loss 1e-6, mu two bf16 ulps
# (2^-6) of its scale, params 1e-4 (adam's first step is about +-lr).
BF16_STEP_TOL = {"loss": 1e-6, "mu": 2.0 ** -6, "params": 1e-4}


def test_bf16_fused_train_step_matches_jax_step():
    """Loss, gradients (through adam's first moment) and updated params of
    one step at the default bfloat16 compute dtype, from JAX-initialised
    params carried across."""
    from euromillioner_tpu.core.precision import Precision as JaxPrecision
    from euromillioner_tpu_torch.core.precision import DEFAULT_PRECISION

    model = _rolled(jax_build_lstm(hidden=128, num_layers=1, fused="on"))
    tr = JaxTrainer(model, jax_optim.adam(1e-3),
                    precision=JaxPrecision(compute_dtype=jnp.bfloat16))
    state = tr.init_state(jax.random.PRNGKey(4), (8, 11))
    x, y, mask = _batch(0)
    jnew, jloss = jax.jit(tr._step)(
        state, JaxBatch(x=jnp.asarray(x), y=jnp.asarray(y),
                        mask=jnp.asarray(mask)), jax.random.PRNGKey(0))
    jnew = jax.device_get(jnew)
    assert DEFAULT_PRECISION.compute_dtype == torch.bfloat16
    trainer = Trainer(build_lstm(128, 1, 7, fused="on", device="cpu"),
                      optim.adam(1e-3), precision=DEFAULT_PRECISION)
    st = trainer.init_state(params_from_jax(jax.device_get(state.params),
                                            "cpu"))
    new, loss = trainer.train_step(st, trainer._place(Batch(x, y, mask)))
    assert abs(float(loss) - float(jloss)) <= (BF16_STEP_TOL["loss"]
                                               * abs(float(jloss)))
    want_p, want_mu = _flat(jnew.params), _flat(jnew.opt_state["mu"])
    assert set(new.params) == set(want_p)
    for k in want_p:
        mu = new.opt_state["mu"][k].numpy()
        rel = np.abs(mu - want_mu[k]).max() / np.abs(want_mu[k]).max()
        assert rel <= BF16_STEP_TOL["mu"], f"{k}: mu rel {rel}"
        np.testing.assert_allclose(new.params[k].numpy(), want_p[k], rtol=0,
                                   atol=BF16_STEP_TOL["params"], err_msg=k)


def test_non_finite_loss_raises_before_checkpoint(tmp_path):
    model = build_lstm(8, 1, 7, device="cpu")
    trainer = Trainer(model, optim.sgd(1e30), precision=PARITY)
    x, y, _ = _batch(1, b=16)
    ds = Dataset(x=x, y=y * 1e20)
    with pytest.raises(TrainError, match="non-finite"):
        trainer.fit(trainer.init_state(), ds, epochs=2, batch_size=8,
                    checkpoint_dir=str(tmp_path), checkpoint_every=1)
    assert list(tmp_path.iterdir()) == []


def _tiny_trainer(**kw):
    model = build_lstm(8, 1, 7, device="cpu",
                       generator=torch.Generator().manual_seed(6))
    return Trainer(model, optim.adam(1e-3), precision=PARITY, **kw)


def test_fit_writes_watch_records_and_summary(tmp_path, caplog):
    jsonl = tmp_path / "m.jsonl"
    trainer = _tiny_trainer(metrics_jsonl=str(jsonl))
    x, y, _ = _batch(5, b=20)
    ds = Dataset(x=x, y=y)
    with caplog.at_level(logging.INFO, logger="euromillioner_tpu_torch"):
        trainer.fit(trainer.init_state(), ds, epochs=2, batch_size=8,
                    watches={"train": ds})
    records = [json.loads(ln) for ln in jsonl.read_text().splitlines()]
    assert [r["round"] for r in records if "round" in r] == [0, 1]
    summary = [r for r in records if r.get("event") == "fit_summary"]
    # 3 steps per epoch; the first is not timed (epoch 0: the warmup
    # step; epoch 1: the interval restarts after the watch evaluation)
    assert len(summary) == 1 and summary[0]["steps"] == 4
    assert summary[0]["examples_per_sec"] > 0
    assert sum("fit done: 2 epochs, 40 examples" in r.getMessage()
               for r in caplog.records) == 1


def test_sigterm_checkpoints_and_stops_at_the_epoch_boundary(tmp_path):
    trainer = _tiny_trainer()
    step = trainer.train_step
    calls = []

    def step_then_sigterm(*a, **kw):
        calls.append(1)
        if len(calls) == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return step(*a, **kw)

    trainer.train_step = step_then_sigterm
    x, y, _ = _batch(6, b=16)
    before = signal.getsignal(signal.SIGTERM)
    state = trainer.fit(trainer.init_state(), Dataset(x=x, y=y), epochs=3,
                        batch_size=8, checkpoint_dir=str(tmp_path))
    assert trainer.preempted and len(calls) == 2 and int(state.step) == 2
    assert signal.getsignal(signal.SIGTERM) == before
    path = port_ck.latest_checkpoint(str(tmp_path))
    assert path.endswith("step_00000001")
    back = port_ck.load_train_state(path, trainer.init_state())
    for k, v in state.params.items():
        assert torch.equal(back.params[k], v)


def test_predict_matches_jax_predict(jax_trainer_h8):
    tr = jax_trainer_h8
    jstate = tr.init_state(jax.random.PRNGKey(2), (8, 11))
    x, y, _ = _batch(7, b=20)
    want = tr.predict(jstate.params, JaxDataset(x=x, y=y), batch_size=8)
    trainer = Trainer(build_lstm(8, 2, 7, device="cpu"), optim.adam(1e-3),
                      precision=PARITY)
    st = trainer.init_state(params_from_jax(jax.device_get(jstate.params),
                                            "cpu"))
    got = trainer.predict(st.params, Dataset(x=x, y=y), batch_size=8)
    assert got.shape == want.shape == (20, 7)
    _close(got, want)


def test_dropout_mask_comes_from_the_generator_on_the_input_device():
    from euromillioner_tpu_torch.nn.layers import Dropout

    x = torch.ones(64, 32)
    drop = Dropout(0.25)
    assert drop.apply(x) is x
    with pytest.raises(ValueError, match="generator"):
        drop.apply(x, train=True)
    out, again = (drop.apply(x, train=True,
                             generator=torch.Generator().manual_seed(1))
                  for _ in range(2))
    assert torch.equal(out, again)
    kept = out != 0
    assert torch.equal(out[kept], torch.full_like(out[kept], 1 / 0.75))
    assert 0.65 < float(kept.float().mean()) < 0.85


def test_fit_with_dropout_is_seeded():
    """A 2-layer fit with dropout between the LSTMs: the per-epoch
    generator lives on the trainer's device, and a seed replays the fit."""
    x, y, _ = _batch(8, b=16)
    finals = []
    for seed in (3, 3, 4):
        model = build_lstm(8, 2, 7, dropout=0.5, device="cpu",
                           generator=torch.Generator().manual_seed(6))
        trainer = Trainer(model, optim.adam(1e-2), precision=PARITY)
        state = trainer.fit(trainer.init_state(), Dataset(x=x, y=y),
                            epochs=2, batch_size=8, seed=seed, shuffle=False)
        finals.append(state.params["0_LSTM.wh"])
    assert torch.equal(finals[0], finals[1])
    assert not torch.equal(finals[0], finals[2])


def test_epoch_seeds_depend_on_seed_and_epoch_only():
    assert epoch_seeds(3, 5) == epoch_seeds(3, 5)
    assert len({epoch_seeds(s, e) for s in (0, 1) for e in (0, 1)}) == 4


def test_check_predicts():
    a = np.arange(6, dtype=np.float32).reshape(3, 2)
    assert check_predicts(a, a.copy())
    assert not check_predicts(a, a + 1e-7)
    assert check_predicts(a, a + 1e-7, atol=1e-6)
    assert not check_predicts(a, a[:2])


# -- the golden trajectory ---------------------------------------------------

def test_fit_reproduces_the_golden_trajectory():
    """tests/golden/make_nn_trajectory.py's fit (h32, 1 layer, seq 8, adam
    1e-3, batch 256, shuffle off, 6 epochs) from the JAX package's
    initialisation, run by the port. The pin was generated under jax's
    pre-0.5 default key derivation (``jax_threefry_partitionable`` off):
    the init is drawn under that setting so the parameters are the pin's.
    Measured against the pin: train rmse exact, test within 1.9e-6."""
    pin = json.loads((GOLDEN / "nn_trajectory.json").read_text())
    with jax.threefry_partitionable(False):
        jparams, _ = jax_build_lstm(hidden=pin["hidden"], num_layers=1,
                                    fused="off").init(
            jax.random.PRNGKey(0), (pin["seq_len"], 11))
    tr, va = pipeline_from_html((GOLDEN / "euromillions.html").read_text())
    x, y = make_sequences(tr.full_rows(), pin["seq_len"])
    xv, yv = make_sequences(va.full_rows(), pin["seq_len"])
    tr, va = Dataset(x=x, y=y), Dataset(x=xv, y=yv)
    trainer = Trainer(build_lstm(pin["hidden"], 1, 7, fused="off",
                                 device="cpu"),
                      optim.adam(1e-3), loss="mse", precision=PARITY)
    state = trainer.init_state(params_from_jax(jax.device_get(jparams),
                                               "cpu"))
    got = {"train": [], "test": []}
    for _ in range(pin["n_epochs"]):
        state = trainer.fit(state, tr, epochs=1, batch_size=256,
                            shuffle=False)
        got["train"].append(trainer.evaluate(state.params, tr)["rmse"])
        got["test"].append(trainer.evaluate(state.params, va)["rmse"])
    for name in ("train", "test"):
        np.testing.assert_allclose(got[name], pin["trajectory"][name],
                                   rtol=1e-5, atol=1e-6,
                                   err_msg=f"{name} rmse trajectory")


# -- checkpoints, both ways ---------------------------------------------------

@pytest.fixture(scope="module")
def jax_trainer_h8():
    model = _rolled(jax_build_lstm(hidden=8, num_layers=2, fused="off"))
    return JaxTrainer(model, jax_optim.adam(1e-3), precision=JAX_PARITY)


def _port_state_after_a_step():
    model = build_lstm(8, 2, 7, device="cpu",
                       generator=torch.Generator().manual_seed(2))
    trainer = Trainer(model, optim.adam(1e-3), precision=PARITY)
    x, y, mask = _batch(2)
    state, _ = trainer.train_step(trainer.init_state(),
                                  trainer._place(Batch(x, y, mask)))
    return trainer, state


def test_port_train_state_loads_in_jax(jax_trainer_h8, tmp_path):
    _, state = _port_state_after_a_step()
    path = port_ck.save_checkpoint(str(tmp_path), state, step=1)
    like = jax_trainer_h8.init_state(jax.random.PRNGKey(0), (8, 11))
    got = jax.device_get(jax_load_checkpoint(path, like))
    for k, v in _flat(got.params).items():
        np.testing.assert_array_equal(v, state.params[k].numpy())
    for moment in ("mu", "nu"):
        for k, v in _flat(got.opt_state[moment]).items():
            np.testing.assert_array_equal(
                v, state.opt_state[moment][k].numpy())
    assert int(got.opt_state["count"]) == 1 and int(got.step) == 1


def test_jax_train_state_resumes_in_the_port(jax_trainer_h8, tmp_path):
    """A JAX-written TrainState (after one JAX step) restores whole into
    the port, and the next step matches the JAX package's next step."""
    tr = jax_trainer_h8
    state = tr.init_state(jax.random.PRNGKey(1), (8, 11))
    batches = [_batch(s) for s in (3, 4)]
    jb = [JaxBatch(*map(jnp.asarray, b)) for b in batches]
    step = jax.jit(tr._step)
    state, _ = step(state, jb[0], jax.random.PRNGKey(0))
    jax_save_checkpoint(str(tmp_path), state, step=1)
    after, jloss = step(state, jb[1], jax.random.PRNGKey(0))

    trainer = Trainer(build_lstm(8, 2, 7, device="cpu"), optim.adam(1e-3),
                      precision=PARITY)
    path = port_ck.latest_checkpoint(str(tmp_path))
    restored = port_ck.load_train_state(path, trainer.init_state())
    for k, v in _flat(jax.device_get(state.params)).items():
        np.testing.assert_array_equal(restored.params[k].numpy(), v)
    assert int(restored.step) == int(restored.opt_state["count"]) == 1
    new, loss = trainer.train_step(restored,
                                   trainer._place(Batch(*batches[1])))
    _close(loss, jloss, "loss")
    for k, v in _flat(jax.device_get(after.params)).items():
        _close(new.params[k], v, k)
    assert int(new.opt_state["count"]) == 2


def test_load_train_state_rejects_another_optimizer(tmp_path):
    trainer, state = _port_state_after_a_step()
    path = port_ck.save_checkpoint(str(tmp_path), state, step=1)
    sgd = Trainer(trainer.model, optim.sgd(0.1), precision=PARITY)
    with pytest.raises(Exception, match="TrainState"):
        port_ck.load_train_state(path, sgd.init_state())


# -- the CLI -----------------------------------------------------------------

TINY = ["model.lstm_hidden=32", "model.lstm_layers=1", "model.seq_len=8",
        "model.compute_dtype=float32"]


def test_cli_trains_then_serves_on_cpu(tmp_path, caplog, capsys):
    ck = str(tmp_path / "ck")
    with caplog.at_level(logging.INFO, logger="euromillioner_tpu_torch"):
        rc = cli.main(["train", "--model", "lstm", "--html-file",
                       str(GOLDEN / "euromillions.html"), "--device", "cpu",
                       *TINY, "train.epochs=1", "--save", ck])
    assert rc == 0
    lines = [r.getMessage() for r in caplog.records
             if r.getMessage().startswith("[0]\t")]
    assert len(lines) == 1
    fields = dict(f.split(":") for f in lines[0].split("\t")[1:])
    assert set(fields) == {"train-rmse", "test-rmse"}
    assert all(np.isfinite(float(v)) for v in fields.values())
    capsys.readouterr()
    rc = cli.main(["serve", "--model-type", "lstm", "--checkpoint", ck,
                   "--smoke", "4", "--device", "cpu", *TINY])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["failed"] == 0 and summary["ok"] == 4


@pytest.mark.parametrize("argv,rc", [
    (["data.url=http://127.0.0.1:9/results"], 10),  # nothing listens:
                                                   # FetchError
    (["--html-file", "missing.html", "train.no_such=1"], 2),
])
def test_cli_train_errors(argv, rc):
    assert cli.main(["train", "--device", "cpu", *TINY, *argv]) == rc


def test_cli_train_without_cuda_exits_17(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["train", "--html-file",
                     str(GOLDEN / "euromillions.html"), *TINY]) == 17
