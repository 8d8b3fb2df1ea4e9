"""The port's MLP family (BASELINE.json config 1) against the JAX package's,
on the CPU: the new layers (Embedding, LayerNorm, Activation, Flatten) and
losses (sigmoid BCE, softmax cross-entropy, accuracy), ``build_mlp``'s
layer names and forward, one Trainer step under mse and bce from
JAX-initialised params, the bce watch metric, checkpoints both ways, and
``train --model mlp`` → ``serve --model-type mlp`` through the CLI."""

import json
import logging
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euromillioner_tpu import nn as jax_nn
from euromillioner_tpu.core.precision import PARITY as JAX_PARITY
from euromillioner_tpu.data.dataset import Batch as JaxBatch
from euromillioner_tpu.data.dataset import Dataset as JaxDataset
from euromillioner_tpu.models.mlp import build_mlp as jax_build_mlp
from euromillioner_tpu.nn import losses as jax_losses
from euromillioner_tpu.train import optim as jax_optim
from euromillioner_tpu.train.checkpoint import \
    save_checkpoint as jax_save_checkpoint
from euromillioner_tpu.train.trainer import Trainer as JaxTrainer
from euromillioner_tpu_torch import cli, nn
from euromillioner_tpu_torch.config import Config, apply_overrides
from euromillioner_tpu_torch.core.precision import PARITY
from euromillioner_tpu_torch.data.dataset import Batch, Dataset
from euromillioner_tpu_torch.models.convert import params_from_jax
from euromillioner_tpu_torch.models.mlp import build_mlp
from euromillioner_tpu_torch.models.registry import (build_model,
                                                     default_in_shape)
from euromillioner_tpu_torch.nn import losses
from euromillioner_tpu_torch.serve.session import load_backend
from euromillioner_tpu_torch.train import checkpoint as port_ck
from euromillioner_tpu_torch.train import optim
from euromillioner_tpu_torch.train.trainer import Trainer

torch.set_num_threads(2)

GOLDEN = pathlib.Path(__file__).parent / "golden" / "euromillions.html"
HIDDEN = (16, 16)
# f32 on both sides; XLA CPU and PyTorch CPU sum products and reductions
# in other orders. Measured: the layers, losses and the MLP forward within
# 4.8e-7 abs; one Trainer step (mse and bce: loss, params, adam moments)
# within 9.5e-7 abs; watch metrics and predict within 2.4e-7 abs. Pinned
# at the JAX package's NN trajectory pin (tests/test_train.py:241-243).
RTOL, ATOL = 1e-5, 1e-6


def _close(got, want, err_msg=""):
    if isinstance(got, torch.Tensor):
        got = got.detach().cpu().numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=RTOL,
                               atol=ATOL, err_msg=err_msg)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _jax_mlp(dropout=0.0, seed=0, in_features=10):
    model = jax_build_mlp(HIDDEN, out_dim=1, dropout=dropout)
    params, _ = model.init(jax.random.PRNGKey(seed), (in_features,))
    return model, jax.device_get(params)


def _port_mlp(jax_params, dropout=0.0, in_features=10):
    model = build_mlp(HIDDEN, out_dim=1, dropout=dropout,
                      in_features=in_features, device="cpu")
    model.load_state_dict(params_from_jax(jax_params, "cpu"))
    return model


# -- layers and losses -------------------------------------------------------

@pytest.mark.parametrize("layer", ["Embedding", "LayerNorm", "Activation",
                                   "Flatten"])
def test_new_layers_match_jax(layer):
    """Each layer's leaves (names and shapes) and its forward, from the
    JAX layer's init."""
    rng = np.random.default_rng(2)
    gen = torch.Generator().manual_seed(0)
    if layer == "Embedding":
        jl, pl = jax_nn.Embedding(13, 6), nn.Embedding(13, 6, generator=gen,
                                                       device="cpu")
        x, in_shape = rng.integers(0, 13, size=(5, 4)).astype(np.float32), (4,)
    elif layer == "LayerNorm":
        jl, pl = jax_nn.LayerNorm(), nn.LayerNorm(7, device="cpu")
        x, in_shape = rng.normal(3, 2, size=(5, 7)).astype(np.float32), (7,)
    elif layer == "Activation":
        jl, pl = jax_nn.Activation("gelu"), nn.Activation("gelu")
        x, in_shape = rng.normal(size=(5, 7)).astype(np.float32), (7,)
    else:
        jl, pl = jax_nn.Flatten(), nn.Flatten()
        x, in_shape = rng.normal(size=(5, 3, 4)).astype(np.float32), (3, 4)
    params, out_shape = jl.init(jax.random.PRNGKey(1), in_shape)
    if layer == "LayerNorm":  # non-trivial scale and bias
        params = {k: v + rng.normal(size=v.shape).astype(np.float32)
                  for k, v in params.items()}
    params = jax.device_get(params)
    assert pl.name == jl.name
    assert {k: tuple(v.shape) for k, v in pl.state_dict().items()} == \
        {k: tuple(np.shape(v)) for k, v in params.items()}
    pl.load_state_dict({k: torch.from_numpy(np.array(v))
                        for k, v in params.items()})
    got = pl.apply(torch.from_numpy(x))
    want = jl.apply(params, jnp.asarray(x))
    assert tuple(got.shape) == tuple(want.shape) == (5, *out_shape)
    _close(got, want, layer)


@pytest.mark.parametrize("name", ["sigmoid_binary_cross_entropy",
                                  "softmax_cross_entropy", "accuracy"])
@pytest.mark.parametrize("masked", [False, True])
def test_new_losses_match_jax(name, masked):
    rng = np.random.default_rng(0)
    logits = rng.normal(scale=4, size=(12, 5)).astype(np.float32)
    if name == "sigmoid_binary_cross_entropy":
        label = (rng.uniform(size=(12, 5)) > 0.5).astype(np.float32)
    elif name == "softmax_cross_entropy":
        label = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 12)]
    else:
        label = rng.integers(0, 5, 12)
    mask = (np.r_[np.ones(9), np.zeros(3)].astype(np.float32) if masked
            else None)
    got = getattr(losses, name)(
        torch.from_numpy(logits), torch.from_numpy(label),
        None if mask is None else torch.from_numpy(mask))
    want = getattr(jax_losses, name)(
        jnp.asarray(logits), jnp.asarray(label),
        None if mask is None else jnp.asarray(mask))
    _close(got, want, name)


# -- the model ---------------------------------------------------------------

@pytest.mark.parametrize("dropout", [0.0, 0.25])
def test_build_mlp_names_and_shapes_are_jax(dropout):
    _, params = _jax_mlp(dropout)
    model = build_mlp(HIDDEN, dropout=dropout, device="cpu")
    want = {k: v.shape for k, v in _flat(params).items()}
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == want
    names = [n for n, _ in model.named_layers()]
    assert names == list(params)  # 0_Dense, (1_Dropout,) ... in JAX order


def test_mlp_forward_matches_jax():
    jm, params = _jax_mlp()
    model = _port_mlp(params)
    x = np.random.default_rng(1).normal(size=(9, 10)).astype(np.float32)
    _close(model.apply(torch.from_numpy(x)), jm.apply(params, jnp.asarray(x)))


def test_registry_builds_the_mlp():
    cfg = apply_overrides(Config(), ["model.hidden_sizes=16,16"])
    assert cfg.model.name == "mlp" and cfg.model.hidden_sizes == HIDDEN
    assert Config().model.hidden_sizes == (256, 256)
    assert default_in_shape(cfg.model) == (10,)
    model = build_model(cfg.model, in_features=10,
                        generator=torch.Generator().manual_seed(0),
                        device="cpu")
    _, params = _jax_mlp()
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        {k: v.shape for k, v in _flat(params).items()}


def test_build_mlp_without_a_card_is_refused(monkeypatch):
    from euromillioner_tpu_torch.utils.errors import ConfigError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ConfigError, match="no CUDA device"):
        build_mlp(HIDDEN)


# -- training ----------------------------------------------------------------

def _batch(loss, seed=0, b=16, pad=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, 10)).astype(np.float32)
    y = (rng.uniform(size=b) > 0.5).astype(np.float32) if loss == "bce" \
        else rng.normal(loc=2, scale=1, size=b).astype(np.float32)
    x[b - pad:], y[b - pad:] = x[0], y[0]
    mask = np.r_[np.ones(b - pad), np.zeros(pad)].astype(np.float32)
    return x, y, mask


@pytest.mark.parametrize("loss", ["mse", "bce"])
def test_train_step_matches_jax_step(loss):
    """Loss, updated params and adam moments after one f32 step from the
    same JAX-initialised params on the same (padded) batch."""
    jm, _ = _jax_mlp()
    jtr = JaxTrainer(jm, jax_optim.adam(1e-2), loss=loss,
                     precision=JAX_PARITY)
    state = jtr.init_state(jax.random.PRNGKey(3), (10,))
    x, y, mask = _batch(loss)
    jnew, jloss = jax.jit(jtr._step)(
        state, JaxBatch(x=jnp.asarray(x), y=jnp.asarray(y),
                        mask=jnp.asarray(mask)), jax.random.PRNGKey(0))
    jnew = jax.device_get(jnew)
    trainer = Trainer(build_mlp(HIDDEN, device="cpu"), optim.adam(1e-2),
                      loss=loss, precision=PARITY)
    st = trainer.init_state(params_from_jax(jax.device_get(state.params),
                                            "cpu"))
    new, ploss = trainer.train_step(st, trainer._place(Batch(x, y, mask)))
    _close(ploss, jloss, "loss")
    for k, v in _flat(jnew.params).items():
        _close(new.params[k], v, k)
        _close(new.opt_state["mu"][k], _flat(jnew.opt_state["mu"])[k], k)
        _close(new.opt_state["nu"][k], _flat(jnew.opt_state["nu"])[k], k)


@pytest.mark.parametrize("loss,metric", [("mse", "rmse"),
                                         ("bce", "logloss")])
def test_watch_metric_and_predict_match_jax(loss, metric):
    """The default watch metric of each loss (rmse on raw outputs, logloss
    on sigmoid probabilities) and ``predict``, over a dataset larger than
    one eval chunk."""
    jm, _ = _jax_mlp()
    jtr = JaxTrainer(jm, jax_optim.adam(1e-2), loss=loss,
                     precision=JAX_PARITY)
    params = jtr.init_state(jax.random.PRNGKey(5), (10,)).params
    x, y, _ = _batch(loss, seed=4, b=40, pad=0)
    trainer = Trainer(build_mlp(HIDDEN, device="cpu"), optim.adam(1e-2),
                      loss=loss, precision=PARITY)
    assert trainer.eval_metric == jtr.eval_metric == metric
    pparams = params_from_jax(jax.device_get(params), "cpu")
    got = trainer.evaluate(pparams, Dataset(x, y), batch_size=16)
    want = jtr.evaluate(params, JaxDataset(x, y), batch_size=16)
    assert set(got) == set(want) == {metric}
    _close(got[metric], want[metric], metric)
    _close(trainer.predict(pparams, Dataset(x, y), batch_size=16),
           jtr.predict(params, JaxDataset(x, y), batch_size=16), "predict")


def test_jax_mlp_checkpoint_serves_in_the_port(tmp_path):
    """A TrainState the JAX package saved restores in the port's
    ``load_backend`` and predicts as the JAX package's backend does."""
    from euromillioner_tpu.config import Config as JaxConfig
    from euromillioner_tpu.serve.session import load_backend as jax_load

    jm, _ = _jax_mlp()
    tr = JaxTrainer(jm, jax_optim.adam(1e-3), precision=JAX_PARITY)
    jax_save_checkpoint(str(tmp_path), tr.init_state(jax.random.PRNGKey(7),
                                                     (10,)), step=3)
    over = ["model.hidden_sizes=16,16", "model.compute_dtype=float32"]
    jcfg = JaxConfig()
    jcfg.model.hidden_sizes, jcfg.model.compute_dtype = HIDDEN, "float32"
    rows = np.random.default_rng(8).normal(size=(8, 10)).astype(np.float32)
    got = load_backend("mlp", str(tmp_path), apply_overrides(Config(), over),
                       device="cpu").predict(rows)
    want = jax_load("mlp", checkpoint=str(tmp_path), cfg=jcfg).predict(rows)
    assert got.shape == want.shape == (8, 1)
    _close(got, want)


def test_port_mlp_checkpoint_restores_in_jax(tmp_path):
    """The port's TrainState restores in the JAX package's Trainer with
    the same leaves."""
    from euromillioner_tpu.train.checkpoint import \
        load_checkpoint as jax_load_checkpoint

    trainer = Trainer(build_mlp(HIDDEN, device="cpu"), optim.adam(1e-3))
    state = trainer.init_state()
    port_ck.save_checkpoint(str(tmp_path), state, step=2)
    jm, _ = _jax_mlp()
    like = JaxTrainer(jm, jax_optim.adam(1e-3)).init_state(
        jax.random.PRNGKey(0), (10,))
    restored = jax_load_checkpoint(port_ck.latest_checkpoint(str(tmp_path)),
                                   like)
    for k, v in _flat(jax.device_get(restored.params)).items():
        np.testing.assert_array_equal(v, state.params[k].numpy(), err_msg=k)


# -- the CLI -----------------------------------------------------------------

def test_cli_trains_the_default_mlp_then_serves(tmp_path, caplog, capsys):
    """``train --model mlp`` at the ModelConfig defaults (hidden 256, 256)
    on the golden page's 10 label-dropped features with mse and the
    {train, test} watches, then ``serve --model-type mlp --smoke 8``."""
    ck = str(tmp_path / "ck")
    with caplog.at_level(logging.INFO, logger="euromillioner_tpu_torch"):
        rc = cli.main(["train", "--model", "mlp", "--html-file", str(GOLDEN),
                       "--device", "cpu", "train.epochs=1", "--save", ck])
    assert rc == 0
    lines = [r.getMessage() for r in caplog.records
             if r.getMessage().startswith("[0]\t")]
    assert len(lines) == 1
    fields = dict(f.split(":") for f in lines[0].split("\t")[1:])
    assert set(fields) == {"train-rmse", "test-rmse"}
    assert all(np.isfinite(float(v)) for v in fields.values())
    saved = port_ck.load_checkpoint(port_ck.latest_checkpoint(ck))
    assert {k: tuple(v.shape) for k, v in saved.items()} == {
        "0_Dense.kernel": (10, 256), "0_Dense.bias": (256,),
        "1_Dense.kernel": (256, 256), "1_Dense.bias": (256,),
        "2_Dense.kernel": (256, 1), "2_Dense.bias": (1,)}
    capsys.readouterr()
    assert cli.main(["serve", "--model-type", "mlp", "--checkpoint", ck,
                     "--smoke", "8", "--device", "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["failed"] == 0 and summary["ok"] == 8
    preds = np.asarray(summary["predictions"], np.float32)
    assert preds.shape == (8, 1, 1) and np.isfinite(preds).all()


def test_cli_mlp_errors():
    """Serving without a checkpoint is a ServeError (16); training from a
    ``data.url`` nothing answers a FetchError (10)."""
    assert cli.main(["serve", "--model-type", "mlp", "--smoke", "2",
                     "--device", "cpu"]) == 16
    assert cli.main(["train", "--model", "mlp", "--device", "cpu",
                     "data.url=http://127.0.0.1:9/results"]) == 10
