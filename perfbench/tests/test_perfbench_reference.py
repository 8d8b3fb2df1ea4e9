"""The plain reference agrees with the program's CPU path at tiny sizes,
in float32, on the benchmark's own weights."""

import numpy as np
import torch

from perfbench import harness
from perfbench.reference import lstm as ref_lstm
from perfbench.reference import wide_deep as ref_wd
from perfbench.reference.train import train_steps

LSTM = {**harness.load_json(harness.PKG / "configs" / "lstm_flagship.json"),
        "hidden": 16, "seq_len": 8}
WD = {**harness.load_json(harness.PKG / "configs" / "wide_deep_100m.json"),
      "wide_embed_dim": 8, "embed_dim": 8, "hidden_sizes": [16, 8]}


def _model(fam_name, cfg, seed=3):
    fam = harness.load_part("families", fam_name)
    model = fam.build_model(cfg, "cpu")
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    params = fam.weights(cfg, shapes, seed, "cpu")
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(params[k])
    return fam, model, params


def test_lstm_forward_and_last_step_gather():
    fam, model, params = _model("lstm", LSTM)
    x = torch.randn(5, 8, 11, generator=torch.Generator().manual_seed(1))
    want = model.apply(x)
    got = ref_lstm.forward(params, x, 2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    from euromillioner_tpu_torch.models.lstm import padded_apply
    last = torch.tensor([7, 3, 0, 5, 6])
    want = padded_apply(model, x, last)
    got = fam.serve_reference(LSTM, lambda t: t)(params, x, last)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_wide_deep_forward():
    fam, model, params = _model("wide_deep", {**WD, "train": {
        **WD["train"], "compute_dtype": "float32"}})
    rng = np.random.default_rng(4)
    x = torch.from_numpy(fam.rows(rng, 32))
    x[0, 4] = 80.0   # a ball outside the vocabulary is clipped
    want = model.apply(x)
    got = ref_wd.forward(params, x, 64, 3)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_three_adam_steps_match_the_trainer():
    from euromillioner_tpu_torch.core.precision import PARITY
    from euromillioner_tpu_torch.data.dataset import Batch
    from euromillioner_tpu_torch.train.optim import adam
    from euromillioner_tpu_torch.train.trainer import Trainer

    fam, model, params = _model("lstm", LSTM)
    trainer = Trainer(model, adam(1e-3), precision=PARITY)
    pool = fam.batches(LSTM, {"batch": 6, "pool_batches": 3}, 9)
    state = trainer.init_state(params)
    losses = []
    for x, y in pool:
        placed = trainer._place(Batch(x=x, y=y, mask=np.ones(6, np.float32)))
        state, loss = trainer.train_step(state, placed)
        losses.append(float(loss))
    feed = [(torch.from_numpy(x), torch.from_numpy(y)) for x, y in pool]
    ref_losses, _, ref_params = train_steps(
        fam.reference(LSTM, lambda t: t), params, feed, 1e-3)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-6)
    for k, v in ref_params.items():
        torch.testing.assert_close(state.params[k], v, rtol=1e-5, atol=1e-6)
