"""EMT1 bytes and checkpoints across the two packages: the port writes the
JAX package's bytes, restores the params of a checkpoint the JAX package
wrote, serves them as the JAX package does, and refuses a corrupt one."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euromillioner_tpu import config as jax_config
from euromillioner_tpu.core.precision import from_names
from euromillioner_tpu.models.lstm import build_lstm as jax_build_lstm
from euromillioner_tpu.serve.continuous import \
    load_recurrent_backend as jax_load_backend
from euromillioner_tpu.train.checkpoint import \
    save_checkpoint as jax_save_checkpoint
from euromillioner_tpu.train.optim import from_config
from euromillioner_tpu.train.trainer import Trainer
from euromillioner_tpu.utils import serialization as jax_ser
from euromillioner_tpu_torch.config import Config, apply_overrides
from euromillioner_tpu_torch.models.lstm import build_lstm
from euromillioner_tpu_torch.serve.continuous import load_recurrent_backend
from euromillioner_tpu_torch.train import checkpoint as port_ck
from euromillioner_tpu_torch.utils import serialization as port_ser
from euromillioner_tpu_torch.utils.errors import CheckpointError

torch.set_num_threads(2)

TINY = ["model.lstm_hidden=8", "model.lstm_layers=2", "model.seq_len=8",
        "model.compute_dtype=float32"]
# f32 on both sides, same weights (the JAX NN trajectory pin)
RTOL = 1e-5
ATOL = 1e-6


def _arrays():
    rng = np.random.default_rng(0)
    return {
        "f32": rng.normal(size=(3, 5)).astype(np.float32),
        "i32": rng.integers(-9, 9, size=(7,)).astype(np.int32),
        # exactly representable in bfloat16, so every conversion agrees
        "bf16": (rng.integers(-64, 64, size=(2, 4)) / 8).astype(np.float32),
        "scalar": np.asarray(3, np.int32),
    }


def test_dumps_bytes_identical_to_jax():
    arrs = _arrays()
    jax_in = dict(arrs, bf16=np.asarray(jnp.asarray(arrs["bf16"],
                                                    jnp.bfloat16)))
    want = jax_ser.dumps(jax_in)
    # numpy inputs (the bfloat16 one as jax's ml_dtypes array)
    assert port_ser.dumps(jax_in) == want
    # torch tensors, the bfloat16 one a torch bfloat16 tensor
    torch_in = {k: torch.from_numpy(np.array(v)) for k, v in arrs.items()}
    torch_in["bf16"] = torch_in["bf16"].to(torch.bfloat16)
    assert port_ser.dumps(torch_in) == want


def test_loads_reads_jax_bytes_bf16_included():
    arrs = _arrays()
    blob = jax_ser.dumps(dict(arrs, bf16=np.asarray(
        jnp.asarray(arrs["bf16"], jnp.bfloat16))))
    got = port_ser.loads(blob)
    assert got["bf16"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["bf16"].float().numpy(), arrs["bf16"])
    for k in ("f32", "i32", "scalar"):
        assert got[k].numpy().dtype == arrs[k].dtype
        np.testing.assert_array_equal(got[k].numpy(), arrs[k])
    assert got["scalar"].shape == ()


def test_loads_rejects_corruption():
    blob = bytearray(port_ser.dumps({"a": np.arange(16, dtype=np.float32)}))
    with pytest.raises(CheckpointError, match="magic"):
        port_ser.loads(b"NOPE" + bytes(blob[4:]))
    blob[-10] ^= 0xFF
    with pytest.raises(CheckpointError, match="CRC"):
        port_ser.loads(bytes(blob))
    with pytest.raises(CheckpointError):
        port_ser.loads(bytes(blob[:20]))


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """A tiny LSTM checkpoint as the JAX package writes it: the full
    TrainState (params, adam state, step) of Trainer.init_state."""
    d = tmp_path_factory.mktemp("jax_ck")
    model = jax_build_lstm(hidden=8, num_layers=2)
    tr = Trainer(model, from_config("adam", 1e-3),
                 precision=from_names("float32", "float32"))
    state = tr.init_state(jax.random.PRNGKey(0), (8, 11))
    jax_save_checkpoint(str(d), state, step=3)
    return str(d), jax.device_get(state.params)


def test_restores_jax_checkpoint_params(jax_ckpt):
    d, params = jax_ckpt
    path = port_ck.latest_checkpoint(d)
    assert path.endswith("step_00000003") and port_ck.checkpoint_step(path) == 3
    got = port_ck.load_checkpoint(path)
    flat = {".".join(k.key for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(params)}
    assert set(got) == set(flat)
    for key, want in flat.items():
        np.testing.assert_array_equal(got[key].numpy(), want)


def test_jax_checkpoint_serves_like_jax(jax_ckpt):
    d, _ = jax_ckpt
    cfg = apply_overrides(Config(), TINY)
    port = load_recurrent_backend(cfg, d, device="cpu")
    jcfg = jax_config.apply_overrides(jax_config.Config(), TINY)
    ref = jax_load_backend(jcfg, d)
    rng = np.random.default_rng(1)
    for steps in (2, 8, 13):
        x = rng.normal(size=(steps, 11)).astype(np.float32)
        np.testing.assert_allclose(port.predict(x), ref.predict(x),
                                   rtol=RTOL, atol=ATOL)


def test_port_checkpoint_round_trip_with_jax_leaf_paths(jax_ckpt, tmp_path):
    d, _ = jax_ckpt
    model = build_lstm(8, 2, 7, device="cpu",
                       generator=torch.Generator().manual_seed(5))
    path = port_ck.save_checkpoint(str(tmp_path), model, step=12)
    assert port_ck.verify_checkpoint(path)
    got = port_ck.load_checkpoint(path)
    for key, want in model.state_dict().items():
        assert torch.equal(got[key], want)
    with open(os.path.join(path, "manifest.json")) as fh:
        mine = json.load(fh)["leaf_paths"]
    jax_path = port_ck.latest_checkpoint(d)
    with open(os.path.join(jax_path, "manifest.json")) as fh:
        theirs = [p for p in json.load(fh)["leaf_paths"]
                  if p.startswith(".params")]
    assert mine == theirs + [".step"]


def test_corrupted_shard_raises(jax_ckpt, tmp_path):
    d, _ = jax_ckpt
    model = build_lstm(8, 2, 7, device="cpu")
    path = port_ck.save_checkpoint(str(tmp_path), model, step=1)
    shard = os.path.join(path, "arrays-00000.emt")
    with open(shard, "r+b") as fh:
        fh.seek(200)
        byte = fh.read(1)
        fh.seek(200)
        fh.write(bytes([byte[0] ^ 0xFF]))
    with pytest.raises(CheckpointError):
        port_ck.load_checkpoint(path)
    assert not port_ck.verify_checkpoint(path)
    assert port_ck.latest_checkpoint(str(tmp_path)) is None


def test_mismatched_model_config_raises(jax_ckpt):
    d, _ = jax_ckpt
    cfg = apply_overrides(Config(), TINY + ["model.lstm_hidden=16"])
    with pytest.raises(CheckpointError):
        load_recurrent_backend(cfg, d, device="cpu")
