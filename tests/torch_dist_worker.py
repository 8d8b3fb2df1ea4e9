"""Rank processes for the port's multi-rank CPU tests (not a test module).

``Ranks(cases, world, out_dir, inputs)`` starts ``world`` processes of
this file, each one rank of a gloo group over ``torch.distributed``; each
runs every case of the set ``cases`` on the numpy ``inputs`` the test
wrote (JAX-initialised parameters, data), and saves what it computed to
``out_dir/rank{r}.pt``. ``results()`` waits with a timeout, kills every
rank still alive in ``finally``, and raises with the ranks' output when
one fails. Ranks import torch and the port only, never jax.

Case sets: ``train`` (collectives, the data-parallel trainer on the MLP,
the LSTM and Wide&Deep, its errors, parameter averaging, checkpoints),
``forest`` (the row-sharded random forest), ``tp`` (tensor parallelism
over ``model``: the MLP, the LSTM and Wide&Deep, sharded checkpoints) and
``seq`` (sequence parallelism over ``seq``: the pipelined chunk scan and
its gradients, the flagship trained on it). ``inputs["mesh"]`` names the
(data, model, seq) mesh, default ``(world, 1, 1)``.
"""

from __future__ import annotations

import os
import pathlib
import socket
import subprocess
import sys
import time
import traceback

ROOT = pathlib.Path(__file__).resolve().parents[1]
# how long a collective waits for a peer, and how long a whole set may run
GROUP_TIMEOUT_S = 60.0
LAUNCH_TIMEOUT_S = 150.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Ranks:
    """``world`` ranks running the case set ``cases`` on ``inputs``,
    started at construction; :meth:`results` waits for them (at most
    ``timeout_s``) and :meth:`close` kills any still alive (callers close
    in ``finally``)."""

    def __init__(self, cases: str, world: int, out_dir, inputs: dict):
        import torch

        self.out_dir = pathlib.Path(out_dir)
        self.cases, self.world = cases, world
        torch.save(inputs, self.out_dir / "inputs.pt")
        env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
        env.pop("EUROMILLIONER_CPU_DEVICES", None)
        address = f"127.0.0.1:{_free_port()}"
        self.logs = [open(self.out_dir / f"rank{r}.log", "w")
                     for r in range(world)]
        self.procs: list[subprocess.Popen] = []
        try:
            for r in range(world):
                self.procs.append(subprocess.Popen(
                    [sys.executable, __file__, cases, str(r), str(world),
                     address, str(self.out_dir)], env=env,
                    stdout=self.logs[r], stderr=subprocess.STDOUT))
        except BaseException:
            self.close()
            raise

    def close(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
        for fh in self.logs:
            fh.close()

    def results(self, timeout_s: float = LAUNCH_TIMEOUT_S) -> list[dict]:
        """Each rank's results, in rank order; RuntimeError with the
        ranks' output when one fails or the set outlasts ``timeout_s``."""
        import torch

        deadline = time.monotonic() + timeout_s
        try:
            while any(p.poll() is None for p in self.procs):
                if any(p.poll() for p in self.procs):
                    break  # a rank failed: the others would wait on it
                if time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            self.close()
        codes = [p.returncode for p in self.procs]
        if any(codes):
            text = "\n".join(
                f"--- rank {r} (exit {c}) ---\n"
                + (self.out_dir / f"rank{r}.log").read_text()[-3000:]
                for r, c in enumerate(codes))
            raise RuntimeError(f"case set {self.cases!r} failed: {codes}"
                               f"\n{text}")
        return [torch.load(self.out_dir / f"rank{r}.pt", weights_only=False)
                for r in range(self.world)]


# -- the rank side -----------------------------------------------------------

def _np(tree):
    """Tensors → numpy (float32 for bf16), dicts/tuples kept."""
    import torch

    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_np(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree


def _solo_mesh(mesh):
    """A group of one for every rank (each rank's own), built collectively."""
    import torch.distributed as dist

    from euromillioner_tpu_torch.core.mesh import Mesh

    groups = [dist.new_group([r]) for r in range(mesh.data)]
    return Mesh(data=1, rank=0, device=mesh.device, group=groups[mesh.rank])


def _fit(trainer, params, ds, epochs, batch_size):
    state = trainer.init_state(params)
    state = trainer.fit(state, ds, epochs=epochs, batch_size=batch_size,
                        shuffle=False, watches={"train": ds})
    return state


def cases_train(mesh, inputs, out):
    import torch
    import torch.distributed as dist

    from euromillioner_tpu_torch.core.precision import PARITY, Precision
    from euromillioner_tpu_torch.data.dataset import Dataset
    from euromillioner_tpu_torch.dist import (DistributedTrainer,
                                              fit_parameter_averaging,
                                              pmean_stacked, psum_stacked,
                                              tree_aggregate)
    from euromillioner_tpu_torch.models.convert import params_from_jax
    from euromillioner_tpu_torch.models.lstm import build_lstm
    from euromillioner_tpu_torch.models.mlp import build_mlp
    from euromillioner_tpu_torch.models.wide_deep import build_wide_deep
    from euromillioner_tpu_torch.core.mesh import Mesh
    from euromillioner_tpu_torch.train.checkpoint import (latest_checkpoint,
                                                          load_train_state,
                                                          save_checkpoint)
    from euromillioner_tpu_torch.train.optim import adam, sgd
    from euromillioner_tpu_torch.train.trainer import Trainer
    from euromillioner_tpu_torch.utils.errors import DistributedError

    r = mesh.rank
    # collectives: each rank's own slice of the stacked arrays
    stk = inputs["stacked"]
    tree = {"a": torch.from_numpy(stk["a"][r]),
            "b": (torch.from_numpy(stk["b"][r]),)}
    out["psum"] = _np(psum_stacked(tree, mesh))
    out["pmean"] = _np(pmean_stacked(tree, mesh))
    ids = torch.from_numpy(inputs["ids"][r])
    out["aggregate"] = _np(tree_aggregate(
        lambda d: torch.zeros(4).index_add_(0, d.long(), torch.ones(
            d.shape[0])), ids, mesh))
    bad = torch.zeros(3 if r == 2 else 2)
    try:
        psum_stacked({"x": bad}, mesh)
        out["mismatch"] = None
    except DistributedError as e:
        out["mismatch"] = str(e)

    solo = _solo_mesh(mesh)
    f32 = PARITY
    for name, spec in inputs["trainers"].items():
        def model():
            if spec["family"] == "mlp":
                return build_mlp(tuple(spec["hidden"]), out_dim=1,
                                 in_features=spec["features"], device="cpu")
            if spec["family"] == "lstm":
                return build_lstm(spec["hidden"], spec["layers"], 7,
                                  device="cpu")
            return build_wide_deep(device="cpu", **spec["kw"])
        precision = (f32 if spec["dtype"] == "float32"
                     else Precision(compute_dtype=torch.bfloat16))
        opt = sgd(spec["lr"]) if spec["opt"] == "sgd" else adam(spec["lr"])
        ds = Dataset(*inputs["data"][name])
        params = params_from_jax(inputs["params"][name], device="cpu")
        kw = dict(precision=precision)
        dt = DistributedTrainer(model(), opt, mesh=mesh, **kw)
        state = _fit(dt, params, ds, spec["epochs"], spec["batch"])
        res = {"params": _np(state.params),
               "mu": _np(state.opt_state["mu"]) if spec["opt"] == "adam"
               else None,
               "eval": dt.evaluate(state.params, ds, spec["batch"]),
               "predict": dt.predict(state.params, ds, spec["batch"])}
        if spec.get("solo"):
            one = DistributedTrainer(model(), opt, mesh=solo, **kw)
            plain = Trainer(model(), opt, **kw)
            s1 = _fit(one, params, ds, spec["epochs"], spec["batch"])
            s0 = _fit(plain, params, ds, spec["epochs"], spec["batch"])
            res["solo"] = _np(s1.params)
            res["plain"] = _np(s0.params)
            res["solo_eval"] = one.evaluate(s1.params, ds, spec["batch"])
            res["plain_eval"] = plain.evaluate(s0.params, ds, spec["batch"])
        if spec.get("errors"):
            # the SIGTERM stop flag: one rank's request stops every rank
            res["agree"] = (dt._agree(r == 2), dt._agree(False))
            errs = {}
            for what, call in (
                    ("fit", lambda: dt.fit(dt.init_state(params), ds,
                                           epochs=1, batch_size=30)),
                    ("evaluate", lambda: dt.evaluate(params, ds, 30)),
                    ("predict", lambda: dt.predict(params, ds, 30))):
                try:
                    call()
                    errs[what] = None
                except DistributedError as e:
                    errs[what] = str(e)
            res["errors"] = errs
        if spec.get("checkpoint"):
            # ranks {0, 1} and {2, 3}: a mesh of two over each pair
            pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
            ckdir = inputs["ckpt_out"]
            if r < 2:
                save_checkpoint(ckdir, state, step=3, group=pairs[0])
                like = Trainer(model(), opt, **kw).init_state(params)
                res["jax_ckpt"] = _np(load_train_state(inputs["jax_ckpt"],
                                                       like).params)
            # fit()'s periodic saves over the pair's mesh, read back there
            pair = Mesh(data=2, rank=r % 2, device=mesh.device,
                        group=pairs[r // 2])
            sub_dir = os.path.join(inputs["subgroup_ckpt"], f"pair{r // 2}")
            sub = DistributedTrainer(model(), opt, mesh=pair, **kw)
            s2 = sub.fit(sub.init_state(params), ds, epochs=2,
                         batch_size=spec["batch"], shuffle=False,
                         checkpoint_dir=sub_dir, checkpoint_every=1)
            like = Trainer(model(), opt, **kw).init_state(params)
            res["subgroup"] = _np(s2.params)
            res["subgroup_loaded"] = _np(load_train_state(
                latest_checkpoint(sub_dir), like, group=pairs[r // 2]).params)
            dist.barrier()
        out[name] = res

    # parameter averaging on the MLP: W ranks, then each rank alone
    pa = inputs["param_avg"]
    ds = Dataset(*pa["data"])
    params = params_from_jax(pa["params"], device="cpu")
    trainer = Trainer(build_mlp(tuple(pa["hidden"]), out_dim=1,
                                in_features=pa["features"], device="cpu"),
                      sgd(pa["lr"]), precision=f32)
    state = fit_parameter_averaging(
        trainer, trainer.init_state(params), ds, mesh=mesh,
        epochs=pa["epochs"], batch_size=pa["batch"], sync_every=2,
        shuffle=False)
    out["param_avg"] = {"params": _np(state.params), "step": int(state.step)}
    state = fit_parameter_averaging(
        trainer, trainer.init_state(params), ds, mesh=solo, epochs=1,
        batch_size=pa["batch"], sync_every=2, shuffle=False)
    ref = trainer.init_state(params)
    for batch in ds.batches(pa["batch"]):
        ref, _ = trainer.train_step(ref, trainer._place(batch))
    out["param_avg_solo"] = {"params": _np(state.params),
                             "replay": _np(ref.params),
                             "step": int(state.step)}


def cases_forest(mesh, inputs, out):
    import numpy as np
    import torch

    from euromillioner_tpu_torch.core.mesh import round_up_multiple
    from euromillioner_tpu_torch.dist.collectives import all_reduce_tree
    from euromillioner_tpu_torch.trees import random_forest as rf

    x, y_cls, y_reg = inputs["x"], inputs["y_cls"], inputs["y_reg"]
    kw = dict(inputs["forest_kw"], mesh=mesh)
    out["classifier"] = rf.train_classifier(x, y_cls, 3, **kw).trees
    out["regressor"] = rf.train_regressor(x, y_reg, **kw).trees
    try:
        rf.train_classifier(x, y_cls, 3, **dict(kw, hist_method="pallas"))
        out["pallas"] = None
    except rf.TrainError as e:
        out["pallas"] = str(e)

    # the level step fed the JAX draws, on this rank's rows
    lv = inputs["levels"]
    n = len(lv["y_cls"])
    padded = round_up_multiple(n, mesh.data)
    share = padded // mesh.data
    rows = slice(mesh.rank * share, (mesh.rank + 1) * share)

    def pad(a, axis=0):
        widths = [(0, 0)] * a.ndim
        widths[axis] = (0, padded - n)
        return np.pad(a, widths)[(slice(None),) * axis + (rows,)]

    levels = {}
    for classification in (True, False):
        y = lv["y_cls"] if classification else lv["y_reg"]
        n_classes = 3 if classification else 1
        yc = np.clip(y, 0, n_classes - 1).astype(np.int32)
        b, yt, ycl = (torch.from_numpy(pad(a))
                      for a in (lv["binned"], y, yc))
        boot = torch.from_numpy(pad(lv["boot"], axis=1))
        node = torch.zeros_like(boot, dtype=torch.int32)
        got = []
        for d, mask in enumerate(lv["masks"]):
            res = rf.level_step(
                b, yt, ycl, node, boot, torch.from_numpy(mask), None,
                classification=classification, depth=d,
                n_bins=lv["n_bins"], n_classes=n_classes,
                final=d == len(lv["masks"]) - 1, min_info_gain=0.0,
                reduce=lambda h: all_reduce_tree(h, mesh))
            got.append([_np(t) for t in res[:5]])
            node = res[4]
        levels[classification] = got
    out["levels"] = levels
    out["rows"] = (rows.start, rows.stop, n)


def _fit_global(trainer, params, ds, epochs, batch_size):
    state = _fit(trainer, params, ds, epochs, batch_size)
    return state, _np(trainer.global_state(state).params)


def cases_tp(mesh, inputs, out):
    import torch

    from euromillioner_tpu_torch.core.precision import PARITY
    from euromillioner_tpu_torch.data.dataset import Dataset
    from euromillioner_tpu_torch.dist import DistributedTrainer
    from euromillioner_tpu_torch.models.convert import params_from_jax
    from euromillioner_tpu_torch.models.lstm import build_lstm
    from euromillioner_tpu_torch.models.mlp import build_mlp
    from euromillioner_tpu_torch.models.wide_deep import build_wide_deep
    from euromillioner_tpu_torch.train.optim import sgd
    from euromillioner_tpu_torch.train.trainer import Trainer

    # the MLP: 3 epochs of SGD, the JAX package's TP pin
    spec = inputs["mlp"]
    ds = Dataset(*spec["data"])
    params = params_from_jax(spec["params"], device="cpu")

    def mlp():
        return build_mlp(tuple(spec["hidden"]), out_dim=1,
                         in_features=spec["features"], device="cpu")

    dt = DistributedTrainer(mlp(), sgd(spec["lr"]), mesh=mesh,
                            precision=PARITY)
    state, full = _fit_global(dt, params, ds, spec["epochs"], spec["batch"])
    out["mlp"] = {"params": full,
                  "local": {k: tuple(v.shape)
                            for k, v in state.params.items()},
                  "dims": dict(dt._dims),
                  "eval": dt.evaluate(state.params, ds, spec["batch"]),
                  "predict": dt.predict(state.params, ds, spec["batch"])}
    # the sharded checkpoint: saved global, restored onto the mesh
    path = dt.save_checkpoint(inputs["ckpt_out"], state, step=3)
    back = dt.restore_state(path, dt.init_state(params))
    out["ckpt"] = {"before": _np(state.params), "after": _np(back.params),
                   "opt_before": _np(state.opt_state),
                   "opt_after": _np(back.opt_state),
                   "step": int(back.step)}

    # the LSTM: its layers' shards gathered whole, against one process
    lspec = inputs["lstm"]
    lds = Dataset(*lspec["data"])

    def lstm():
        return build_lstm(lspec["hidden"], lspec["layers"], 7, fused="off",
                          device="cpu")

    lp = lstm().state_dict()
    tl = DistributedTrainer(lstm(), sgd(lspec["lr"]), mesh=mesh,
                            precision=PARITY)
    _, full = _fit_global(tl, lp, lds, 1, lspec["batch"])
    plain = Trainer(lstm(), sgd(lspec["lr"]), precision=PARITY)
    out["lstm"] = {"tp": full, "plain": _np(_fit(plain, lp, lds, 1,
                                                 lspec["batch"]).params),
                   "dims": dict(tl._dims)}

    # Wide&Deep: one SGD step with f32 towers, its own TP layout
    wspec = inputs["wide_deep"]
    wds = Dataset(*wspec["data"])
    wparams = params_from_jax(wspec["params"], device="cpu")
    tw = DistributedTrainer(
        build_wide_deep(device="cpu", compute_dtype=torch.float32,
                        **wspec["kw"]),
        sgd(wspec["lr"]), mesh=mesh, precision=PARITY)
    wstate = tw.init_state(wparams)
    batch = next(wds.batches(wspec["batch"]))
    wstate, loss = tw.train_step(wstate, tw._place(batch))
    out["wide_deep"] = {"params": _np(tw.global_state(wstate).params),
                        "loss": float(loss), "dims": dict(tw._dims),
                        "local": {k: tuple(v.shape)
                                  for k, v in wstate.params.items()}}


def cases_seq(mesh, inputs, out):
    import dataclasses

    import torch

    from euromillioner_tpu_torch.core.precision import PARITY
    from euromillioner_tpu_torch.data.dataset import Dataset
    from euromillioner_tpu_torch.dist import (DistributedTrainer,
                                              seq_parallel_forward)
    from euromillioner_tpu_torch.dist.collectives import all_reduce_tree
    from euromillioner_tpu_torch.models.convert import params_from_jax
    from euromillioner_tpu_torch.models.lstm import (build_lstm,
                                                     build_tbptt_lstm)
    from euromillioner_tpu_torch.train.optim import sgd
    from euromillioner_tpu_torch.train.trainer import Trainer

    spec = inputs["tbptt"]
    model = build_tbptt_lstm(hidden=spec["hidden"], num_layers=2,
                             out_dim=spec["out"],
                             in_features=spec["features"], device="cpu")
    params = params_from_jax(spec["params"], device="cpu")
    x = torch.from_numpy(spec["x"])
    y = torch.from_numpy(spec["y"])
    for n_micro in spec["n_micro"]:
        with torch.no_grad():
            out[f"forward_{n_micro}"] = _np(seq_parallel_forward(
                mesh, model, params, x, n_micro=n_micro))
    # gradients: each rank's share of the mean, summed over every rank
    b, t = x.shape[0] // mesh.data, x.shape[1] // mesh.seq
    yl = y[mesh.rank * b:(mesh.rank + 1) * b,
           mesh.seq_rank * t:(mesh.seq_rank + 1) * t]
    p = {k: v.clone().requires_grad_() for k, v in params.items()}
    local = seq_parallel_forward(mesh, model, p, x)
    loss = ((local - yl) ** 2).sum() / y.numel()
    grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    out["grads"] = _np(all_reduce_tree(
        grads, dataclasses.replace(mesh, group=None)))
    out["block"] = (mesh.rank, mesh.seq_rank)

    # the flagship on the pipelined scan against one process's scan
    fspec = inputs["flagship"]
    fds = Dataset(*fspec["data"])

    def flagship():
        return build_lstm(fspec["hidden"], 2, 7, fused="off", device="cpu")

    fp = flagship().state_dict()
    dt = DistributedTrainer(flagship(), sgd(fspec["lr"]), mesh=mesh,
                            precision=PARITY, shard_sequence=True)
    state = _fit(dt, fp, fds, fspec["epochs"], fspec["batch"])
    plain = Trainer(flagship(), sgd(fspec["lr"]), precision=PARITY)
    ps = _fit(plain, fp, fds, fspec["epochs"], fspec["batch"])
    out["flagship"] = {
        "sp": _np(state.params), "plain": _np(ps.params),
        "eval": dt.evaluate(state.params, fds, fspec["batch"]),
        "plain_eval": plain.evaluate(ps.params, fds, fspec["batch"])}


def main(argv: list[str]) -> int:
    cases, rank, world, address, out_dir = argv
    rank, world = int(rank), int(world)
    out_dir = pathlib.Path(out_dir)
    sys.path.insert(0, str(ROOT))
    import torch

    torch.set_num_threads(1)
    from euromillioner_tpu_torch.core.mesh import MeshSpec, build_mesh
    from euromillioner_tpu_torch.dist import bootstrap

    bootstrap.initialize(address, world, rank, device="cpu",
                         timeout_s=GROUP_TIMEOUT_S)
    try:
        inputs = torch.load(out_dir / "inputs.pt", weights_only=False)
        data, model, seq = inputs.get("mesh", (world, 1, 1))
        mesh = build_mesh(MeshSpec(data=data, model=model, seq=seq),
                          device="cpu")
        out: dict = {}
        {"train": cases_train, "forest": cases_forest, "tp": cases_tp,
         "seq": cases_seq}[cases](mesh, inputs, out)
        torch.save(out, out_dir / f"rank{rank}.pt")
    except Exception:
        traceback.print_exc()
        return 1
    finally:
        bootstrap.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
