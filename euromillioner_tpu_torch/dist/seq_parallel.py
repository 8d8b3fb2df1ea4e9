"""Sequence parallelism for the recurrent models: the pipelined chunk
scan (the JAX package's ``dist/seq_parallel.py``).

Training an RNN over a sequence longer than one device wants to hold:
the mesh's ``seq`` axis holds contiguous time chunks, the (h, c) carry
flows from seq rank k to k + 1, and batch microbatches keep every rank
busy: at pipeline stage ``s``, rank ``k`` scans microbatch ``s - k``
through its chunk, the schedule of pipeline parallelism with time chunks
in place of layer stages. Utilization is ``n_micro / (n_seq + n_micro -
1)``.

There one ``shard_map`` holds every device and a ``ppermute`` moves the
carry; here each rank is a process, and the hand-off is one all-reduce
over the seq group each stage (``dist/collectives.carry_handoff``; gloo
has no send/recv for CUDA tensors), inside autograd: its backward sends
the carry's gradient from k + 1 back to k. Rank 0 receives zeros, the
leftmost chunk's initial carry, so no stage is a special case. Every
rank runs every stage (an idle stage's scan is masked out, as there), so
every rank's graph has the same shape and the hand-offs' backward
collectives pair up in the same order.

The chunks run the layer's scan from the received carry: the fused
kernels start from a zero carry, so this path launches K1 and K2 no
time, as the JAX package runs its scan here. Composition: ``data``
shards the batch as usual; :func:`seq_parallel_forward` needs ``model``
= 1 (the trainer gathers tensor-parallel LSTM weights before the scan).
"""

from __future__ import annotations

import torch
from torch.func import functional_call

from euromillioner_tpu_torch.core.mesh import AXIS_DATA, Mesh
from euromillioner_tpu_torch.dist.collectives import carry_handoff
from euromillioner_tpu_torch.nn.recurrent import LSTM
from euromillioner_tpu_torch.utils.errors import DistributedError


class _LayerOps(torch.nn.Module):
    """An LSTM layer's input projection and scan as one module, so
    ``functional_call`` runs them on params held outside the layer."""

    def __init__(self, layer: LSTM):
        super().__init__()
        self.layer = layer

    def forward(self, op: str, *args):
        if op == "proj":
            return self.layer._input_proj(args[0])
        return self.layer._scan(args[0], (args[1], args[2]))


def check_sequence_model(mesh: Mesh, model, last_step: bool = False
                         ) -> None:
    """The JAX refusals of a model the pipelined scan cannot run: an LSTM
    that returns only its last step (allowed for the last LSTM when
    ``last_step``: the trainer broadcasts that step from the last seq
    rank), and an active Dropout."""
    lstms = [layer for _, layer in model.named_layers()
             if isinstance(layer, LSTM)]
    for layer in lstms:
        if not layer.return_sequences and not (last_step
                                               and layer is lstms[-1]):
            raise DistributedError(
                "seq-parallel needs return_sequences=True on every LSTM "
                "(build the model with build_tbptt_lstm)")
    for _, layer in model.named_layers():
        if getattr(layer, "rate", 0.0) > 0.0:
            # Dropout needs per-rank, per-microbatch generator threading
            # through the pipeline: refusing beats silently training
            # without the configured regularization
            raise DistributedError(
                "seq_parallel_forward does not support active Dropout "
                "layers; build the model with dropout=0")


def pipelined_layer(layer: LSTM, params: dict, x: torch.Tensor, mesh: Mesh,
                    n_micro: int) -> torch.Tensor:
    """This rank's time chunk of one LSTM layer on the pipeline schedule.
    ``x``: [B_loc, T_loc, F], the chunk's inputs; ``params``: the layer's
    leaves (``wx``, ``wh``, ...). Returns hs [B_loc, T_loc, H]."""
    ops = _LayerOps(layer)
    named = {f"layer.{k}": v for k, v in params.items()}
    x_proj = functional_call(ops, named, ("proj", x))  # [T_loc, B_loc, 4H]
    t_loc, b, four_h = x_proj.shape
    h = four_h // 4
    mb = b // n_micro
    xm = [x_proj[:, m * mb:(m + 1) * mb] for m in range(n_micro)]
    outs = [x_proj.new_zeros((t_loc, mb, h)) for _ in range(n_micro)]
    ch = x_proj.new_zeros((mb, h))
    cc = x_proj.new_zeros((mb, h))
    k, n_stages = mesh.seq_rank, mesh.seq + n_micro - 1
    for s in range(n_stages):
        m = s - k
        mi = min(max(m, 0), n_micro - 1)
        active = torch.tensor(0 <= m < n_micro, device=x.device)
        # from the received carry: zeros on rank 0, chunk k - 1's end
        # elsewhere
        (hf, cf), hs = functional_call(ops, named, ("scan", xm[mi], ch, cc))
        outs[mi] = torch.where(active, hs, outs[mi])
        if s < n_stages - 1:  # the last stage's carry has no receiver
            ch, cc = carry_handoff(hf, cf, mesh)
    return torch.cat(outs, dim=1).transpose(0, 1)


def seq_parallel_forward(mesh: Mesh, model, params, x, n_micro: int = 0):
    """Per-step forward of a stacked-LSTM model (every LSTM with
    ``return_sequences``; build it with ``build_tbptt_lstm``) with the time
    dim sharded over ``seq`` and the batch over ``data``. ``x`` is the
    global [B, T, F] batch (each rank reads its block), ``params`` a
    ``state_dict`` (None: the model's own). ``n_micro`` (default: the seq
    axis size) splits each rank's rows into pipeline microbatches. Returns
    this rank's [B/data, T/seq, D] block of the outputs."""
    n_seq = mesh.seq
    if mesh.model != 1:
        raise DistributedError(
            "seq_parallel_forward composes data x seq; set mesh model=1")
    n_micro = n_micro or max(n_seq, 1)
    b, t, _ = x.shape
    n_data = mesh.data
    if b % (n_data * n_micro):
        raise DistributedError(
            f"batch {b} must divide by {AXIS_DATA} axis x microbatches "
            f"({n_data} x {n_micro})")
    if t % n_seq:
        raise DistributedError(
            f"sequence length {t} not divisible by seq axis {n_seq}")
    check_sequence_model(mesh, model)
    params = dict(model.state_dict() if params is None else params)
    b_loc, t_loc = b // n_data, t // n_seq
    h = x[mesh.rank * b_loc:(mesh.rank + 1) * b_loc,
          mesh.seq_rank * t_loc:(mesh.seq_rank + 1) * t_loc]
    for name, layer in model.named_layers():
        sub = {k[len(name) + 1:]: v for k, v in params.items()
               if k.startswith(name + ".")}
        if isinstance(layer, LSTM):
            h = pipelined_layer(layer, sub, h, mesh, n_micro)
        else:  # pointwise layers in eval mode (the Dense head, Dropout)
            h = functional_call(layer, sub, (h,), {"train": False})
    return h
