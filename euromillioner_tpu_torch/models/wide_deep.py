"""Wide&Deep 100M-param lottery embedding net (the JAX package's
``models/wide_deep.py``, BASELINE.json config 5).

* **wide**: per-cross-position tables over the exact product vocabulary of
  each cross (ball-at-position, ball-pair, day-of-week×ball) — ~90k rows of
  ``wide_embed_dim`` (≈1k) floats, summed and projected to the output;
* **deep**: per-slot embeddings of the raw ball ids and date-field
  embeddings → concat → deep MLP.

The forward is the JAX package's fused formulation (its ``apply``): the
21 ball-pair tables (95% of the wide rows) go through the wide one-hot
kernels (``ops/wide_onehot``: K4a forward, K4b dW) on a view of the
table's pair slab; the singles and dow×ball families are a gather-sum
outside the kernel. Every one-hot product of the JAX package is a lookup
here — the product of an exact one-hot with a table is the row itself —
and every sum over several ids keeps f32 and rounds once, so the rounding
points in ``compute_dtype`` are the JAX package's, in its order: the
table cast, ``h32`` cast, the wide projection, each embedding lookup, the
MLP and ``wide + deep``. Lookups gather from an f32 copy of the cast table,
so their gradients also sum in f32 and round once, as the transposed
one-hot products do there.

The gradient of the wide table is dense: all ~94M parameters get a
gradient every step (zeros where no example looked), as in the JAX
package, so Adam's moments decay on untouched rows there and here.

The int8w serving tier (``serve.precision=int8w``) runs
:meth:`WideDeep.quantized_apply`, the JAX package's dequantized gather in
plain PyTorch: each example reads its ``num_crosses`` int8 rows and only
those are dequantized, so neither the table nor a one-hot is ever dense
on that path and no K4 kernel runs.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from euromillioner_tpu_torch.core.device import resolve_device
from euromillioner_tpu_torch.core.precision import (INT8_Q, INT8_SCALE,
                                                    dequantize_leaf,
                                                    is_quantized)
from euromillioner_tpu_torch.nn import initializers as init
from euromillioner_tpu_torch.nn.layers import Dense, dense, tp_dense_stack
from euromillioner_tpu_torch.nn.module import Module, Sequential
from euromillioner_tpu_torch.ops.wide_onehot import (check_table_dtype,
                                                     wide_onehot_matmul)

# 11-column featurized row: 4 date fields + 5 balls + 2 stars
_N_DATE, _N_BALLS = 4, 7
_FIELD_VOCABS = (8, 13, 32, 64)  # day_of_week, month, day, year-mod-64
_N_PAIRS = (_N_BALLS * (_N_BALLS - 1)) // 2  # 21 unordered position pairs
_DOW_VOCAB = 8
_PAIR_I, _PAIR_J = np.triu_indices(_N_BALLS, k=1)


def _wide_buckets(ball_vocab: int) -> int:
    return (_N_BALLS * ball_vocab + _N_PAIRS * ball_vocab * ball_vocab
            + _N_BALLS * _DOW_VOCAB * ball_vocab)


def _fixed_params(embed_dim: int, ball_vocab: int,
                  hidden_sizes: tuple[int, ...], out_dim: int) -> int:
    """Parameters that do not scale with the wide rows' width E: the
    embeddings, the deep MLP and the wide bias."""
    embed = (ball_vocab + sum(_FIELD_VOCABS)) * embed_dim
    sizes = [(_N_BALLS + _N_DATE) * embed_dim, *hidden_sizes, out_dim]
    mlp = sum(a * b + b for a, b in zip(sizes[:-1], sizes[1:]))
    return embed + mlp + out_dim


def solve_wide_embed_dim(target_params: int = 100_000_000,
                         embed_dim: int = 160, ball_vocab: int = 64,
                         hidden_sizes: tuple[int, ...] = (2048, 1024, 512),
                         out_dim: int = 7) -> int:
    """The wide rows' width E that brings the total nearest
    ``target_params``: ΣP·E + E·out ≈ target minus the fixed part, rounded
    to a multiple of 8 (at least 8) — the JAX package's
    ``build_wide_deep`` arithmetic."""
    fixed = _fixed_params(embed_dim, ball_vocab, tuple(hidden_sizes), out_dim)
    per_e = _wide_buckets(ball_vocab) + out_dim   # table row + proj row
    e = (target_params - fixed) / per_e
    return max(int(round(e / 8)) * 8, 8)


def wide_deep_param_count(wide_embed_dim: int, embed_dim: int = 160,
                          ball_vocab: int = 64,
                          hidden_sizes: tuple[int, ...] = (2048, 1024, 512),
                          out_dim: int = 7) -> int:
    """Parameter count of a WideDeep, from its hyperparameters alone."""
    per_e = _wide_buckets(ball_vocab) + out_dim
    return (per_e * wide_embed_dim
            + _fixed_params(embed_dim, ball_vocab, tuple(hidden_sizes),
                            out_dim))


def _lookup(table, ids, dtype):
    """``onehot(ids) @ table.astype(dtype)``: the cast table's rows, with
    the gradient summed in f32 (in batch order, deterministically) and
    rounded to ``dtype`` once."""
    return F.embedding(ids, table.to(dtype).float()).to(dtype)


class WideDeep(Module):
    # Inputs are categorical ids encoded as floats; a bf16 cast before id
    # extraction would quantize e.g. year 2004 → 2000 (8 mantissa bits) and
    # alias embedding buckets. The Trainer and the serving backend honour
    # this flag by passing x through uncast; the towers cast to
    # ``compute_dtype`` only after lookup.
    cast_inputs = False

    def __init__(self, wide_embed_dim: int = 1024, embed_dim: int = 160,
                 ball_vocab: int = 64,
                 hidden_sizes: tuple[int, ...] = (2048, 1024, 512),
                 out_dim: int = 7, compute_dtype=torch.bfloat16, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        check_table_dtype(compute_dtype)
        dev = resolve_device(device)
        gen = (generator if generator is not None
               else torch.Generator().manual_seed(0))
        self.compute_dtype = compute_dtype
        self.wide_embed_dim = wide_embed_dim
        self.embed_dim = embed_dim
        self.ball_vocab = ball_vocab
        self.out_dim = out_dim
        e = wide_embed_dim
        normal = init.normal(0.01)
        # wide: stacked per-position tables over the exact cross
        # vocabularies (singles, then pairs, then dow×ball slabs)
        self.wide_table = torch.nn.Parameter(
            normal((self.wide_buckets, e), gen, dev))
        self.wide_proj = torch.nn.Parameter(normal((e, out_dim), gen, dev))
        self.wide_bias = torch.nn.Parameter(torch.zeros(out_dim, device=dev))
        # deep: ball-slot embeddings + date-field embeddings → MLP
        self.ball_embed = torch.nn.Parameter(
            normal((ball_vocab, embed_dim), gen, dev))
        self.field_embed = torch.nn.ParameterDict({
            str(i): torch.nn.Parameter(normal((v, embed_dim), gen, dev))
            for i, v in enumerate(_FIELD_VOCABS)})
        sizes = [(_N_BALLS + _N_DATE) * embed_dim, *hidden_sizes]
        self.deep = Sequential(
            [Dense(a, b, activation="relu", generator=gen, device=dev)
             for a, b in zip(sizes[:-1], sizes[1:])]
            + [Dense(sizes[-1], out_dim, generator=gen, device=dev)])

    # -- cross vocabulary (exact products; no hashing) -------------------
    @property
    def pair_vocab(self) -> int:
        return self.ball_vocab * self.ball_vocab

    @property
    def date_vocab(self) -> int:
        return _DOW_VOCAB * self.ball_vocab

    @property
    def num_crosses(self) -> int:
        """Cross-feature lookups per example: 7 singles + 21 ball pairs
        + 7 dow×ball."""
        return _N_BALLS + _N_PAIRS + _N_BALLS

    @property
    def wide_buckets(self) -> int:
        """Total wide rows ΣP across all cross positions."""
        return _wide_buckets(self.ball_vocab)

    def _cross_ids(self, x):
        """Per-family local cross ids, each (B, positions) int32: singles
        in [0, ball_vocab), pairs in [0, ball_vocab²), dow×ball in
        [0, 8·ball_vocab). ``.to(int32)`` truncates toward zero, as
        ``astype(int32)`` does, and the clips come before the codes."""
        balls = torch.clamp(x[..., _N_DATE:].to(torch.int32), 0,
                            self.ball_vocab - 1)                 # (B, 7)
        pairs = (balls[..., _PAIR_I] * self.ball_vocab
                 + balls[..., _PAIR_J])                          # (B, 21)
        dow = torch.clamp(x[..., 0].to(torch.int32), 0, _DOW_VOCAB - 1)
        date_cross = dow[..., None] * self.ball_vocab + balls    # (B, 7)
        return balls, pairs, date_cross

    def _wide_h32(self, wt, singles, pairs, date_cross):
        """The wide rows' f32 sum ``h32`` (B, E) over ``wt``, the cast
        table (or a column shard of it): the pairs family through the
        kernels on a view of the pair slab, singles and dow×ball gathered
        in f32."""
        e = wt.shape[1]
        s_end = _N_BALLS * self.ball_vocab
        p_end = s_end + _N_PAIRS * self.pair_vocab
        h32 = wide_onehot_matmul(
            wt[s_end:p_end].view(_N_PAIRS, self.pair_vocab, e), pairs)
        pos = torch.arange(_N_BALLS, dtype=torch.int32, device=wt.device)
        small_ids = torch.cat(
            [singles + pos * self.ball_vocab,
             s_end + date_cross + pos * self.date_vocab], dim=1)
        w_small = torch.cat([wt[:s_end], wt[p_end:]]).float()
        return h32 + F.embedding(small_ids, w_small).sum(dim=1)

    def _deep_in(self, x, singles, ball_embed, field_embed, dtype):
        """The deep tower's input: ball-slot and date-field embeddings,
        concatenated."""
        ball_e = _lookup(ball_embed, singles, dtype)          # (B, 7, emb)
        raw = self._raw_fields(x)
        field_es = [
            _lookup(field_embed[i], torch.clamp(raw[..., i], 0, v - 1),
                    dtype)
            for i, v in enumerate(_FIELD_VOCABS)]
        return torch.cat([ball_e.reshape(x.shape[0], -1)] + field_es,
                         dim=-1)

    def apply(self, x, *, train=False, generator=None):
        dtype = self.compute_dtype
        lead = x.shape[:-1]
        x = x.reshape(-1, x.shape[-1])
        singles, pairs, date_cross = self._cross_ids(x)
        h = self._wide_h32(self.wide_table.to(dtype), singles, pairs,
                           date_cross).to(dtype)
        wide = h @ self.wide_proj.to(dtype) + self.wide_bias.to(dtype)
        deep_in = self._deep_in(
            x, singles, self.ball_embed,
            [self.field_embed[str(i)] for i in range(len(_FIELD_VOCABS))],
            dtype)
        deep = self.deep.apply(deep_in, train=train, generator=generator)
        return (wide + deep).reshape(*lead, self.out_dim)

    def tp_apply(self, params: list, xs: list, comm, dims: dict, *,
                 train=False, generator=None) -> list:
        """The forward under tensor parallelism over ``model`` (the layout
        of :meth:`sharding_rules`), over per-shard lists
        (``dist/collectives.py`` ``RankComm`` for a training rank,
        ``DeviceComm`` for a serving mesh's row): ``params[j]`` is shard
        ``comm.shards[j]``'s state dict, ``dims`` the dim each leaf is
        split on (None: whole), ``xs`` the same rows on every shard.

        The wide tower runs on each shard's columns of the table (K4a at
        the shard's width; K4b writes only the shard's gradient), times
        its row block of ``wide_proj``, and one all-reduce adds the
        (B, out_dim) partials. The embeddings are joined whole where
        split, and the deep MLP runs column- or row-parallel as its
        kernels are split (``nn/layers.tp_dense_stack``). A leaf the
        rules could not split is used whole. Returns the replicated
        output on each shard."""
        dtype = self.compute_dtype
        lead = xs[0].shape[:-1]
        xs = [x.reshape(-1, x.shape[-1]) for x in xs]
        ids = [self._cross_ids(x) for x in xs]

        def whole(name):
            leaves = [p[name] for p in params]
            dim = dims.get(name)
            return leaves if dim is None else comm.gather(leaves, dim)

        if dims.get("wide_table") == 1 and dims.get("wide_proj") == 0:
            tables, projs = ([p["wide_table"] for p in params],
                             [p["wide_proj"] for p in params])
        else:
            tables, projs = whole("wide_table"), whole("wide_proj")
        parts = [self._wide_h32(t.to(dtype), s, pr, dc).to(dtype)
                 @ w.to(dtype)
                 for t, w, (s, pr, dc) in zip(tables, projs, ids)]
        if tables[0].shape[1] != self.wide_embed_dim:
            parts = comm.all_reduce(parts)
        wides = [w + p["wide_bias"].to(dtype) for w, p in zip(parts, params)]
        balls = whole("ball_embed")
        fields = [whole(f"field_embed.{i}")
                  for i in range(len(_FIELD_VOCABS))]
        deep_in = [self._deep_in(x, i[0], b, [f[j] for f in fields], dtype)
                   for j, (x, i, b) in enumerate(zip(xs, ids, balls))]
        deeps = tp_dense_stack(self.deep.named_layers(), params, dims,
                               deep_in, comm, prefix="deep.")
        return [(w + d).reshape(*lead, self.out_dim)
                for w, d in zip(wides, deeps)]

    def _raw_fields(self, x):
        """The date fields' ids (year mod 64), unclipped, as int32."""
        raw = x[..., :_N_DATE].to(torch.int32)
        return torch.cat([raw[..., :3], raw[..., 3:] % 64], dim=-1)

    def quantized_apply(self, params: dict, x):
        """The int8-weight serving forward (``serve.precision=int8w``; the
        JAX package's ``quantized_apply``) over ``params``, a state dict
        whose leaves may be int8w marker dicts (core/precision.py): the
        wide tower gathers each example's ``num_crosses`` int8 rows and
        dequantizes only those, the embeddings gather dequantized rows and
        the MLP kernels dequantize on the way into f32 products. Every
        sum is f32. A leaf left in float (a partly quantized tree) serves
        through the same program."""
        lead = x.shape[:-1]
        x = x.reshape(-1, x.shape[-1])
        dev = x.device
        balls, pairs, date_cross = self._cross_ids(x)
        s_end = _N_BALLS * self.ball_vocab
        p_end = s_end + _N_PAIRS * self.pair_vocab
        pos = torch.arange(_N_BALLS, dtype=torch.int32, device=dev)
        pair_pos = torch.arange(_N_PAIRS, dtype=torch.int32, device=dev)
        # global rows of the stacked table: each cross position owns a
        # disjoint slab of rows
        ids = torch.cat([balls + pos * self.ball_vocab,
                         pairs + s_end + pair_pos * self.pair_vocab,
                         date_cross + p_end + pos * self.date_vocab],
                        dim=1).to(torch.int64)       # (B, num_crosses)
        wt = params["wide_table"]
        if is_quantized(wt):
            rows = wt[INT8_Q][ids].to(torch.float32) * wt[INT8_SCALE]
        else:
            rows = wt[ids].to(torch.float32)
        h = rows.sum(dim=-2)                          # == onehot @ table
        wide = (h @ dequantize_leaf(params["wide_proj"])
                + params["wide_bias"].to(torch.float32))
        ball_e = dequantize_leaf(params["ball_embed"])[balls.to(torch.int64)]
        raw = self._raw_fields(x)
        field_es = [
            dequantize_leaf(params[f"field_embed.{i}"])[
                torch.clamp(raw[..., i], 0, v - 1).to(torch.int64)]
            for i, v in enumerate(_FIELD_VOCABS)]
        out = torch.cat([ball_e.reshape(x.shape[0], -1)] + field_es, dim=-1)
        for name, layer in self.deep.named_layers():
            bias = params.get(f"deep.{name}.bias")
            out = dense(out, dequantize_leaf(params[f"deep.{name}.kernel"]),
                        None if bias is None else dequantize_leaf(bias),
                        layer.activation)
        return (wide + out).reshape(*lead, self.out_dim)

    @staticmethod
    def quant_rules() -> list[str]:
        """Leaves the int8w profile quantizes (key components for
        ``core.precision.quantize_int8w``): the wide table and projection,
        both embedding families and the deep-MLP kernels. Biases stay
        exact."""
        return ["wide_table", "wide_proj", "ball_embed", "field_embed",
                "kernel"]

    @staticmethod
    def sharding_rules():
        """Tensor-parallel rules for ``core.mesh.shard_params`` (the JAX
        package's): the wide table and the ball embeddings split their
        width, ``wide_proj`` the matching rows (it contracts the split
        width), the MLP kernels their output dim, all over ``model``. A
        kernel whose output dim does not divide the axis (the
        ``out_dim``-wide head) falls back to row-parallel over its input
        dim. Used by tensor-parallel training and by mesh-sharded serving
        (serve/session.py)."""
        from euromillioner_tpu_torch.core.mesh import P

        return [
            ("wide_table", P(None, "model")),
            ("wide_proj", P("model", None)),
            ("ball_embed", P(None, "model")),
            ("field_embed", P(None, None)),
            ("kernel", (P(None, "model"), P("model", None))),
        ]


def build_wide_deep(target_params: int = 100_000_000, *,
                    generator: torch.Generator | None = None, device=None,
                    **kw) -> WideDeep:
    """The default config sized so total params ≈ ``target_params`` (the
    100M stretch target), weights drawn from ``generator`` (seed 0 when
    None) on ``device`` (the card when None). ``wide_embed_dim`` is solved
    unless given (:func:`solve_wide_embed_dim`)."""
    if "wide_embed_dim" not in kw:
        names = ("embed_dim", "ball_vocab", "hidden_sizes", "out_dim")
        kw["wide_embed_dim"] = solve_wide_embed_dim(
            target_params, **{k: kw[k] for k in names if k in kw})
    return WideDeep(**kw, generator=generator, device=device)
