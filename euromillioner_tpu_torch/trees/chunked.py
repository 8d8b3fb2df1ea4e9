"""Chunk-sliced ensemble prediction programs (``serve.trees.chunk``; the
JAX package's ``trees/chunked.py``).

The whole-ensemble programs (``Booster.predict_program``,
``RandomForestModel.predict_program``) hold the whole stacked tree table
on the device. A :class:`ChunkedTreeProgram` is the chunk-sliced split of
the same arithmetic: the tables are cut into fixed-size host blocks (the
tail padded with no-op trees so every block has one shape),
``chunk_apply(block, carry, binned)`` evaluates any block, and a device
carry threads from block to block in the whole-ensemble program's tree
order — so the serving layer streams one window of blocks to the device
at a time and the replies stay bit-equal to ``predict``.

The order each family keeps:

* **GBT** — the whole-ensemble margin adds each tree's leaf in tree order
  (``growth.accumulate_leaves``); a chunk resumes that sum from the
  previous chunk's carry with the same adds, and the tail's ``-0.0``
  leaves are bitwise no-ops (``x + -0.0 == x`` for every f32 x).
* **RF classification** — votes are exact small-integer counts in f32
  (up to 2^24 trees), so any order gives the same totals; pad trees vote
  class ``-1``, which matches no class.
* **RF regression** is not chunkable bit-exactly: the whole-forest mean
  sums the trees in XLA's reduce order (``growth.ordered_sum``), not a
  sequential carry's, so the factory returns None unless the approximate
  mean is asked for.

Each program is also cut where the AOT store (serve/aotstore.py) compiles
it: ``leaves_apply`` (each tree's leaf value per row: the routing, exact
in any program) and ``carry_apply`` (the carry's adds or votes, in tree
order), which the serving layer runs eagerly so the sums keep their order.
``signature`` is the chunk programs' identity in the store beside the
block's shapes (the JAX package's ``signature``); its ``block_specs`` have
no counterpart: a compile takes example tensors.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np

#: Tree-table keys every chunk block carries (the stacked complete-tree
#: layout both tree families share).
BLOCK_KEYS = ("feature", "split_bin", "is_leaf", "leaf_value")


def pad_block(block: dict, pad: int, n_nodes: int,
              pad_leaf_value: float) -> dict:
    """Tail-pad a chunk block to the fixed chunk size with no-op trees:
    all-leaf nodes (routing stops at the root) whose leaf value is the
    family's identity (``-0.0`` for margin sums, ``-1.0`` for votes,
    ``0.0`` for the approximate mean's sum)."""
    return {
        "feature": np.concatenate(
            [block["feature"], np.zeros((pad, n_nodes), np.int32)]),
        "split_bin": np.concatenate(
            [block["split_bin"], np.zeros((pad, n_nodes), np.int32)]),
        "is_leaf": np.concatenate(
            [block["is_leaf"], np.ones((pad, n_nodes), bool)]),
        "leaf_value": np.concatenate(
            [block["leaf_value"],
             np.full((pad, n_nodes), pad_leaf_value, np.float32)]),
    }


def slice_blocks(trees: dict, lo: int, hi: int, chunk: int,
                 pad_leaf_value: float) -> list[dict]:
    """Cut stacked tree arrays ``[lo, hi)`` into fixed-``chunk`` host
    blocks (C-contiguous copies: each block is one clean upload), the tail
    padded with no-op trees so every block's shapes match."""
    n_nodes = int(np.asarray(trees["feature"]).shape[1])
    blocks = []
    for c0 in range(lo, hi, chunk):
        blk = {k: np.ascontiguousarray(np.asarray(trees[k])[c0:min(c0 + chunk,
                                                                  hi)])
               for k in BLOCK_KEYS}
        pad = chunk - blk["feature"].shape[0]
        if pad:
            blk = pad_block(blk, pad, n_nodes, pad_leaf_value)
        blocks.append(blk)
    return blocks


@dataclass
class ChunkedTreeProgram:
    """One ensemble's chunk-sliced serving split (see the module note).

    ``blocks`` are host numpy dicts of identical shapes; the serving layer
    uploads them one window at a time. ``chunk_apply(block, carry,
    binned)`` takes device tensors (a block's tables, the f32 carry, the
    binned rows) and returns the next carry; ``finish_apply(carry)`` turns
    the last carry into replies; ``init_carry(n_rows)`` is the first carry
    (host numpy); ``prepare(x)`` bins raw rows on the host."""

    chunk: int                       # trees per chunk (the block shape)
    n_trees: int                     # true ensemble size, before padding
    blocks: list = field(repr=False)
    chunk_apply: Callable = field(repr=False)  # (block, carry, x) -> carry
    finish_apply: Callable = field(repr=False)  # (carry,) -> outputs
    init_carry: Callable = field(repr=False)   # (n_rows,) -> np.ndarray
    prepare: Callable = field(repr=False)      # (x,) -> binned rows
    # chunk_apply cut where the AOT store compiles it: chunk_apply(b, c, x)
    # is carry_apply(c, leaves_apply(b, x)), op for op
    leaves_apply: Callable = field(repr=False)  # (block, x) -> (chunk, N)
    carry_apply: Callable = field(repr=False)   # (carry, values) -> carry
    # what the leaves program depends on besides the block's shapes: the
    # identity of its programs in the AOT store
    signature: str = ""

    @property
    def n_chunks(self) -> int:
        return len(self.blocks)

    @property
    def block_bytes(self) -> int:
        """Bytes of ONE chunk block — the unit of the "peak device
        tree-table bytes <= 2 chunks" memory claim."""
        if not self.blocks:
            return 0
        return int(sum(a.nbytes for a in self.blocks[0].values()))
