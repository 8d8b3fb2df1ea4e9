"""The model identity of the JAX package's ``serve/aotstore.py``.

Only :func:`params_fingerprint` is ported: live migration stamps every blob
with it, so a blob exported by either package is accepted by the other's
step scheduler only when both serve the same model structure. The store
of compiled executables itself is not ported (ROADMAP queue 1 item 10).
"""

from __future__ import annotations

import hashlib
from typing import Mapping

import torch

# torch dtype → numpy's ``dtype.str`` (bfloat16 is ml_dtypes' void of 2)
_DTYPE_STR = {
    torch.float32: "<f4", torch.float64: "<f8", torch.float16: "<f2",
    torch.bfloat16: "<V2", torch.int32: "<i4", torch.int64: "<i8",
    torch.int8: "|i1", torch.uint8: "|u1", torch.bool: "|b1",
}


def _nest(flat: Mapping[str, torch.Tensor]) -> dict:
    """``{"0_LSTM.wx": t}`` → ``{"0_LSTM": {"wx": t}}``."""
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        *parents, name = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return tree


def _treedef(node) -> str:
    """The ``str`` of a JAX ``PyTreeDef`` of nested dicts: keys in sorted
    order, each leaf a ``*``."""
    if isinstance(node, dict):
        inner = ", ".join(f"{k!r}: {_treedef(node[k])}"
                          for k in sorted(node))
        return "{" + inner + "}"
    return "*"


def _leaves(node) -> list[torch.Tensor]:
    """Leaves in the order ``jax.tree_util.tree_flatten`` gives them."""
    if isinstance(node, dict):
        return [leaf for k in sorted(node) for leaf in _leaves(node[k])]
    return [node]


def params_fingerprint(params: Mapping[str, torch.Tensor]) -> str:
    """16 hex digits of the parameters' structure — the names, each
    leaf's shape and dtype, never the values — equal to the JAX package's
    ``params_fingerprint`` of the same parameters as a nested dict. The
    string hashed is rebuilt here: the JAX treedef's ``str`` and
    ``shape:dtype.str`` per leaf, joined by ``|``."""
    tree = _nest(params)
    desc = [f"PyTreeDef({_treedef(tree)})"]
    for leaf in _leaves(tree):
        desc.append(f"{tuple(leaf.shape)}:{_DTYPE_STR[leaf.dtype]}")
    return hashlib.sha256("|".join(desc).encode()).hexdigest()[:16]
