"""Weights across the two packages.

The JAX package keeps parameters as a nested dict (``{"0_LSTM": {"wx":
...}}``, as ``jax.device_get(params)`` gives it); this package keeps them
in ``torch.nn.Module``s whose ``state_dict`` keys join the same path with
dots (``"0_LSTM.wx"``). Both directions keep leaf names and shapes
exactly, so one initialisation can run through both packages.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from euromillioner_tpu_torch.core.device import resolve_device
from euromillioner_tpu_torch.utils.serialization import BF16_CODE, host_array


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> dict[str, Any]:
    out: dict[str, Any] = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(_flatten(value, path + "."))
        else:
            out[path] = value
    return out


def params_from_jax(tree: Mapping[str, Any], device=None
                    ) -> dict[str, torch.Tensor]:
    """JAX params tree (numpy leaves) → a ``state_dict`` on ``device``
    (the card when None). bfloat16 leaves keep their bits."""
    dev = resolve_device(device)
    out = {}
    for path, leaf in _flatten(tree).items():
        code, arr = host_array(leaf)
        t = torch.from_numpy(np.array(arr))
        if code == BF16_CODE:  # host_array hands back bfloat16's bits
            t = t.view(torch.bfloat16)
        out[path] = t.to(dev)
    return out


def params_to_numpy(params: torch.nn.Module | Mapping[str, torch.Tensor]
                    ) -> dict[str, Any]:
    """A module or ``state_dict`` → the JAX package's nested dict of numpy
    arrays. bfloat16 leaves come back as float32 (numpy has no bfloat16)."""
    flat = params.state_dict() if isinstance(params, torch.nn.Module) else params
    tree: dict[str, Any] = {}
    for path, t in flat.items():
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        node = tree
        *parents, leaf = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t.numpy().copy()
    return tree
