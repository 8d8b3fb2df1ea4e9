"""Device selection for the port's entry points.

Every entry point takes ``device``: ``None`` means the card (``cuda``), and
the CPU runs only when the caller asks for it (``device="cpu"``,
``--device cpu``). Finding no card is an error, never a quiet move to the
CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from euromillioner_tpu_torch.utils.errors import ConfigError


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None``/``"cuda"`` → the current CUDA device (raises when none is
    available); ``"cpu"`` → the CPU. On CUDA, float32 matrix products and
    convolutions are pinned to full f32 (TF32 off)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise ConfigError(
                "no CUDA device is available; pass --device cpu "
                "(device=\"cpu\") to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ConfigError(f"unsupported device {str(dev)!r} (cuda | cpu)")
    return dev


def upload(x: np.ndarray | torch.Tensor, device: torch.device
           ) -> torch.Tensor:
    """A host array or CPU tensor on ``device`` without a host sync: on
    CUDA through a pinned copy and a non-blocking transfer on the current
    stream (the pinned block is not reused before the copy ends); on the
    CPU the host memory itself."""
    t = (x.contiguous() if isinstance(x, torch.Tensor)
         else torch.from_numpy(np.ascontiguousarray(x)))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t
