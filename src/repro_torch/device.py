"""Device resolution: the port runs on the card unless the caller asks for
the CPU.

Every entry point that allocates tensors takes an explicit ``device``
argument and funnels it through :func:`resolve`.  ``None`` means the
default, ``"cuda"``; asking for a CUDA device on a machine without one is
an error, never a silent fall back to the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

DEFAULT = "cuda"

DeviceLike = Union[str, torch.device, None]


def resolve(device: DeviceLike = None) -> torch.device:
    """``device`` (or the default) as a ``torch.device``; raises
    ``RuntimeError`` when a CUDA device is requested and none is present."""
    dev = torch.device(DEFAULT if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}; use cuda or cpu")
    return dev


def of(t, device: DeviceLike = None) -> torch.device:
    """The device a call runs on: ``device`` if given, else the device of
    tensor ``t``, else the default."""
    if device is None and isinstance(t, torch.Tensor):
        return t.device
    return resolve(device)


def as_tensor(a, device: torch.device,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """numpy array or tensor -> tensor on ``device`` (no copy when it is
    already there with that dtype; numpy views with negative or broadcast
    strides are copied first)."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype or a.dtype)
    if isinstance(a, np.ndarray):
        a = np.ascontiguousarray(a)
    return torch.as_tensor(a, dtype=dtype).to(device)
