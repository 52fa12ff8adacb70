"""Device selection: an explicit ``torch.device`` passed down from the entry point."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The torch device a run asked for.

    ``None`` means ``cuda:0`` when a card is present and the CPU otherwise.
    Asking for a CUDA device without a card raises: the port never falls
    back to the CPU behind the caller's back.
    """
    if device is None:
        return torch.device("cuda:0" if torch.cuda.is_available() else "cpu")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False; "
            "the port does not fall back to the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device type {dev.type!r}")
    return dev


def to_tensor(a, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """Host array -> tensor: integer arrays become int64 index tensors, float
    arrays ``dtype``."""
    import numpy as np

    a = np.asarray(a)
    if a.dtype.kind in "iub":
        return torch.as_tensor(a.astype(np.int64), device=device)
    if not a.flags.writeable:  # e.g. a view of a JAX array: torch needs its own copy
        a = a.copy()
    return torch.as_tensor(a, dtype=dtype, device=device)
