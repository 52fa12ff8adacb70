"""Device selection: an explicit ``torch.device`` passed down from the entry point."""

from __future__ import annotations

import subprocess

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The torch device a run asked for.

    ``None`` means ``cuda:0``; a CPU run asks for ``"cpu"``.  Asking for a
    CUDA device without a card raises: the port never falls back to the CPU
    behind the caller's back.  Every entry point resolves its device here,
    so this is also where float32 contractions are kept full precision:
    TF32 raised CG from 3 to 9 iterations on the reference.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False; "
            "the port does not fall back to the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device type {dev.type!r}")
    return dev


def describe_device(device: torch.device) -> str:
    """What a printed time belongs to: ``cpu``, or the card's name with its
    power limit as nvidia-smi reports it (the name alone where nvidia-smi
    is not there to ask)."""
    if device.type != "cuda":
        return str(device)
    name = torch.cuda.get_device_name(device)
    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        )
    except (OSError, subprocess.SubprocessError):
        return f"{device} ({name})"
    return f"{device} ({out.stdout.strip().splitlines()[0]})"


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
