"""Where the port's entry points run, and the host dtype of their buffers."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another. ``None`` means CUDA and raises when no CUDA device is present;
    the CPU is used only when the caller passes ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The NumPy dtype of host buffers that hold ``dtype`` tensors."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the fusion runs in float32 or float64, got {dtype}")
    return np.dtype("float32" if dtype == torch.float32 else "float64")
