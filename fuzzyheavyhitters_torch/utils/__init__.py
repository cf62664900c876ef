"""Shared helpers: device selection and the int32 <-> numpy uint32 bridge."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  With no card and no explicit request this raises — the port
    never carries on silently on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the host"
            )
        return torch.device("cuda")
    return torch.device(device)


def words_from_numpy(a, device) -> torch.Tensor:
    """uint32 numpy words -> int32 tensor with the same bit patterns."""
    return tensor_from_numpy(np.asarray(a, np.uint32).view(np.int32), device)


def tensor_from_numpy(a, device, dtype=None) -> torch.Tensor:
    """numpy array -> tensor on ``device`` (copied when the array is a
    read-only or strided view, which ``torch.from_numpy`` cannot share)."""
    a = np.asarray(a, dtype)
    if not (a.flags.writeable and a.flags.c_contiguous):
        a = np.array(a, copy=True, order="C")
    return torch.from_numpy(a).to(device)


def words_to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 tensor -> uint32 numpy array with the same bit patterns."""
    return t.detach().cpu().contiguous().numpy().view(np.uint32)
