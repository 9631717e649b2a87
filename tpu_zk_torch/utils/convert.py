"""Limb tables across the package boundary, as numpy arrays.

``tpu_zk`` holds limbs as ``uint32`` arrays of 16-bit values; this package
holds the same integers as ``torch.int32``.  Every value is below 2^16, so
the conversion is a reinterpretation of the same bits.
"""

from __future__ import annotations

import numpy as np
import torch


def limbs_from_numpy(arr: np.ndarray, device=None) -> torch.Tensor:
    """uint32 [..., L] limbs (each < 2^16) -> int32 tensor on ``device``."""
    a = np.ascontiguousarray(arr, dtype=np.uint32)
    if a.size and int(a.max()) > 0xFFFF:
        raise ValueError("limbs must be 16-bit values")
    if not a.flags.writeable:  # e.g. a view of a JAX array
        a = a.copy()
    return torch.from_numpy(a.view(np.int32)).to(device or "cpu")


def limbs_to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 [..., L] limb tensor (any device) -> uint32 numpy array."""
    if t.dtype != torch.int32:
        raise TypeError(f"expected torch.int32 limbs, got {t.dtype}")
    return t.detach().cpu().contiguous().numpy().view(np.uint32)
