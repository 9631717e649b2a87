"""Limb tables and circuits across the package boundary, as numpy arrays.

``tpu_zk`` holds limbs as ``uint32`` arrays of 16-bit values; this package
holds the same integers as ``torch.int32``.  Every value is below 2^16, so
the conversion is a reinterpretation of the same bits.  A circuit crosses
as each layer's numpy gate arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from ..circuit.layered import Circuit, Layer
from ..fields.arith import FieldCtx


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


def circuit_from_arrays(ctx: FieldCtx, layers) -> Circuit:
    """Layers carrying numpy ``lefts``/``rights``/``outs``/``ops`` arrays
    (output layer first; a ``tpu_zk`` ``Layer`` supplies them as they are)
    -> this package's :class:`~tpu_zk_torch.circuit.layered.Circuit`."""
    return Circuit(ctx, [Layer.from_arrays(l.lefts, l.rights, l.outs, l.ops) for l in layers])
