"""Limb tables, points, circuits and trusted setups across the package
boundary, as numpy arrays.

``tpu_zk`` holds limbs as ``uint32`` arrays of 16-bit values; this package
holds the same integers as ``torch.int32``.  Every value is below 2^16, so
the conversion is a reinterpretation of the same bits.  A point array
crosses as its three coordinate limb arrays, a circuit as each layer's numpy
gate arrays, a trusted setup as its G1 point array and its host G2 points.
"""

from __future__ import annotations

import numpy as np
import torch

from ..circuit.layered import Circuit, Layer
from ..curves.ec_device import DeviceCurve, Point
from ..curves.pairing import Fq2
from ..device import resolve
from ..fields.arith import FieldCtx
from ..kzg.trusted_setup import TrustedSetup


def limbs_from_numpy(arr: np.ndarray, device=None) -> torch.Tensor:
    """uint32 [..., L] limbs (each < 2^16) -> int32 tensor on ``device``
    (the package's default device when none is given)."""
    a = np.ascontiguousarray(arr, dtype=np.uint32)
    if a.size and int(a.max()) > 0xFFFF:
        raise ValueError("limbs must be 16-bit values")
    if not a.flags.writeable:  # e.g. a view of a JAX array
        a = a.copy()
    return torch.from_numpy(a.view(np.int32)).to(resolve(device))


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


def points_from_numpy(coords, device=None) -> Point:
    """Three uint32 [N, L] coordinate arrays (X, Y, Z) -> a device point array."""
    return tuple(limbs_from_numpy(c, device) for c in coords)


def points_to_numpy(P: Point):
    """A device point array -> three uint32 [N, L] coordinate arrays."""
    return tuple(limbs_to_numpy(c) for c in P)


def trusted_setup_from_arrays(curve_name: str, g1_powers, g2_powers, num_vars: int, device=None) -> TrustedSetup:
    """A setup made elsewhere -> this package's :class:`TrustedSetup`.

    ``g1_powers``: three uint32 [2^num_vars, L] Montgomery projective
    coordinate arrays; ``g2_powers``: per variable a projective G2 point as
    ``((x0, x1), (y0, y1), (z0, z1))`` ints (``tpu_zk``'s ``Fq2`` objects
    give them as ``(c.c0, c.c1)``).
    """
    dc = DeviceCurve(curve_name, device=device)
    if len(g2_powers) != num_vars or any(np.shape(c)[0] != 1 << num_vars for c in g1_powers):
        raise ValueError(f"setup arrays do not fit {num_vars} variables")
    g2 = [tuple(Fq2(dc.ctx.p, c0, c1) for c0, c1 in pt) for pt in g2_powers]
    return TrustedSetup(dc, points_from_numpy(g1_powers, dc.device), g2, num_vars)
