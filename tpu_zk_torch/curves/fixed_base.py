"""Fixed-base batched scalar multiplication (windowed table method).

Counterpart of :mod:`tpu_zk.curves.fixed_base`.  The trusted setup maps
every Lagrange-basis scalar onto the SAME base point G.  With a shared base
the doubling chain leaves the hot path: the host precomputes the small
table ``T[w][m] = m * 16^w * G`` (W windows x 16 multiples, ~1k host EC
ops), and the device then needs one gather and one complete add over all N
points per window -- W = 64 adds instead of ~2*255 for double-and-add.

Results are the same group elements (the same multiset of additions modulo
associativity; affine normalization canonicalizes).
"""

from __future__ import annotations

import torch

from ..fields.arith import FieldCtx
from .ec_device import DeviceCurve, Point, ec_add, ec_identity

WINDOW_BITS = 4


def host_window_table(dc: DeviceCurve, num_bits: int) -> Point:
    """([W, 16, L],)*3 device table of m * 16^w * G (m=0 is the identity)."""
    hc = dc.host
    W = -(-num_bits // WINDOW_BITS)
    base = hc.g1_generator()
    rows = []
    for _ in range(W):
        row = [None]
        acc = base
        for _ in range(1, 1 << WINDOW_BITS):
            row.append(hc.g1_affine(acc))
            acc = hc.g1_add(acc, base)
        rows.append(row)
        for _ in range(WINDOW_BITS):
            base = hc.g1_add(base, base)
    flat = [pt for row in rows for pt in row]
    P = dc.points_to_device(flat)
    return tuple(c.reshape(W, 1 << WINDOW_BITS, -1) for c in P)


def fixed_base_msm(ctx: FieldCtx, b3: torch.Tensor, table: Point, digits: torch.Tensor) -> Point:
    """scalar[i] * G for all i.  table: ([W,16,L],)*3; digits: [N, W] 4-bit
    windows LSB-first -> ([N,L],)*3 projective points."""
    N, W = digits.shape
    acc = ec_identity(ctx, (N,), device=digits.device)
    for w in range(W):
        d = digits[:, w].to(torch.int64)
        acc = ec_add(ctx, b3, acc, tuple(t[w][d] for t in table))
    return acc


def digits4(scalar_limbs_plain: torch.Tensor) -> torch.Tensor:
    """[N, Lr] plain 16-bit limbs -> [N, 4*Lr] 4-bit digits, LSB first."""
    parts = [(scalar_limbs_plain >> s) & 15 for s in (0, 4, 8, 12)]
    return torch.stack(parts, dim=-1).reshape(scalar_limbs_plain.shape[0], -1)
