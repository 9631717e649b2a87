"""Elliptic-curve arithmetic on limb tensors (CUDA or CPU).

Counterpart of :mod:`tpu_zk.curves.ec_device`.  Points are projective
(X : Y : Z), a = 0, each coordinate a ``[..., L]`` Montgomery int32 limb
tensor.  Addition is the Renes-Costello-Batina *complete* formula --
branch-free, so it runs over the point axis with no divergence.  Its twelve
field multiplies go out as three stacked products (6 + 2 + 6), three K1
launches, and its additions and subtractions as K3 launches, in the same
operation order as ``tpu_zk``'s ``ec_add``, so the limbs agree, not only the
group element.  The same formula runs on host ints (:func:`host_ec.ec_add`)
and inside the MSM bucket kernels (``csrc/ec.cuh``).

MSM here is the double-and-add one: a conditional complete add and a
doubling per scalar bit across all N points, then a log-depth pairwise tree.
Scalars arrive as *plain* (non-Montgomery) limb tensors.  The port's MSMs go
through :mod:`.msm_pippenger` at every size; this one is the tests' and
``chip_smoke.py``'s oracle.
"""

from __future__ import annotations

import torch

from ..fields import arith
from ..fields.arith import FieldCtx, field_ctx
from .host_ec import HostCurve
from .params import CURVES

Point = tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # (X, Y, Z) limbs


def ec_add(ctx: FieldCtx, b3: torch.Tensor, P: Point, Q: Point) -> Point:
    """Complete projective addition (RCB 2015 Algorithm 7, a = 0)."""
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    X1, X2 = torch.broadcast_tensors(X1, X2)
    Y1, Y2 = torch.broadcast_tensors(Y1, Y2)
    Z1, Z2 = torch.broadcast_tensors(Z1, Z2)
    add = lambda a, b: arith.add(ctx, a, b)
    sub = lambda a, b: arith.sub(ctx, a, b)

    # stage A: 6 independent products
    sums_l = add(torch.stack([X1, Y1, X1]), torch.stack([Y1, Z1, Z1]))
    sums_r = add(torch.stack([X2, Y2, X2]), torch.stack([Y2, Z2, Z2]))
    lhs = torch.cat([torch.stack([X1, Y1, Z1]), sums_l])
    rhs = torch.cat([torch.stack([X2, Y2, Z2]), sums_r])
    prod = arith.mont_mul(ctx, lhs, rhs)
    del lhs, rhs, sums_l, sums_r
    t0, t1, t2 = prod[0], prod[1], prod[2]
    cross = sub(sub(prod[3:6], torch.stack([t0, t1, t0])), torch.stack([t1, t2, t2]))
    t3, t4, t5 = cross[0], cross[1], cross[2]  # X1Y2+X2Y1, Y1Z2+Y2Z1, X1Z2+X2Z1

    # stage B: 2 products with b3
    qb = arith.mont_mul(ctx, torch.stack([t2, t5]), b3)
    t2b3, y3g = qb[0], qb[1]
    three_t0 = add(add(t0, t0), t0)
    z3t = add(t1, t2b3)
    t1m = sub(t1, t2b3)

    # stage C: 6 independent products
    cl = torch.stack([t3, t4, y3g, t1m, z3t, three_t0])
    cr = torch.stack([t1m, y3g, three_t0, z3t, t4, t3])
    del prod, cross, qb
    u = arith.mont_mul(ctx, cl, cr)
    del cl, cr
    return (sub(u[0], u[1]), add(u[2], u[3]), add(u[4], u[5]))


def ec_select(mask: torch.Tensor, P: Point, Q: Point) -> Point:
    """mask ? P : Q, per point.  mask: bool [...]."""
    m = mask[..., None]
    return tuple(torch.where(m, p, q) for p, q in zip(P, Q))


def ec_identity(ctx: FieldCtx, shape=(), device=None) -> Point:
    """(0 : 1 : 0) over ``shape``, on ``device`` (default: the package's)."""
    one = ctx.scalar(1, device=device)
    zero = torch.zeros(tuple(shape) + (ctx.L,), dtype=torch.int32, device=one.device)
    return (zero, one.expand(tuple(shape) + (ctx.L,)).contiguous(), zero.clone())


def ec_equal(ctx: FieldCtx, P: Point, Q: Point) -> torch.Tensor:
    """Equality as group elements, exactly: X1 Z2 = X2 Z1, Y1 Z2 = Y2 Z1 and
    Z1 = 0 <=> Z2 = 0 -> bool [...]."""
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    mul = lambda a, b: arith.mont_mul(ctx, a, b)
    z1, z2 = arith.is_zero(ctx, Z1), arith.is_zero(ctx, Z2)
    same = arith.eq(ctx, mul(X1, Z2), mul(X2, Z1)) & arith.eq(ctx, mul(Y1, Z2), mul(Y2, Z1))
    return torch.where(z1 | z2, z1 & z2, same)


def scalar_bits(fr: FieldCtx, scalar_limbs_plain: torch.Tensor) -> torch.Tensor:
    """[N, Lr] plain limbs -> [N, Lr*16] bits, LSB first."""
    shifts = torch.arange(16, dtype=torch.int32, device=scalar_limbs_plain.device)
    bits = (scalar_limbs_plain[..., None] >> shifts) & 1
    return bits.reshape(*scalar_limbs_plain.shape[:-1], fr.L * 16)


def batch_scalar_mul(ctx: FieldCtx, b3: torch.Tensor, points: Point, bits: torch.Tensor) -> Point:
    """points[i] * scalar[i] for all i: double-and-add over bit columns.

    points: ([N,L],)*3; bits: [N, B] (LSB first) -> ([N,L],)*3.
    """
    N = bits.shape[0]
    acc = ec_identity(ctx, (N,), device=bits.device)
    base = points
    for j in range(bits.shape[1]):
        # one stacked complete add computes [acc+base ; base+base]
        P2 = tuple(torch.cat([a, b]) for a, b in zip(acc, base))
        Q2 = tuple(torch.cat([b, b]) for b in base)
        R = ec_add(ctx, b3, P2, Q2)
        acc = ec_select(bits[:, j] == 1, tuple(r[:N] for r in R), acc)
        base = tuple(r[N:] for r in R)
    return acc


def tree_reduce(ctx: FieldCtx, b3: torch.Tensor, points: Point, dim: int = 0) -> Point:
    """Sum the points along axis ``dim`` (of the point axes) by log-depth
    pairwise complete adds; that axis is dropped."""
    X, Y, Z = (c.movedim(dim, 0) for c in points)
    while X.shape[0] > 1:
        if X.shape[0] % 2:
            ident = ec_identity(ctx, (1,) + tuple(X.shape[1:-1]), device=X.device)
            X, Y, Z = (torch.cat([c, i]) for c, i in zip((X, Y, Z), ident))
        X, Y, Z = ec_add(ctx, b3, (X[0::2], Y[0::2], Z[0::2]), (X[1::2], Y[1::2], Z[1::2]))
    return (X[0], Y[0], Z[0])


def msm(ctx: FieldCtx, b3: torch.Tensor, points: Point, bits: torch.Tensor) -> Point:
    """Multi-scalar multiplication: sum_i scalar_i * P_i -> single point [L]x3."""
    return tree_reduce(ctx, b3, batch_scalar_mul(ctx, b3, points, bits))


class DeviceCurve:
    """Facade bundling field contexts, constants, and host<->device point IO.

    ``device`` is where its constants and the points it makes from host
    values live (default: the package's default device)."""

    def __init__(self, curve_name: str, device=None):
        c = CURVES[curve_name]
        self.name = curve_name
        self.ctx = field_ctx(c["fq"])
        self.fr = field_ctx(c["fr"])
        self.b3 = self.ctx.scalar(3 * c["b"], device=device)
        self.device = self.b3.device
        self.host = HostCurve(curve_name)

    # -- host <-> device point conversion ------------------------------------
    def points_to_device(self, affine_points) -> Point:
        """List of affine (x, y) int pairs (or None for infinity) -> device point array."""
        xs, ys, zs = [], [], []
        for a in affine_points:
            if a is None:
                xs.append(0), ys.append(1), zs.append(0)
            else:
                xs.append(a[0]), ys.append(a[1]), zs.append(1)
        return tuple(self.ctx.array(v, device=self.device) for v in (xs, ys, zs))

    def points_to_host(self, P: Point):
        """Device point array -> list of affine (x, y) int pairs / None.
        One Python modular inverse per point: keep it off timed paths."""
        Xs, Ys, Zs = (self.ctx.to_ints(c.reshape(-1, self.ctx.L)) for c in P)
        out = []
        p = self.ctx.p
        for x, y, z in zip(Xs, Ys, Zs):
            if z == 0:
                out.append(None)
            else:
                zinv = pow(z, p - 2, p)
                out.append((x * zinv % p, y * zinv % p))
        return out

    def point_to_host(self, P: Point):
        return self.points_to_host(tuple(c[None, :] if c.dim() == 1 else c for c in P))[0]

    def scalars_to_bits(self, scalars: list[int]) -> torch.Tensor:
        limbs = self.fr.array([s % self.fr.p for s in scalars], mont=False, device=self.device)
        return scalar_bits(self.fr, limbs)

    # -- high-level ops ------------------------------------------------------
    def msm_ints(self, affine_points, scalars: list[int]):
        """Host-convenience MSM: affine int points x int scalars -> affine point."""
        P = self.points_to_device(affine_points)
        bits = self.scalars_to_bits(scalars)
        return self.point_to_host(msm(self.ctx, self.b3, P, bits))
