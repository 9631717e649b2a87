"""Sharded MSM: a Pippenger MSM on each shard, then a tree of the D partial sums.

Counterpart of :mod:`tpu_zk.parallel.sharded_msm`.  Points and scalars are
cut into D blocks of consecutive rows; each shard runs the bucket MSM of
:mod:`tpu_zk_torch.curves.msm_pippenger` (K4a, K4b) on its block, and the D
partial points, gathered on every process's primary, sum in a log-depth
tree of complete adds (:func:`tpu_zk_torch.curves.ec_device.tree_reduce`).  The group is
associative, so the sum is the one-device MSM's point as a group element.
"""

from __future__ import annotations

import torch

from ..curves.ec_device import DeviceCurve, Point, ec_identity, tree_reduce
from ..curves.msm_pippenger import msm_pippenger
from .mesh import Mesh, gather, replicated, shard_leading


def sharded_msm_points(dc: DeviceCurve, mesh: Mesh, points: Point, scalar_limbs_plain: torch.Tensor) -> Point:
    """points ([N, L],)*3 Montgomery projective + plain scalar limbs [N, Lr]
    -> one projective point ([L],)*3 on the primary.

    N is padded to a multiple of D with identity points and zero scalars,
    which add exact zeros to the sum.
    """
    ctx, D = dc.ctx, mesh.size
    N = points[0].shape[0]
    pad = (-N) % D
    if pad:
        ident = ec_identity(ctx, (pad,), device=points[0].device)
        points = tuple(torch.cat([c, i]) for c, i in zip(points, ident))
        scalar_limbs_plain = torch.cat([scalar_limbs_plain, scalar_limbs_plain.new_zeros((pad, scalar_limbs_plain.shape[1]))])
    coords = [shard_leading(mesh, c) for c in points]
    scalars = shard_leading(mesh, scalar_limbs_plain)
    b3 = replicated(mesh, dc.b3)
    partials = mesh.map(lambda k, dev: torch.stack(msm_pippenger(ctx, b3[dev], (tuple(c[k] for c in coords),
                                                                                  scalars[k])))[None])
    stacked = gather(mesh, partials)  # [D, 3, L] in every process
    return tree_reduce(ctx, b3[mesh.primary], stacked.unbind(1))


def sharded_msm(dc: DeviceCurve, mesh: Mesh, affine_points, scalars) -> tuple[int, int] | None:
    """Host-convenience sharded MSM: affine int points x int scalars ->
    the affine point (None for the identity)."""
    fr = dc.fr
    P_dev = dc.points_to_device(affine_points)
    limbs = fr.array([s % fr.p for s in scalars], mont=False, device=dc.device)
    return dc.point_to_host(sharded_msm_points(dc, mesh, P_dev, limbs))
