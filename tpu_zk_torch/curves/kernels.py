"""The MSM bucket kernels (K4): their wrappers and plain versions.

They replace ``tpu_zk/curves/ec_pallas.py:114 msm_buckets_pallas`` and
``:273 msm_buckets13_pallas``, whose bucket table of 16 buckets (signed
base-32 digits) lives in VMEM across a sequential grid, with the per-lane
weighted bucket total of ``:239-269`` as its tail.  Here the windows are
signed c-bit digits, c up to 16, and the caller
(:mod:`tpu_zk_torch.curves.msm_pippenger`) sorts each window's points by
bucket and cuts every bucket's list into *units* of at most R entries:

K4a ``msm_buckets``: one thread a unit sums its entries into one partial
    point.  An entry is a point index with the sign in bit 31 (Y negated);
    with no entry list, entry k of a unit is row k of the points, which is
    how the same kernel sums a bucket's partials in a later pass, and K4b's
    segment totals into window sums.
K4b ``msm_bucket_reduce``: one thread per (window, segment of m buckets)
    computes sum_b (b+1) S_b over the segment: running sums acc += S_b;
    tot += acc from the top bucket down, then the segment's offset times acc
    by double-and-add.

Both are bound by operations, not bytes: a complete add is 12 Montgomery
products (the two by 3b are additions in ``csrc/ec.cuh``) of 2 (L/2)^2 wide
multiply-adds each, ``(uint64_t)a * b + c`` on 32-bit limbs, against 4 + 3 L
4-byte words read an entry.  What the design does about it is in
``csrc/msm.cu``: every thread of a launch does about R adds in a serial
chain whatever the scalars, the next entry's loads go out before the current
add, and nothing is atomic, so the result does not depend on scheduling.

Each wrapper runs its plain PyTorch version when its tensors lie on the CPU,
and for CUDA tensors launches the kernel (built by
:mod:`tpu_zk_torch._build` at first use) or raises.  Each keeps a count of
its kernel launches in its ``launches`` attribute.  The kernel and the plain
version add in different orders, so their (X : Y : Z) differ while the point
is the same: compare them with :func:`tpu_zk_torch.curves.ec_device.ec_equal`,
never limb by limb.  Points cross as rows ``[..., 3, L]`` of int32 16-bit
limbs (X, Y, Z; :func:`rows_to_points` gives the coordinate views).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..fields import arith
from ..fields.kernels import _check_limbs, _launch_args, _on_cpu, _ptr, _raise_on, _stream
from . import ec_device
from .ec_device import Point
from .params import CURVES

SIGN = -(1 << 31)  # bit 31 of an entry: the point enters negated

# the curve constant 3b by the curve's base field: the kernels multiply by it with additions
_B3 = {c["fq"]: 3 * c["b"] for c in CURVES.values()}


def rows_to_points(rows: torch.Tensor) -> Point:
    """[..., 3, L] rows -> (X, Y, Z) views [..., L]."""
    return tuple(rows[..., c, :] for c in range(3))


def points_to_rows(P: Point) -> torch.Tensor:
    """(X, Y, Z) [..., L] -> [..., 3, L] rows."""
    return torch.stack(P, dim=-2)


# ---------------------------------------------------------------------------
# plain versions (any device)
# ---------------------------------------------------------------------------


def msm_buckets_plain(ctx: arith.FieldCtx, b3: torch.Tensor, points: Point, entries: torch.Tensor | None,
                      units: torch.Tensor) -> torch.Tensor:
    """points ([n, L],)*3, entries [E] int32 or None, units [U, 2] int32
    (start, count) -> [U, 3, L]: each unit's entries gathered (Y negated
    where the sign bit is set; identity past its count) and summed by a
    pairwise tree."""
    U = units.shape[0]
    device = units.device
    width = int(units[:, 1].max()) if U else 0
    if width == 0:
        return points_to_rows(ec_device.ec_identity(ctx, (U,), device=device))
    k = torch.arange(width, device=device)
    live = k < units[:, 1:2]
    pos = torch.where(live, units[:, :1].to(torch.int64) + k, 0)  # [U, width]
    if entries is None:
        rows, negative = pos, torch.zeros_like(live)
    else:
        e = entries[pos]
        rows, negative = (e & 0x7FFFFFFF).to(torch.int64), e < 0
    X, Y, Z = (c[rows] for c in points)
    Y = torch.where(negative[..., None], arith.neg(ctx, Y), Y)
    slots = ec_device.ec_select(live, (X, Y, Z), ec_device.ec_identity(ctx, device=device))
    return points_to_rows(ec_device.tree_reduce(ctx, b3, slots, dim=1))


def msm_bucket_reduce_plain(ctx: arith.FieldCtx, b3: torch.Tensor, buckets: torch.Tensor, m: int) -> torch.Tensor:
    """buckets [W, B, 3, L] -> [W, S, 3, L], S = ceil(B/m): segment j's
    sum_b (b+1) S_b over b in [j m, min((j+1) m, B)), by the running sums
    acc += S_b; tot += acc over each segment (identity past B), then
    tot + (j m) acc by double-and-add over the bits of j m."""
    W, B = buckets.shape[:2]
    S = -(-B // m)
    pad = ec_device.ec_identity(ctx, (W, S * m - B), device=buckets.device)
    padded = torch.cat([buckets, points_to_rows(pad)], dim=1).view(W, S, m, 3, ctx.L)
    acc = tot = ec_device.ec_identity(ctx, (W, S), device=buckets.device)
    for t in reversed(range(m)):
        acc = ec_device.ec_add(ctx, b3, acc, rows_to_points(padded[:, :, t]))
        tot = ec_device.ec_add(ctx, b3, tot, acc)
    offsets = torch.arange(S, device=buckets.device) * m
    off = ec_device.ec_identity(ctx, (W, S), device=buckets.device)
    for bit in reversed(range(((S - 1) * m).bit_length())):
        off = ec_device.ec_add(ctx, b3, off, off)
        off = ec_device.ec_select(((offsets >> bit) & 1 == 1).expand(W, S), ec_device.ec_add(ctx, b3, off, acc), off)
    return points_to_rows(ec_device.ec_add(ctx, b3, tot, off))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _b3_int(ctx: arith.FieldCtx) -> int:
    if ctx.name not in _B3:
        raise ValueError(f"{ctx.name} is not the base field of a supported curve")
    return _B3[ctx.name]


def msm_buckets(ctx: arith.FieldCtx, b3: torch.Tensor, points: Point, entries: torch.Tensor | None,
                units: torch.Tensor) -> torch.Tensor:
    """K4a: points ([n, L],)*3 Montgomery projective (rows of the three may
    lie any equal number of words apart), entries [E] int32 (point index |
    sign bit) or None (entry k is row k), units [U, 2] int32 (start, count)
    into the entries -> [U, 3, L], each unit's sum."""
    _check_limbs("b3", b3, ctx.L)
    for name, c in zip("XYZ", points):
        if c.dtype != torch.int32 or c.dim() != 2 or c.shape != points[0].shape or c.shape[1] != ctx.L:
            raise ValueError(f"msm_buckets: {name} must be int32 [n, {ctx.L}] like X, got {c.dtype} {tuple(c.shape)}")
    n = points[0].shape[0]
    stride = points[0].stride(0) if n > 1 else ctx.L  # a single row's stride is never used
    for name, c in zip("XYZ", points):
        if c.stride(1) != 1 or (n > 1 and c.stride(0) != stride):
            raise ValueError(f"msm_buckets: coordinate rows must be contiguous and equally strided, {name} {c.stride()}")
    if units.dtype != torch.int32 or units.dim() != 2 or units.shape[1] != 2 or not units.is_contiguous():
        raise ValueError(f"msm_buckets: units must be contiguous int32 [U, 2], got {units.dtype} {tuple(units.shape)}")
    if entries is not None and (entries.dtype != torch.int32 or entries.dim() != 1 or not entries.is_contiguous()):
        raise ValueError(f"msm_buckets: entries must be contiguous int32 [E], got {entries.dtype} {tuple(entries.shape)}")
    if _on_cpu(*points, units, b3, *([] if entries is None else [entries])):
        return msm_buckets_plain(ctx, b3, points, entries, units)
    U = units.shape[0]
    out = torch.empty((U, 3, ctx.L), dtype=torch.int32, device=units.device)
    if U == 0:
        return out
    p32, n0inv = _launch_args(ctx)
    rc = _build.kernel_library().tzk_msm_buckets(
        _ptr(points[0]), _ptr(points[1]), _ptr(points[2]), ctypes.c_int64(stride),
        None if entries is None else ctypes.c_void_p(entries.data_ptr()), ctypes.c_void_p(units.data_ptr()),
        _ptr(ctx.one_mont(units.device)), _ptr(out), ctypes.c_int64(U), ctypes.c_int(ctx.L),
        ctypes.c_int(_b3_int(ctx)), p32, n0inv, _stream(),
    )
    _raise_on(rc, "msm_buckets")
    msm_buckets.launches += 1
    return out


msm_buckets.launches = 0


def msm_bucket_reduce(ctx: arith.FieldCtx, b3: torch.Tensor, buckets: torch.Tensor, m: int) -> torch.Tensor:
    """K4b: bucket sums [W, B, 3, L] -> [W, ceil(B/m), 3, L], each segment
    of m buckets' sum_b (b+1) S_b (see :func:`msm_bucket_reduce_plain`)."""
    _check_limbs("b3", b3, ctx.L)
    if (buckets.dtype != torch.int32 or buckets.dim() != 4 or buckets.shape[2:] != (3, ctx.L)
            or not buckets.is_contiguous() or 0 in buckets.shape):
        raise ValueError(f"msm_bucket_reduce: buckets must be contiguous int32 [W >= 1, B >= 1, 3, {ctx.L}], "
                         f"got {buckets.dtype} {tuple(buckets.shape)}")
    if m < 1:
        raise ValueError(f"msm_bucket_reduce: segment of {m} buckets")
    if _on_cpu(buckets, b3):
        return msm_bucket_reduce_plain(ctx, b3, buckets, m)
    W, B = buckets.shape[:2]
    out = torch.empty((W, -(-B // m), 3, ctx.L), dtype=torch.int32, device=buckets.device)
    p32, n0inv = _launch_args(ctx)
    rc = _build.kernel_library().tzk_msm_bucket_reduce(
        _ptr(buckets), _ptr(out), ctypes.c_int(W), ctypes.c_int(B), ctypes.c_int(m), ctypes.c_int(ctx.L),
        ctypes.c_int(_b3_int(ctx)), p32, n0inv, _stream(),
    )
    _raise_on(rc, "msm_bucket_reduce")
    msm_bucket_reduce.launches += 1
    return out


msm_bucket_reduce.launches = 0
