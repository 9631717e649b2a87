"""The MSM bucket kernels (K4): their wrappers and plain versions.

K4a ``msm_buckets``: Pippenger bucket accumulation for every window at once.
    Replaces ``tpu_zk/curves/ec_pallas.py:114 msm_buckets_pallas`` and the
    accumulation stage of ``:273 msm_buckets13_pallas`` (whose packed signed
    base-32 codes it takes).  Lane s of window w holds, for each bucket b,
    the sum of +-P_i over the points i = s, s + P, s + 2P, ... whose window-w
    code has idx = b and skip = 0.
K4b ``msm_bucket_reduce``: each (window, lane)'s weighted bucket total
    sum_b (b+1) S_b by running suffix sums.  Replaces the tail of
    ``msm_buckets13_pallas`` (``ec_pallas.py:239-269``).

Both are bound by operations, not bytes: a complete add is 14 Montgomery
products (12 of them needed: the two by b3 could be a few additions) of
2 (L/2)^2 wide multiply-adds each, ``(uint64_t)a * b + c`` on 32-bit limbs,
for ~3 L 4-byte words of point read once per window.  What the design does about it is in
``csrc/msm.cu``: one thread per (window, lane) with its buckets in a scratch
tensor that is also the output, every thread of one full wave of the card
equally long at work, no atomics and no sort.

Each wrapper runs its plain PyTorch version when its tensors lie on the CPU,
and for CUDA tensors launches the kernel (built by
:mod:`tpu_zk_torch._build` at first use) or raises.  Each keeps a count of
its kernel launches in its ``launches`` attribute.  The kernel and the plain
version add in different orders, so their (X : Y : Z) differ while the point
is the same: compare them with :func:`tpu_zk_torch.curves.ec_device.ec_equal`,
never limb by limb.

A code is one byte, ``idx | sign << 5 | skip << 6`` with idx = |digit| - 1
below 16 (:func:`tpu_zk_torch.curves.msm_pippenger.signed_digit_codes`).
Buckets cross between K4a and K4b as ``[W, P, 16, 3, L/2]`` int32 words, each
holding two 16-bit limbs (the kernels' own 32-bit limbs);
:func:`unpack_buckets` turns them into limb coordinates.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from ..fields import arith
from ..fields.kernels import _check_limbs, _launch_args, _on_cpu, _ptr, _raise_on, _stream
from . import ec_device
from .ec_device import Point

BUCKETS = 16
CPU_LANES = 2  # the plain version's default P: enough to cross lanes and leave a ragged tail


# ---------------------------------------------------------------------------
# bucket words <-> limb coordinates
# ---------------------------------------------------------------------------


def unpack_buckets(words: torch.Tensor) -> Point:
    """[..., 3, L/2] int32 words -> ([..., L],)*3 16-bit limbs."""
    limbs = torch.stack([words & 0xFFFF, (words >> 16) & 0xFFFF], dim=-1).flatten(-2)
    return tuple(limbs[..., c, :] for c in range(3))


def pack_buckets(P: Point) -> torch.Tensor:
    """([..., L],)*3 16-bit limbs -> [..., 3, L/2] int32 words."""
    limbs = torch.stack(P, dim=-2).to(torch.int64)
    words = limbs[..., 0::2] | (limbs[..., 1::2] << 16)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


# ---------------------------------------------------------------------------
# plain versions (any device)
# ---------------------------------------------------------------------------


def msm_buckets_plain(ctx: arith.FieldCtx, b3: torch.Tensor, points: Point, codes: torch.Tensor, lanes: int) -> Point:
    """points ([n, L],)*3, codes [W, n] uint8 -> bucket points ([W, lanes, 16, L],)*3.

    A masked select of every point into its (window, bucket) slot, identity
    elsewhere, then a pairwise tree over each lane's points.
    """
    n = points[0].shape[0]
    W = codes.shape[0]
    device = codes.device
    steps = max(-(-n // lanes), 1)
    pad = steps * lanes - n
    ident = ec_device.ec_identity(ctx, (pad,), device=device)
    X, Y, Z = (torch.cat([c, i]).view(steps, lanes, ctx.L) for c, i in zip(points, ident))
    codes = torch.cat([codes, torch.full((W, pad), 64, dtype=torch.uint8, device=device)], dim=1)
    codes = codes.view(W, steps, lanes).to(torch.int32)
    idx, negative, live = codes & 15, (codes & 32) != 0, (codes & 64) == 0
    Yw = torch.where(negative[..., None], arith.neg(ctx, Y), Y)  # [W, steps, lanes, L]
    mask = (live[:, None] & (idx[:, None] == torch.arange(BUCKETS, device=device).view(1, BUCKETS, 1, 1)))[..., None]
    iX, iY, iZ = ec_device.ec_identity(ctx, device=device)
    slots = (torch.where(mask, X, iX), torch.where(mask, Yw[:, None], iY), torch.where(mask, Z, iZ))
    sums = ec_device.tree_reduce(ctx, b3, slots, dim=2)  # [W, 16, lanes, L]
    return tuple(c.transpose(1, 2).contiguous() for c in sums)


def msm_bucket_reduce_plain(ctx: arith.FieldCtx, b3: torch.Tensor, buckets: Point) -> Point:
    """bucket points ([W, lanes, 16, L],)*3 -> ([W, lanes, L],)*3 holding
    sum_b (b+1) S_b, by the running suffix sums acc += S_b; tot += acc."""
    shape = buckets[0].shape[:-2]
    acc = tot = ec_device.ec_identity(ctx, shape, device=buckets[0].device)
    for b in reversed(range(BUCKETS)):
        acc = ec_device.ec_add(ctx, b3, acc, tuple(c[..., b, :] for c in buckets))
        tot = ec_device.ec_add(ctx, b3, tot, acc)
    return tot


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


@functools.cache
def _resident_threads(L: int) -> int:
    n = _build.kernel_library().tzk_msm_resident_threads(ctypes.c_int(L))
    if n <= 0:
        raise RuntimeError(f"msm_buckets: no resident threads for L={L} (cudaError_t {-n})")
    return n


def default_lanes(ctx: arith.FieldCtx, n: int, W: int, device) -> int:
    """P for an MSM of n points and W windows: on the card, as many lanes
    (a multiple of 32) as make W * P threads one full wave, fewer when n has
    fewer points than that; on the CPU a small constant."""
    if torch.device(device).type == "cpu":
        return CPU_LANES
    wave = max(_resident_threads(ctx.L) // W // 32 * 32, 32)
    return min(wave, max(-(-n // 32) * 32, 32))


def msm_buckets(ctx: arith.FieldCtx, b3: torch.Tensor, points: Point, codes: torch.Tensor, lanes: int) -> torch.Tensor:
    """K4a: points ([n, L],)*3 Montgomery projective, codes [W, n] uint8 ->
    bucket words [W, lanes, 16, 3, L/2] (see :func:`unpack_buckets`)."""
    for name, c in zip("XYZ", points):
        _check_limbs(name, c, ctx.L)
    _check_limbs("b3", b3, ctx.L)
    n = points[0].shape[0]
    if any(c.shape != (n, ctx.L) for c in points) or b3.dim() != 1:
        raise ValueError(f"msm_buckets: point coordinates {[tuple(c.shape) for c in points]}, b3 {tuple(b3.shape)}")
    if codes.dtype != torch.uint8 or codes.dim() != 2 or codes.shape[1] != n or not codes.is_contiguous():
        raise ValueError(f"msm_buckets: codes must be contiguous uint8 [W, {n}], got {codes.dtype} {tuple(codes.shape)}")
    W = codes.shape[0]
    if lanes < 1 or W < 1:
        raise ValueError(f"msm_buckets: lanes {lanes}, windows {W}")
    if _on_cpu(*points, codes, b3):
        return pack_buckets(msm_buckets_plain(ctx, b3, points, codes, lanes))
    buckets = torch.empty((W, lanes, BUCKETS, 3, ctx.L // 2), dtype=torch.int32, device=codes.device)
    p32, n0inv = _launch_args(ctx)
    rc = _build.kernel_library().tzk_msm_buckets(
        _ptr(points[0]), _ptr(points[1]), _ptr(points[2]), ctypes.c_void_p(codes.data_ptr()), _ptr(b3),
        _ptr(ctx.one_mont(codes.device)), _ptr(buckets), ctypes.c_int64(n), ctypes.c_int(W), ctypes.c_int(lanes),
        ctypes.c_int(ctx.L), p32, n0inv, _stream(),
    )
    _raise_on(rc, "msm_buckets")
    msm_buckets.launches += 1
    return buckets


msm_buckets.launches = 0


def msm_bucket_reduce(ctx: arith.FieldCtx, b3: torch.Tensor, buckets: torch.Tensor) -> Point:
    """K4b: bucket words [W, lanes, 16, 3, L/2] -> ([W, lanes, L],)*3 limbs,
    each (window, lane)'s sum_b (b+1) S_b."""
    _check_limbs("b3", b3, ctx.L)
    if (buckets.dtype != torch.int32 or buckets.dim() != 5 or buckets.shape[2:] != (BUCKETS, 3, ctx.L // 2)
            or not buckets.is_contiguous()):
        raise ValueError(f"msm_bucket_reduce: buckets must be contiguous int32 [W, lanes, {BUCKETS}, 3, {ctx.L // 2}], "
                         f"got {buckets.dtype} {tuple(buckets.shape)}")
    W, lanes = buckets.shape[:2]
    if _on_cpu(buckets, b3):
        return msm_bucket_reduce_plain(ctx, b3, unpack_buckets(buckets))
    out = torch.empty((W, lanes, 3, ctx.L), dtype=torch.int32, device=buckets.device)
    if W * lanes == 0:
        return tuple(out[:, :, c] for c in range(3))
    p32, n0inv = _launch_args(ctx)
    rc = _build.kernel_library().tzk_msm_bucket_reduce(
        _ptr(buckets), _ptr(b3), _ptr(ctx.one_mont(buckets.device)), _ptr(out), ctypes.c_int64(W * lanes),
        ctypes.c_int(ctx.L), p32, n0inv, _stream(),
    )
    _raise_on(rc, "msm_bucket_reduce")
    msm_bucket_reduce.launches += 1
    return tuple(out[:, :, c] for c in range(3))


msm_bucket_reduce.launches = 0
