"""Pippenger (bucket-method) MSM at every size: signed c-bit windows, points
sorted into buckets, balanced units.  Counterpart of
:mod:`tpu_zk.curves.msm_pippenger`.

The window size follows the number of points N: :func:`window_bits` takes
the c in [2, 16] that minimizes W (N + 2^c), W = ceil((bits + 1) / c)
windows of signed digits in (-2^(c-1), 2^(c-1)] and 2^(c-1) buckets each
(c = 16 from about 2^17 points up, 17 windows of which the last holds only
the carry of scalars of 256 bits).  The stages:

1. :func:`signed_digits`: every window's digit of every point at once, plain
   torch: the scalar plus (2^(c-1) - 1) in every window, cut into c-bit
   pieces, less 2^(c-1) - 1;
2. :func:`_bucket_entries`: a stable sort of the (window, bucket) keys lists
   each bucket's point indices, with the sign in bit 31 of each entry (the
   glue the TPU does not need: its kernels route by one-hot masks);
3. K4a (:func:`.kernels.msm_buckets`) over the unit tables of
   :func:`_unit_table`: each bucket's list cut into units of at most
   ``UNIT`` entries, one partial point each; a bucket with several partials
   takes another pass over them, until each has one;
4. K4b (:func:`.kernels.msm_bucket_reduce`): for each window and segment of
   ``SEGMENT`` buckets, sum_b (b+1) S_b over the segment;
5. :func:`_window_sums`: K4a passes again, over each window's segment totals;
6. the window combine sum_w 2^(c w) S_w on the host, by Horner's rule on
   Python ints (:func:`host_ec.ec_add`, about 280 additions).

Every MSM of one point or more takes this path; N = 0 gives the identity.
``tpu_zk``'s version rebases points to radix-2^13 limbs, pads N to the
kernel's tile and runs double-and-add below 2048 points; the first two
answer the TPU's vector unit and tiling, the last its compile per shape, and
none has a counterpart here.
"""

from __future__ import annotations

import torch

from ..fields.arith import FieldCtx
from . import host_ec
from .ec_device import Point, ec_identity
from .kernels import SIGN, msm_bucket_reduce, msm_buckets, rows_to_points

MAX_WINDOW_BITS = 16
# R and m: 128 and 32 are faster for a lone 2^24 MSM on an H100, but slower over the
# depth-24 succinct prove's 49 MSMs of 2^24 points down to 1 (PERF.md)
UNIT = 32  # entries a K4a thread sums (R)
SEGMENT = 16  # buckets a K4b thread reduces (m)


def window_count(bits: int, c: int) -> int:
    """Windows of signed c-bit digits that a scalar below 2^bits needs."""
    return -(-(bits + 1) // c)


def window_bits(n: int, bits: int = 256) -> int:
    """The c in [2, MAX_WINDOW_BITS] that minimizes W (n + 2^c): n adds a
    window into buckets, about two a bucket to weigh them."""
    return min(range(2, MAX_WINDOW_BITS + 1), key=lambda c: window_count(bits, c) * (n + (1 << c)))


def _digits(scalar_limbs: torch.Tensor, c: int) -> torch.Tensor:
    """[N, L] 16-bit limbs -> [N, W] unsigned c-bit digits (LSB window first)."""
    if c == 16:
        return scalar_limbs
    parts = [(scalar_limbs >> s) & ((1 << c) - 1) for s in range(0, 16, c)]
    return torch.stack(parts, dim=-1).reshape(scalar_limbs.shape[0], -1)


def signed_digits(scalar_limbs: torch.Tensor, c: int) -> torch.Tensor:
    """[N, Lr] plain 16-bit limbs -> [W, N] int32 signed digits d in
    (-2^(c-1), 2^(c-1)] with sum_w d_w 2^(c w) == scalar, window-major.

    These are the digits of the carry recoding v = raw + carry, d = v or
    v - 2^c when v > 2^(c-1) (``tpu_zk``'s at c = 5): adding h = 2^(c-1) - 1
    to every window and subtracting it from every c-bit piece of the sum
    gives the same unique digits, with no carry from window to window.
    """
    n, lr = scalar_limbs.shape
    device = scalar_limbs.device
    W = window_count(16 * lr, c)
    bias = sum(((1 << (c - 1)) - 1) << (c * w) for w in range(W))
    width = -(-c * W // 16) + 1  # limbs of the sum, and one above for the last window's two-limb read
    u = torch.zeros((width, n), dtype=torch.int32, device=device)
    u[:lr] = scalar_limbs.T
    u += torch.tensor([(bias >> (16 * k)) & 0xFFFF for k in range(width)], dtype=torch.int32, device=device)[:, None]
    carry = torch.zeros((n,), dtype=torch.int32, device=device)
    for k in range(width):  # each limb below 2^17: one carry bit
        v = u[k] + carry
        u[k] = v & 0xFFFF
        carry = v >> 16
    # window w: the c bits of u from bit c w, across limbs j and j + 1
    offset = c * torch.arange(W, device=device)
    j, r = offset // 16, (offset % 16).to(torch.int32)[:, None]
    hi_mask = (1 << (c - 16 + r).clamp(min=0)) - 1  # bits of window w in limb j + 1
    raw = (u[j] >> r) | ((u[j + 1] & hi_mask) << (16 - r))
    return (raw & ((1 << c) - 1)) - ((1 << (c - 1)) - 1)


def _bucket_entries(digits: torch.Tensor, c: int) -> tuple[torch.Tensor, torch.Tensor]:
    """[W, N] signed digits -> (entries [W N] int32, counts [W B] int64).

    Bucket (w, b) holds the points whose window-w digit is +-(b+1); its
    entries are ``counts[w B + b]`` consecutive ones, buckets in order, each
    a point index with SIGN set for a negative digit, by a stable sort (the
    order does not depend on scheduling).  Entries past the last bucket's
    are the zero digits'."""
    W, n = digits.shape
    if W * n >= 1 << 31:
        raise ValueError(f"MSM of {n} points in {W} windows: entries and unit starts are int32")
    B = 1 << (c - 1)
    mag = digits.abs()
    first = (torch.arange(W, device=digits.device, dtype=torch.int32) * B)[:, None]
    keys = torch.where(mag > 0, first + mag - 1, W * B).view(-1)
    sorted_keys, order = torch.sort(keys, stable=True)
    del keys
    bounds = torch.searchsorted(sorted_keys, torch.arange(W * B + 1, device=digits.device, dtype=torch.int32))
    del sorted_keys
    point = (order % n).to(torch.int32)
    entries = torch.where(digits.view(-1)[order] < 0, point | SIGN, point)
    return entries, bounds.diff()


def _unit_table(counts: torch.Tensor, unit: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Groups of counts[g] consecutive rows (group g's after group g-1's) ->
    (units [U, 2] int32 (start, count), units per group): each group cut
    into runs of at most ``unit`` rows; an empty group gets one empty unit,
    so a pass gives every group a row.  One synchronization (U)."""
    per_group = ((counts + unit - 1) // unit).clamp(min=1)
    ends = per_group.cumsum(0)
    U = int(ends[-1])
    group = torch.repeat_interleave(torch.arange(counts.shape[0], device=counts.device), per_group, output_size=U)
    j = torch.arange(U, device=counts.device) - (ends - per_group)[group]
    start = (counts.cumsum(0) - counts)[group] + j * unit
    count = (counts[group] - j * unit).clamp(max=unit)
    return torch.stack([start, count], dim=1).to(torch.int32), per_group


def _sum_groups(ctx: FieldCtx, b3: torch.Tensor, points: Point, entries: torch.Tensor | None, counts: torch.Tensor,
                unit: int = UNIT) -> torch.Tensor:
    """Sum each group of ``counts[g]`` consecutive entries (rows of the
    points when ``entries`` is None) -> [G, 3, L], by K4a passes: units of
    at most ``unit``, then each group's partials again, until one is left."""
    G = counts.shape[0]
    while True:
        units, counts = _unit_table(counts, unit)
        rows = msm_buckets(ctx, b3, points, entries, units)
        if rows.shape[0] == G:
            return rows
        points, entries = rows_to_points(rows), None


def _window_sums(ctx: FieldCtx, b3: torch.Tensor, segments: torch.Tensor) -> torch.Tensor:
    """K4b's segment totals [W, S, 3, L] -> each window's sum [W, 3, L]."""
    W, S = segments.shape[:2]
    counts = torch.full((W,), S, dtype=torch.int64, device=segments.device)
    return _sum_groups(ctx, b3, rows_to_points(segments.view(W * S, 3, ctx.L)), None, counts)


def _combine_windows(ctx: FieldCtx, b3: torch.Tensor, windows: torch.Tensor, c: int) -> Point:
    """[W, 3, L] window sums -> sum_w 2^(c w) S_w as an [L]x3 point on the
    same device, by Horner's rule on host ints (the sums cross in one copy)."""
    p = ctx.p
    b3_host = host_ec.Fp(p, ctx.to_ints(b3))
    flat = ctx.to_ints(windows.reshape(-1, ctx.L))
    acc = (host_ec.Fp(p, 0), host_ec.Fp(p, 1), host_ec.Fp(p, 0))
    for w in reversed(range(windows.shape[0])):
        if acc[2].v:  # doubling the identity changes nothing
            for _ in range(c):
                acc = host_ec.ec_double(acc, b3_host)
        X, Y, Z = flat[3 * w : 3 * w + 3]
        acc = host_ec.ec_add(acc, (host_ec.Fp(p, X), host_ec.Fp(p, Y), host_ec.Fp(p, Z)), b3_host)
    return tuple(ctx.scalar(v.v, device=b3.device) for v in acc)


def msm_pippenger(ctx: FieldCtx, b3: torch.Tensor, inputs, c: int | None = None) -> Point:
    """inputs = (points ([N,L],)*3, scalar_limbs_plain [N,Lr]) -> single point.

    ``c``: the window's bits (default :func:`window_bits` of N)."""
    points, scalar_limbs = inputs
    n = points[0].shape[0]
    if n == 0:
        return ec_identity(ctx, device=scalar_limbs.device)
    c = c or window_bits(n, 16 * scalar_limbs.shape[1])
    digits = signed_digits(scalar_limbs, c)
    W, B = digits.shape[0], 1 << (c - 1)
    entries, counts = _bucket_entries(digits, c)
    del digits
    buckets = _sum_groups(ctx, b3, tuple(t.contiguous() for t in points), entries, counts)  # [W B, 3, L]
    del entries
    segments = msm_bucket_reduce(ctx, b3, buckets.view(W, B, 3, ctx.L), min(SEGMENT, B))
    del buckets
    return _combine_windows(ctx, b3, _window_sums(ctx, b3, segments), c)
