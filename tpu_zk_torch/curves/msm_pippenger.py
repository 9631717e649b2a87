"""Pippenger (bucket-method) MSM: signed base-32 digits, every window in one
kernel launch.  Counterpart of :mod:`tpu_zk.curves.msm_pippenger`.

Signed base-32 digits in [-16, 16] need only 16 buckets for their magnitudes
(a negative digit is one conditional Y negate in the kernel), so a 255-bit
scalar takes 52 + 1 windows.  The stages:

1. :func:`signed_digit_codes`: one byte per (window, point), plain torch;
2. K4a (:func:`.kernels.msm_buckets`): each of P lanes per window sums its
   points into 16 buckets;
3. K4b (:func:`.kernels.msm_bucket_reduce`): each lane's weighted bucket
   total sum_b (b+1) S_b;
4. a pairwise tree over the P lanes of every window (:func:`ec_device.ec_add`,
   K1/K3 launches), log2(P) levels over [W, P/2^k] points;
5. the window combine sum_w 32^w S_w, on the host: the W = 53 window sums are
   copied over and combined by Horner's rule on Python ints
   (:func:`host_ec.ec_add`, ~320 additions, a few milliseconds).  On the
   device the same combine is ~320 *sequential* complete adds of ~40 small
   launches each; the group element is the same either way.

``tpu_zk``'s version rebases points to radix-2^13 limbs and pads N to the
kernel's tile; both answer the TPU's vector unit and tiling and have no
counterpart here: the kernel works on the 32-bit limbs of the storage format
and masks its ragged tail itself.

Below ``BUCKET_THRESHOLD`` points the bucket machinery does not pay and the
double-and-add :func:`ec_device.msm` runs instead; it gives the same group
element.
"""

from __future__ import annotations

import torch

from ..fields.arith import FieldCtx
from . import host_ec
from .ec_device import Point, msm, tree_reduce
from .kernels import default_lanes, msm_bucket_reduce, msm_buckets

WINDOW_BITS = 5  # signed base-32 digits
BUCKET_THRESHOLD = 2048  # points from which the bucket method runs


def _digits(scalar_limbs: torch.Tensor, c: int) -> torch.Tensor:
    """[N, L] 16-bit limbs -> [N, W] unsigned c-bit digits (LSB window first)."""
    if c == 16:
        return scalar_limbs
    parts = [(scalar_limbs >> s) & ((1 << c) - 1) for s in range(0, 16, c)]
    return torch.stack(parts, dim=-1).reshape(scalar_limbs.shape[0], -1)


def _codes_by_window(scalar_limbs: torch.Tensor) -> torch.Tensor:
    """[N, Lr] plain 16-bit limbs -> [D, N] uint8 codes, window-major (the
    layout K4a reads).  One window at a time, so nothing of size D x N
    exists besides the result."""
    n, lr = scalar_limbs.shape
    d_count = -(-16 * lr // WINDOW_BITS)
    codes = torch.empty((d_count + 1, n), dtype=torch.uint8, device=scalar_limbs.device)
    carry = torch.zeros((n,), dtype=torch.int32, device=scalar_limbs.device)
    for i in range(d_count):
        j, r = divmod(WINDOW_BITS * i, 16)
        v = scalar_limbs[:, j] >> r  # raw base-32 digit, crossing limb boundaries
        if r > 16 - WINDOW_BITS and j + 1 < lr:
            v = v | (scalar_limbs[:, j + 1] << (16 - r))
        v = (v & 31) + carry  # in [0, 32]
        carry = (v > 16).to(torch.int32)
        mag = torch.where(v > 16, 32 - v, v)  # |d| in [0, 16]
        codes[i] = ((mag - 1).clamp(min=0) | (carry << 5) | ((mag == 0).to(torch.int32) << 6)).to(torch.uint8)
    codes[d_count] = torch.where(carry == 1, 0, 64).to(torch.uint8)  # final carry window: digit in {0, 1}
    return codes


def signed_digit_codes(scalar_limbs: torch.Tensor) -> torch.Tensor:
    """[N, Lr] plain 16-bit limbs -> [N, D] packed signed base-32 digits.

    Each code packs ``(|d|-1) | sign << 5 | skip << 6`` for digits
    d in [-16, 16] with sum_i d_i * 32^i == scalar; skip marks d == 0.
    D = ceil(16*Lr / 5) + 1 (one extra window for the final carry).
    """
    return _codes_by_window(scalar_limbs).T.to(torch.int32)


def _combine_windows(ctx: FieldCtx, b3: torch.Tensor, windows: Point) -> Point:
    """([W, L],)*3 window sums -> sum_w 32^w S_w as an [L]x3 point on the
    same device, by Horner's rule on host ints."""
    p = ctx.p
    b3_host = host_ec.Fp(p, ctx.to_ints(b3))
    coords = [ctx.to_ints(c) for c in windows]
    acc = (host_ec.Fp(p, 0), host_ec.Fp(p, 1), host_ec.Fp(p, 0))
    for X, Y, Z in reversed(list(zip(*coords))):
        for _ in range(WINDOW_BITS):
            acc = host_ec.ec_add(acc, acc, b3_host)
        acc = host_ec.ec_add(acc, (host_ec.Fp(p, X), host_ec.Fp(p, Y), host_ec.Fp(p, Z)), b3_host)
    return tuple(ctx.scalar(c.v, device=b3.device) for c in acc)


def msm_pippenger(ctx: FieldCtx, b3: torch.Tensor, inputs, lanes: int | None = None,
                  threshold: int | None = None) -> Point:
    """inputs = (points ([N,L],)*3, scalar_limbs_plain [N,Lr]) -> single point.

    ``threshold``: the number of points from which the bucket method runs
    (default ``BUCKET_THRESHOLD``); ``lanes``: K4a's P (default
    :func:`.kernels.default_lanes`).
    """
    points, scalar_limbs = inputs
    N = points[0].shape[0]
    if N < (BUCKET_THRESHOLD if threshold is None else threshold):
        shifts = torch.arange(16, dtype=torch.int32, device=scalar_limbs.device)
        bits = ((scalar_limbs[..., None] >> shifts) & 1).reshape(N, -1)
        return msm(ctx, b3, points, bits)

    codes = _codes_by_window(scalar_limbs)
    points = tuple(c.contiguous() for c in points)
    P = lanes or default_lanes(ctx, N, codes.shape[0], codes.device)
    buckets = msm_buckets(ctx, b3, points, codes, P)
    lane_sums = msm_bucket_reduce(ctx, b3, buckets)  # ([W, P, L],)*3
    del buckets
    return _combine_windows(ctx, b3, tree_reduce(ctx, b3, lane_sums, dim=1))

