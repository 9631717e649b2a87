"""The NTT-pass kernel (K6): its wrapper and plain version.

K6 ``dif_pass``: one batched radix-m DIF pass of the multi-pass NTT.  The
table is viewed as ``[A, m, C, L]``; each of the A*C columns (its m elements
along the middle axis) is optionally multiplied elementwise by ``pre``, runs
log2(m) Gentleman-Sande stages (``lo = u + v``, ``hi = (u - v) * w``, stage s
slot j taking w_m^(j << s) from ``tws[0, j << s]``, and ``hi = u - v`` where
j = 0), so that position j ends up holding the DFT's output k = bitrev(j), is
optionally multiplied by ``scale``, and is stored at its own position or,
with ``dst``, at the row that ``dst`` names (the plan's last pass stores in
natural order that way).  ``tws`` keeps the plan's [log2 m, m/2, L] shape
(stage s slot j = w_m^(j << s)), but only ``tws[0, 1:]`` is read: ``tws[1:]``
and ``tws[:, 0]`` are not, so the kernel and the plain version agree for any
values there.
Replaces ``tpu_zk/ntt/sixstep.py:112 _batched_dif`` and
``tpu_zk/fields/mxu_mul.py:405 dft_mxu``, which compute that function on
``[L, m, B]`` blocks (``B = A * C`` with ``A = 1``, or ``C = 1``).

It is bound by operations: a CIOS product (2 (L/2)^2 wide multiply-adds, or
4 (L/2)^2 32-bit ones) per butterfly whose twiddle is not 1 (all but m - 1 of
a column's m/2 log2 m), per pre-twiddle and per scaled element.  What the
design does about it is in ``csrc/ntt.cu``: no product by w^0, tiles of whole
columns on every pass, radix-4 rounds in registers between exchanges through
shared memory, six blocks of 128 threads an SM so that some blocks' loads
run under the others' products, and field.cuh's even/odd product.

The wrapper runs the plain PyTorch version when its tensors lie on the CPU,
and for CUDA tensors launches the kernel (built by :mod:`tpu_zk_torch._build`
at first use) or raises.  It keeps a count of its kernel launches in its
``launches`` attribute.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..fields import arith
from ..fields.kernels import _check_limbs, _device_index, _launch, _launch_args, _ptr, _raise_on
from ..fields.kernels import add_plain, mont_mul_plain, sub_plain

MAX_LOG_M = 10  # the largest radix the kernel takes (csrc/ntt.cu kNttMaxLogM)


def dif_pass_plain(ctx: arith.FieldCtx, x: torch.Tensor, tws: torch.Tensor, pre: torch.Tensor | None = None,
                   scale: torch.Tensor | None = None, dst: torch.Tensor | None = None) -> torch.Tensor:
    """x [A, m, C, L], tws [log2 m, m/2, L], pre like x or None, scale [L]
    or None (all Montgomery) -> [A, m, C, L]: the DIF pass over axis 1.
    With ``dst`` (int64 [A*m*C], a permutation), the element at flat
    position i lands in row dst[i] of the output."""
    A, m, C, L = x.shape
    t = x if pre is None else mont_mul_plain(ctx, x, pre)
    for s in range(m.bit_length() - 1):
        H = m >> (s + 1)
        y = t.reshape(A, m // (2 * H), 2, H, C, L)
        u, v = y[:, :, 0], y[:, :, 1]
        lo = add_plain(ctx, u, v)
        hi = sub_plain(ctx, u, v)  # slot 0: w^0, no product
        if H > 1:
            w = tws[0, :: 1 << s]  # slot j: w_m^(j << s), j < H
            hi[:, :, 1:] = mont_mul_plain(ctx, hi[:, :, 1:], w[1:, None, :])
        t = torch.stack([lo, hi], dim=2).reshape(A, m, C, L)
    if scale is not None:
        t = mont_mul_plain(ctx, t, scale)
    if dst is not None:
        out = torch.empty_like(t).view(-1, L)
        out[dst] = t.reshape(-1, L)
        t = out.view(A, m, C, L)
    return t


def dif_pass(ctx: arith.FieldCtx, x: torch.Tensor, tws: torch.Tensor, pre: torch.Tensor | None = None,
             scale: torch.Tensor | None = None, dst: torch.Tensor | None = None) -> torch.Tensor:
    """K6: see :func:`dif_pass_plain` for the contract."""
    return _dif_pass(ctx, x, tws, pre, scale, dst, count=False)[0]


def dif_pass_products(ctx: arith.FieldCtx, x: torch.Tensor, tws: torch.Tensor, pre: torch.Tensor | None = None,
                      scale: torch.Tensor | None = None, dst: torch.Tensor | None = None) -> tuple[torch.Tensor, int]:
    """K6 as :func:`dif_pass`, and the Montgomery products it made: on the
    card as the kernel's threads counted them, for CPU tensors by the plain
    version's rule (one a butterfly off slot 0, a pre-twiddle, a scaled
    element)."""
    return _dif_pass(ctx, x, tws, pre, scale, dst, count=True)


def _dif_pass(ctx, x, tws, pre, scale, dst, count: bool):
    if x.dim() != 4:
        raise ValueError(f"dif_pass: x must be [A, m, C, L], got shape {tuple(x.shape)}")
    A, m, C, L = x.shape
    log_m = m.bit_length() - 1
    if m != 1 << log_m:
        raise ValueError(f"dif_pass: radix {m} is not a power of two")
    _check_limbs("x", x, ctx.L)
    _check_limbs("tws", tws, ctx.L)
    if tws.shape != (log_m, max(m // 2, 1), L):
        raise ValueError(f"dif_pass: tws must be [{log_m}, {max(m // 2, 1)}, {L}], got {tuple(tws.shape)}")
    operands = [x, tws]
    if pre is not None:
        _check_limbs("pre", pre, ctx.L)
        if pre.shape != x.shape:
            raise ValueError(f"dif_pass: pre {tuple(pre.shape)} must match x {tuple(x.shape)}")
        operands.append(pre)
    if scale is not None:
        _check_limbs("scale", scale, ctx.L)
        if scale.dim() != 1:
            raise ValueError("dif_pass: scale must be one [L] element")
        operands.append(scale)
    if dst is not None:
        if dst.dtype != torch.int64 or dst.shape != (A * m * C,) or not dst.is_contiguous():
            raise ValueError(f"dif_pass: dst must be a contiguous int64 [{A * m * C}] permutation")
        operands.append(dst)
    index = _device_index(*operands)
    if index < 0:
        n = A * m * C
        products = A * C * (m // 2 * log_m - (m - 1)) + (n if pre is not None else 0) + (n if scale is not None else 0)
        return dif_pass_plain(ctx, x, tws, pre, scale, dst), products
    if L != 16 or log_m > MAX_LOG_M:
        raise ValueError(f"dif_pass: the kernel takes L = 16 and radix up to 2^{MAX_LOG_M}, got L = {L}, m = {m}")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out, 0
    # one count per thread of the launch, which has at most A m C + 1024 threads
    counts = torch.zeros(A * m * C + 1024, dtype=torch.int64, device=x.device) if count else None
    p32, n0inv = _launch_args(ctx)
    null = ctypes.c_void_p(None)
    rc = _launch(
        _build.kernel_library().tzk_ntt_pass, index,
        _ptr(x), _ptr(tws) if tws.numel() else null, null if pre is None else _ptr(pre),
        null if scale is None else _ptr(scale), null if dst is None else _ptr(dst), _ptr(out), ctypes.c_int64(A),
        ctypes.c_int(log_m), ctypes.c_int64(C), ctypes.c_int(L), p32, n0inv,
        null if counts is None else _ptr(counts),
    )
    _raise_on(rc, "dif_pass")
    dif_pass.launches += 1
    return out, int(counts.sum()) if count else None


dif_pass.launches = 0
