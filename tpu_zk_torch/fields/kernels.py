"""The field layer's three CUDA kernels: their wrappers and plain versions.

K1 ``mont_mul``: elementwise Montgomery product a*b*R^-1 mod p.
    Replaces ``tpu_zk/fields/pallas_kernels.py:142 mont_mul_pallas`` (CIOS
    body ``_mont_mul_rows`` :77).  With a broadcast [L] operand it is also the
    counterpart of ``tpu_zk/fields/mxu_mul.py:241 mul_const_mxu_pallas``.
K2 ``fold``: fused sumcheck fold lo + r*(hi - lo) with per-block wide sums.
    Replaces ``tpu_zk/fields/pallas_kernels.py:222 fold_pallas`` and
    ``tpu_zk/fields/mxu_mul.py:296 fold_mxu_lm`` (and their caller-less twin
    ``mxu_mul.py:187 fold_mxu_pallas``), which compute the same function.
K3 ``addsub``: elementwise modular add or subtract.
    Replaces ``tpu_zk/fields/pallas_kernels.py:176 addsub_pallas`` and
    ``:294 addsub_lm_pallas`` (bodies ``_add_rows`` :123, ``_sub_rows`` :130).

Each wrapper runs its plain PyTorch version when its tensors lie on the CPU,
and for CUDA tensors launches the kernel (sources in ``tpu_zk_torch/csrc``,
built by :mod:`tpu_zk_torch._build` at first use) or raises.  Each keeps a
count of its kernel launches in its ``launches`` attribute.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..utils import counters
from . import arith

# K2's per-block limb sums stay below 2^32 only while a block sums at most
# 2^16 elements of 16-bit limbs
MAX_FOLD_BLOCK = 1 << 16


# ---------------------------------------------------------------------------
# plain versions (any device)
# ---------------------------------------------------------------------------


def mont_mul_plain(ctx: arith.FieldCtx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """CIOS Montgomery product over 16-bit limbs, in int64 (broadcasting).

    A limb collects at most 2L products below 2^32 each, so every lazy limb
    stays below 2^38 and ``limb * n0inv`` below 2^54.
    """
    L = ctx.L
    a64 = a.to(torch.int64)
    b64 = b.to(torch.int64)
    shape = torch.broadcast_shapes(a.shape, b.shape)[:-1]
    n = arith.p_limbs(ctx, L, a.device)
    acc = torch.zeros(shape + (2 * L + 2,), dtype=torch.int64, device=a.device)
    for i in range(L):
        acc[..., i : i + L] += a64[..., i : i + 1] * b64
        m = (acc[..., i] * ctx.n0inv) & arith.MASK
        acc[..., i : i + L] += m[..., None] * n
        acc[..., i + 1] += acc[..., i] >> arith.LIMB_BITS  # limb i is 0 mod B now
    # acc[L:] holds (a*b + M*p) / R < 2p
    strict = arith.carry_propagate(acc[..., L:], L + 2)[..., : L + 1]
    return arith.cond_sub_p(ctx, strict)


def add_plain(ctx: arith.FieldCtx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b mod p of canonical elements [..., L] (broadcasting), in int64."""
    s = arith.carry_propagate(a.to(torch.int64) + b.to(torch.int64), ctx.L + 1)
    return arith.cond_sub_p(ctx, s)


def sub_plain(ctx: arith.FieldCtx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b mod p of canonical elements [..., L]: a - b + p, then reduce."""
    p = arith.p_limbs(ctx, ctx.L, a.device)
    s = arith.carry_propagate(a.to(torch.int64) - b.to(torch.int64) + p, ctx.L + 1)
    return arith.cond_sub_p(ctx, s)


def fold_plain(ctx: arith.FieldCtx, flat: torch.Tensor, r: torch.Tensor, block: int):
    """Fold variable 0 of each row and sum the folded values block by block.

    flat [B, 2T, L] Montgomery, r [L] Montgomery ->
    (folded [B, T, L] = lo + r*(hi - lo), sums [B, G, L+2]), G = ceil(T/block):
    strict wide limbs of each block's sum of folded values, the last block
    ragged.  Same contract as ``fold_pallas``'s per-block sums.
    """
    B, N2, L = flat.shape
    T = N2 // 2
    lo, hi = flat[:, :T], flat[:, T:]
    folded = add_plain(ctx, lo, mont_mul_plain(ctx, sub_plain(ctx, hi, lo), r))
    G = -(-T // block)
    padded = torch.zeros((B, G * block, L), dtype=torch.int64, device=flat.device)
    padded[:, :T] = folded
    lazy = padded.view(B, G, block, L).sum(dim=2)
    return folded, arith.carry_propagate(lazy, L + 2)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _device_index(*tensors: torch.Tensor) -> int:
    """-1 if all lie on the CPU, the card's index if all lie on one CUDA
    device; else raise."""
    index = tensors[0].get_device()
    for t in tensors:
        if t.get_device() != index or (index < 0 and not t.is_cpu):
            raise ValueError(f"tensors on different devices: {sorted({str(t.device) for t in tensors})}")
    return index


def _check_limbs(name: str, t: torch.Tensor, L: int) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected torch.int32 limbs, got {t.dtype}")
    if t.shape[-1] != L:
        raise ValueError(f"{name}: last axis must hold L={L} limbs, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _launch_args(ctx: arith.FieldCtx):
    """The modulus as 32-bit limbs (host array) and -p^{-1} mod 2^32."""
    n = ctx.L // 2
    p32 = (ctypes.c_uint32 * n)(*[(ctx.p >> (32 * i)) & 0xFFFFFFFF for i in range(n)])
    return p32, ctypes.c_uint32(ctx.n0inv32)


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {rc}")


def _ptr(t: torch.Tensor, align: int = 16) -> int:
    """``t``'s address, checked to be ``align``-byte aligned."""
    p = t.data_ptr()
    if p % align:
        raise ValueError(f"kernel operands must be {align}-byte aligned")
    return p


def _launch(entry, index: int, *args) -> int:
    """Call the kernel library's ``entry`` with ``args`` and the current
    stream of card ``index``, the card the operands lie on, with that card
    the current one: the runtime launches on the current card, which for a
    shard on another card than the first is not the operands' unless set
    (the switch is made only then)."""
    stream = torch.cuda.current_stream(index).cuda_stream
    if index == torch.cuda.current_device():
        return entry(*args, stream)
    with torch.cuda.device(index):
        return entry(*args, stream)


def mont_mul(ctx: arith.FieldCtx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K1: a [M, L] x b ([M, L] or broadcast [L]) -> [M, L], canonical int32."""
    _check_limbs("a", a, ctx.L)
    _check_limbs("b", b, ctx.L)
    if a.dim() != 2 or b.dim() not in (1, 2) or (b.dim() == 2 and b.shape != a.shape):
        raise ValueError(f"mont_mul: shapes {tuple(a.shape)} x {tuple(b.shape)}")
    index = _device_index(a, b)
    if index < 0:
        return mont_mul_plain(ctx, a, b)
    out = torch.empty_like(a)
    M = a.shape[0]
    if M == 0:
        return out
    p32, n0inv = _launch_args(ctx)
    rc = _launch(
        _build.kernel_library().tzk_mont_mul, index,
        _ptr(a), _ptr(b), _ptr(out), ctypes.c_int64(M), ctypes.c_int(int(b.dim() == 1)),
        ctypes.c_int(ctx.L), p32, n0inv,
    )
    _raise_on(rc, "mont_mul")
    mont_mul.launches += 1
    return out


mont_mul.launches = 0


def addsub(ctx: arith.FieldCtx, a: torch.Tensor, b: torch.Tensor, kind: str) -> torch.Tensor:
    """K3: a [M, L] +/- b ([M, L] or broadcast [L]) -> [M, L], canonical int32.

    ``kind`` is ``"add"`` or ``"sub"``, as for ``addsub_pallas``.
    """
    if kind not in ("add", "sub"):
        raise ValueError(f"addsub: kind must be 'add' or 'sub', got {kind!r}")
    _check_limbs("a", a, ctx.L)
    _check_limbs("b", b, ctx.L)
    if a.dim() != 2 or b.dim() not in (1, 2) or (b.dim() == 2 and b.shape != a.shape):
        raise ValueError(f"addsub: shapes {tuple(a.shape)} {kind} {tuple(b.shape)}")
    index = _device_index(a, b)
    if index < 0:
        return (add_plain if kind == "add" else sub_plain)(ctx, a, b)
    out = torch.empty_like(a)
    M = a.shape[0]
    if M == 0:
        return out
    p32, _ = _launch_args(ctx)
    rc = _launch(
        _build.kernel_library().tzk_addsub, index,
        _ptr(a), _ptr(b), _ptr(out), ctypes.c_int64(M), ctypes.c_int(int(b.dim() == 1)),
        ctypes.c_int(int(kind == "sub")), ctypes.c_int(ctx.L), p32,
    )
    _raise_on(rc, "addsub")
    addsub.launches += 1
    return out


addsub.launches = 0


def fold(ctx: arith.FieldCtx, flat: torch.Tensor, r: torch.Tensor, block: int):
    """K2: flat [B, 2T, L], r [L] (Montgomery) ->
    (folded [B, T, L], per-block sums [B, ceil(T/block), L+2]); see
    :func:`fold_plain` for the contract."""
    _check_limbs("flat", flat, ctx.L)
    _check_limbs("r", r, ctx.L)
    if flat.dim() != 3 or flat.shape[1] < 2 or flat.shape[1] % 2 or r.dim() != 1:
        raise ValueError(f"fold: shapes {tuple(flat.shape)}, r {tuple(r.shape)}")
    if not 1 <= block <= MAX_FOLD_BLOCK:
        raise ValueError(f"fold: block {block} outside [1, {MAX_FOLD_BLOCK}]")
    if counters._enabled:  # lo + r * (hi - lo): a sub, a product and an add an output element
        lo = flat[:, : flat.shape[1] // 2]
        for op in ("sub", "mul", "add"):
            counters.bump(ctx.name, op, lo)
    index = _device_index(flat, r)
    if index < 0:
        return fold_plain(ctx, flat, r, block)
    B, N2, L = flat.shape
    T = N2 // 2
    G = -(-T // block)
    folded = torch.empty((B, T, L), dtype=torch.int32, device=flat.device)
    sums = torch.empty((B, G, L + 2), dtype=torch.int32, device=flat.device)
    if B == 0:
        return folded, sums
    p32, n0inv = _launch_args(ctx)
    rc = _launch(
        _build.kernel_library().tzk_fold, index,
        _ptr(flat), _ptr(r), _ptr(folded), ctypes.c_void_p(sums.data_ptr()),
        ctypes.c_int64(B), ctypes.c_int64(T), ctypes.c_int64(block),
        ctypes.c_int(L), p32, n0inv,
    )
    _raise_on(rc, "fold")
    fold.launches += 1
    return folded, sums


fold.launches = 0
