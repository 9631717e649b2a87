"""Prime-field arithmetic over 16-bit limbs held in ``torch.int32`` tensors.

A field element is ``L`` little-endian 16-bit limbs (``L = ceil(bits/16)``,
``R = 2**(16*L) > p``); arrays of elements are ``[..., L]`` tensors of dtype
``torch.int32``.  These are the same integers as :mod:`tpu_zk.fields.arith`'s
``uint32`` arrays: torch has no uint32 arithmetic on the CPU, and every limb
fits in 16 bits, so int32 is a lossless carrier.  Products of two limbs
overflow int32, so the plain operations below upcast to int64 inside and
carry every lazy limb with a sequential signed carry pass.

Device data is in Montgomery form, ``mont(x) = x*R mod p``.  ``mont_mul``,
``to_mont`` and ``from_mont`` go through the K1 kernel wrapper, ``add``,
``sub`` and ``neg`` through the K3 wrapper (:mod:`.kernels`); each launches
its CUDA kernel for CUDA tensors and runs its plain version for CPU tensors.
Everything else here is plain torch on whatever device its inputs lie on.
Tensors made from host ints go to :mod:`tpu_zk_torch.device`'s default (the
CUDA card) unless the caller names a device.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve
from ..utils import counters
from . import kernels
from .primes import PRIMES, SERIALIZED_BYTES

LIMB_BITS = 16
MASK = 0xFFFF
BASE = 1 << LIMB_BITS


def _limbs_of_int(x: int, n: int) -> tuple[int, ...]:
    return tuple((x >> (LIMB_BITS * i)) & MASK for i in range(n))


@functools.lru_cache(maxsize=None)
def _const(limbs: tuple[int, ...], device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """A small constant limb vector on ``device`` (cached; never mutate it)."""
    return torch.tensor(limbs, dtype=dtype, device=device)


def _ints_to_limbs(values: list[int], L: int) -> np.ndarray:
    """Canonical ints -> [N, L] int32 limbs (one bytes join, no per-limb loop)."""
    buf = b"".join(v.to_bytes(2 * L, "little") for v in values)
    return np.frombuffer(buf, dtype="<u2").reshape(-1, L).astype(np.int32)


@dataclass(frozen=True, eq=False)
class FieldCtx:
    """Static parameters of a prime field in limb representation."""

    name: str
    p: int
    L: int
    nbytes: int  # serialized (arkworks bigint) byte width
    n0inv: int  # -p^{-1} mod 2^16
    R: int  # 2^(16L) mod p
    R2: int  # R^2 mod p
    Rinv: int
    n0inv32: int  # -p^{-1} mod 2^32, for the kernels' 32-bit-limb CIOS

    def __hash__(self):
        return hash(self.name)

    def __eq__(self, other):
        return isinstance(other, FieldCtx) and self.name == other.name

    # -- host-side helpers ---------------------------------------------------
    def to_limbs(self, x: int) -> np.ndarray:
        """The canonical int ``x`` as [L] int32 limbs (host array)."""
        return np.array(_limbs_of_int(x % self.p, self.L), np.int32)

    def from_limbs(self, limbs) -> int:
        return sum(int(v) << (LIMB_BITS * i) for i, v in enumerate(limbs))

    def to_mont_int(self, x: int) -> int:
        return (x % self.p) * self.R % self.p

    def from_mont_int(self, x: int) -> int:
        return x * self.Rinv % self.p

    def limbs(self, x: int, device, dtype: torch.dtype = torch.int32) -> torch.Tensor:
        """Cached [L] limb constant of the canonical int ``x`` on ``device``."""
        return _const(_limbs_of_int(x % self.p, self.L), torch.device(device), dtype)

    @property
    def zero(self) -> torch.Tensor:
        """[L] zero limbs on the package's default device."""
        return torch.zeros(self.L, dtype=torch.int32, device=resolve(None))

    def one_mont(self, device) -> torch.Tensor:
        """Cached [L] Montgomery one (R mod p) on ``device``."""
        return self.limbs(self.R, device)

    def array(self, values, mont: bool = True, device=None) -> torch.Tensor:
        """Host ints -> [N, L] int32 tensor (Montgomery form by default), on
        ``device`` or, when none is given, the package's default device."""
        vals = [self.to_mont_int(v) if mont else v % self.p for v in values]
        return torch.from_numpy(_ints_to_limbs(vals, self.L)).to(resolve(device))

    def scalar(self, value: int, mont: bool = True, device=None) -> torch.Tensor:
        """Host int -> [L] int32 tensor, placed as :meth:`array` places it."""
        v = self.to_mont_int(value) if mont else value % self.p
        return torch.tensor(_limbs_of_int(v, self.L), dtype=torch.int32, device=resolve(device))

    def to_ints(self, t: torch.Tensor, mont: bool = True):
        """[..., L] limbs -> canonical python ints (one int for a single [L])."""
        a = t.detach().to("cpu").numpy().reshape(-1, self.L)
        buf = a[:, ::-1].astype(">u2").tobytes()
        per = self.L * 2
        scale = self.Rinv if mont else 1
        p = self.p
        out = [int.from_bytes(buf[i : i + per], "big") * scale % p for i in range(0, len(buf), per)]
        return out[0] if t.dim() == 1 else out

    # -- serialization (transcript parity) ----------------------------------
    def to_bytes_be(self, x: int) -> bytes:
        """arkworks ``into_bigint().to_bytes_be()`` equivalent."""
        return int(x % self.p).to_bytes(self.nbytes, "big")

    def to_bytes_le(self, x: int) -> bytes:
        return int(x % self.p).to_bytes(self.nbytes, "little")

    def from_le_bytes_mod_order(self, b: bytes) -> int:
        return int.from_bytes(b, "little") % self.p


@functools.lru_cache(maxsize=None)
def field_ctx(name: str) -> FieldCtx:
    p = PRIMES[name]
    L = (p.bit_length() + LIMB_BITS - 1) // LIMB_BITS
    # one conditional subtract in CIOS and in add/sub needs 2p < B^L; the
    # kernels' 32-bit limbs (L/2 of them) span the same R = 2^(16L)
    assert 2 * p < (1 << (LIMB_BITS * L)) and L % 2 == 0
    R = (1 << (LIMB_BITS * L)) % p
    return FieldCtx(
        name=name,
        p=p,
        L=L,
        nbytes=SERIALIZED_BYTES[name],
        n0inv=(-pow(p, -1, BASE)) % BASE,
        R=R,
        R2=R * R % p,
        Rinv=pow(R, -1, p),
        n0inv32=(-pow(p, -1, 1 << 32)) % (1 << 32),
    )


# ---------------------------------------------------------------------------
# limb machinery (plain torch over [..., W] tensors)
# ---------------------------------------------------------------------------


def p_limbs(ctx: FieldCtx, width: int, device) -> torch.Tensor:
    """The modulus as ``width`` int64 limbs on ``device`` (cached)."""
    return _const(_limbs_of_int(ctx.p, width), torch.device(device), torch.int64)


def _propagate(t: torch.Tensor, width: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Signed lazy limbs [..., W] -> (strict int32 limbs [..., width], carry out).

    Each limb may be any int64 (negative included) as long as the running
    carry fits; the carry out is what exceeds B^width (negative on borrow).
    """
    t = t.to(torch.int64)
    W = t.shape[-1]
    out = torch.empty(t.shape[:-1] + (width,), dtype=torch.int32, device=t.device)
    c = torch.zeros(t.shape[:-1], dtype=torch.int64, device=t.device)
    for k in range(width):
        v = c + t[..., k] if k < W else c
        out[..., k] = v & MASK
        c = v >> LIMB_BITS
    return out, c


def carry_propagate(t: torch.Tensor, out_width: int | None = None) -> torch.Tensor:
    """Lazy limbs (value < B^out_width) -> strict int32 limbs.

    The output is ``max(W, out_width)`` limbs wide (``W + 1`` by default),
    as in :func:`tpu_zk.fields.arith.carry_propagate`.
    """
    W = t.shape[-1]
    width = max(W, out_width if out_width is not None else W + 1)
    return _propagate(t, width)[0]


def cond_sub_p(ctx: FieldCtx, t: torch.Tensor) -> torch.Tensor:
    """If value >= p subtract p.  t: strict [..., W >= L] with value < 2p.
    Returns canonical [..., L]."""
    W = t.shape[-1]
    d, borrow = _propagate(t.to(torch.int64) - p_limbs(ctx, W, t.device), W)
    return torch.where((borrow < 0)[..., None], t[..., : ctx.L], d[..., : ctx.L]).to(torch.int32)


def _elementwise(kernel, ctx: FieldCtx, a: torch.Tensor, b: torch.Tensor, *args) -> torch.Tensor:
    """Apply a K1/K3 wrapper to [..., L] operands (broadcasting): a broadcast
    [L] ``b`` stays one element; any other broadcast is materialized."""
    if b.dim() == 1 and a.dim() > 1:
        return kernel(ctx, a.reshape(-1, ctx.L).contiguous(), b.contiguous(), *args).reshape(a.shape)
    a, b = torch.broadcast_tensors(a, b)
    flat_a = a.reshape(-1, ctx.L).contiguous()
    flat_b = b.reshape(-1, ctx.L).contiguous()
    return kernel(ctx, flat_a, flat_b, *args).reshape(a.shape)


def add(ctx: FieldCtx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Modular add of canonical elements [..., L] (broadcasting), through K3."""
    counters.bump(ctx.name, "add", a, b)
    return _elementwise(kernels.addsub, ctx, a, b, "add")


def sub(ctx: FieldCtx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Modular sub of canonical elements [..., L] (broadcasting), through K3."""
    counters.bump(ctx.name, "sub", a, b)
    return _elementwise(kernels.addsub, ctx, a, b, "sub")


def neg(ctx: FieldCtx, a: torch.Tensor) -> torch.Tensor:
    """p - a for a != 0, 0 for 0."""
    return sub(ctx, torch.zeros_like(a), a)


def is_zero(ctx: FieldCtx, a: torch.Tensor) -> torch.Tensor:
    """[..., L] canonical limbs -> bool [...]."""
    return (a == 0).all(dim=-1)


def eq(ctx: FieldCtx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Equality of canonical elements [..., L] (broadcasting) -> bool [...]."""
    return (a == b).all(dim=-1)


def mont_mul(ctx: FieldCtx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a*b*R^-1 mod p of canonical [..., L] (broadcasting).

    Goes through the K1 wrapper: the CUDA kernel for CUDA tensors, the plain
    CIOS for CPU tensors.
    """
    counters.bump(ctx.name, "mul", a, b)
    return _elementwise(kernels.mont_mul, ctx, a, b)


def mont_sqr(ctx: FieldCtx, a: torch.Tensor) -> torch.Tensor:
    return mont_mul(ctx, a, a)


def scalar_mul(ctx: FieldCtx, a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """a[..., L] * scalar s[L] (both Montgomery)."""
    return mont_mul(ctx, a, s)


def inv_host(ctx: FieldCtx, x: int) -> int:
    return pow(x, ctx.p - 2, ctx.p)


def pow_mont(ctx: FieldCtx, a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e elementwise (Montgomery in and out), by square and multiply from
    the exponent's low bit: one K1 square a bit, one K1 product a set bit."""
    result = ctx.one_mont(a.device).expand(a.shape).contiguous()
    base = a
    for i in range(e.bit_length()):
        if (e >> i) & 1:
            result = mont_mul(ctx, result, base)
        if i + 1 < e.bit_length():
            base = mont_sqr(ctx, base)
    return result


def inv_mont(ctx: FieldCtx, a: torch.Tensor) -> torch.Tensor:
    """Elementwise modular inverse by Fermat (zero maps to zero); a in
    Montgomery form."""
    return pow_mont(ctx, a, ctx.p - 2)


def redc_wide(ctx: FieldCtx, t: torch.Tensor) -> torch.Tensor:
    """Montgomery-reduce a strict wide value: returns value * R^-1 mod p.

    t: strict limbs [..., W] with L <= W and value < R*p.
    """
    L = ctx.L
    W = t.shape[-1]
    n = p_limbs(ctx, L, t.device)
    acc = torch.zeros(t.shape[:-1] + (W + L + 2,), dtype=torch.int64, device=t.device)
    acc[..., :W] = t
    for i in range(L):
        m = (acc[..., i] * ctx.n0inv) & MASK
        acc[..., i : i + L] += m[..., None] * n
        acc[..., i + 1] += acc[..., i] >> LIMB_BITS  # limb i is 0 mod B now
    # acc[L:] holds (t + M*p) / R < 2p
    strict = carry_propagate(acc[..., L:], W + 2)[..., : L + 1]
    return cond_sub_p(ctx, strict)


def to_mont(ctx: FieldCtx, a: torch.Tensor) -> torch.Tensor:
    return mont_mul(ctx, a, ctx.limbs(ctx.R2, a.device))


def from_mont(ctx: FieldCtx, a: torch.Tensor) -> torch.Tensor:
    # a * 1 * R^-1: the plain form, through the same K1 kernel
    return mont_mul(ctx, a, ctx.limbs(1, a.device))


def sum_mod(ctx: FieldCtx, a: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Exact modular sum along ``axis`` of canonical Montgomery elements.

    One int64 limb sum (exact for fewer than 2^47 terms), one carry pass,
    one wide Montgomery reduction and a scale back by R^2.  Modular addition
    is associative, so the result equals any other summation order's.
    """
    counters.bump(ctx.name, "add", a)
    if axis < 0:
        axis += a.dim()
    return reduce_lazy(ctx, a.sum(dim=axis, dtype=torch.int64))


def reduce_lazy(ctx: FieldCtx, lazy: torch.Tensor) -> torch.Tensor:
    """int64 limb sums [..., W <= L+2] of Montgomery elements (fewer than
    2^47 terms of strict limbs) -> their canonical Montgomery sums [..., L]:
    one carry pass and one wide reduction.  Integer sums add exactly, so
    partial sums from anywhere (a sharded table's shards) may be added
    before it."""
    return reduce_wide_to_mont(ctx, carry_propagate(lazy, ctx.L + 4))


def reduce_wide_to_mont(ctx: FieldCtx, wide: torch.Tensor) -> torch.Tensor:
    """Strict wide limbs [..., W] holding a sum of Montgomery residues
    (value < R*p) -> canonical Montgomery element [..., L]."""
    plain = redc_wide(ctx, wide)  # (sum)*R * R^-1 = sum, plain form
    return mont_mul(ctx, plain, ctx.limbs(ctx.R2, wide.device))


def mont_segment_sum(ctx: FieldCtx, vals: torch.Tensor, idx: torch.Tensor, size: int) -> torch.Tensor:
    """Sum Montgomery elements ``vals [G, ..., L]`` into ``size`` buckets by
    ``idx [G]`` -> ``[size, ..., L]`` canonical Montgomery (exact).

    One int64 ``index_add_`` of the limbs (exact below 2^47 values per bucket;
    integer atomics make it independent of order), then the carry and wide
    reduction of :func:`sum_mod`.
    """
    lazy = torch.zeros((size,) + vals.shape[1:], dtype=torch.int64, device=vals.device)
    lazy.index_add_(0, idx, vals.to(torch.int64))
    return reduce_lazy(ctx, lazy)


def lazy_to_ints(ctx: FieldCtx, lazy: torch.Tensor) -> list[int]:
    """int64 lazy limb sums [..., L] of Montgomery elements (any device) ->
    the canonical plain sums as host ints.

    One copy to the host; the carry and the reduction mod p run on Python
    ints.
    """
    rows = lazy.reshape(-1, lazy.shape[-1]).cpu().tolist()
    return [sum(v << (LIMB_BITS * k) for k, v in enumerate(row)) * ctx.Rinv % ctx.p for row in rows]


@functools.lru_cache(maxsize=None)
def _chunk_weights(ctx: FieldCtx, device: torch.device) -> torch.Tensor:
    """[3, 1, L] Montgomery constants 2^(16 j) R mod p, j = 0, 1, 2 (cached)."""
    vals = [(1 << (LIMB_BITS * j)) * ctx.R % ctx.p for j in range(3)]
    return torch.tensor([_limbs_of_int(v, ctx.L) for v in vals], dtype=torch.int32, device=device)[:, None]


def lazy_to_mont(ctx: FieldCtx, lazy: torch.Tensor) -> torch.Tensor:
    """int64 lazy limb sums [..., L] of Montgomery elements (each limb below
    2^48) -> their canonical Montgomery sums [..., L], on the device, with no
    carry pass.

    Each lazy limb splits into three 16-bit chunks, so the sum is
    A + 2^16 B + 2^32 C with A, B and C vectors of 16-bit limbs, each below
    R.  One Montgomery product by 2^(16 j) R mod p reduces each of them
    (valid for any first operand below R: one K1 launch over the three),
    and two K3 additions sum them: about ten launches, where
    :func:`reduce_wide_to_mont` after :func:`carry_propagate` takes a few
    hundred small ones.
    """
    chunks = torch.stack([(lazy >> (LIMB_BITS * j)) & MASK for j in range(3)]).to(torch.int32)
    parts = mont_mul(ctx, chunks, _chunk_weights(ctx, lazy.device).expand(chunks.shape))
    return add(ctx, add(ctx, parts[0], parts[1]), parts[2])
