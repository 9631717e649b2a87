"""The device sponge kernel (K7): its two wrappers and their plain versions.

K7 ``sponge_step`` (the byte form): one step of a Keccak-256 sponge kept on
the device as ``state`` [25] int64 (the 64-bit lanes' bits), ``buf`` [136]
uint8 (the unabsorbed tail, zero from ``pos`` on) and ``pos`` [1] int32.  It absorbs
``data`` [k] uint8 at ``pos``, permuting every full block, and with a
``digest`` [32] uint8 output it squeezes as ``sha3::Keccak256`` does in the
reference transcript: it pads a clone, permutes it, writes the digest and
absorbs the digest into the live sponge.  With a ``challenge`` [L] int32
output too it writes ``digest mod p`` in Montgomery form.  ``state``, ``buf``
and ``pos`` are updated in place, so the rounds of a fused prover chain on
the device with no copy to the host.

K7 ``sponge_round`` (the round form): a fused prover round's transcript step
in one launch.  It takes the round's ``w`` Montgomery elements ``mont``
[w, 16], writes their plain form to ``slot`` [w, 16], packs them into 32 w
bytes (big-endian elements, :func:`pack_bytes_be`, for the basic sumcheck's
rounds; little-endian, :func:`pack_bytes_le`, for the GKR rounds), absorbs
them and squeezes into ``digest`` and ``challenge``: ``from_mont`` (K1),
the pack and ``sponge_step`` in one kernel.

It is the counterpart of ``tpu_zk/transcript/device_fs.py``'s sponge
(``keccak_f1600_device`` :79, ``absorb_dyn`` :314, ``squeeze_dyn`` :341,
``digest_to_mont`` :356), which ``tpu_zk`` runs as plain jnp inside its
fused provers; a sponge of torch ops on the card would cost thousands of
launches a permutation, so on the card it is one kernel
(``csrc/sponge.cu``).

The plain version holds each lane as (lo, hi) 32-bit halves in an int64
``[25, 2]`` tensor and runs ``tpu_zk``'s whole-state permutation: about
fifteen torch ops a round, by constant index gathers (torch on the CPU has no
uint32 or uint64 arithmetic, and its ``>>`` on int64 is arithmetic, so every
half stays in [0, 2^32): left shifts are masked and NOT is an XOR with
2^32 - 1).

Each wrapper runs its plain version when its tensors lie on the CPU, and
for CUDA tensors launches the kernel (built by :mod:`tpu_zk_torch._build` at
first use) or raises.  Each keeps a count of its kernel launches in its
``launches`` attribute.  A fused prove launches one a round, so the
wrappers check their tensors with attribute reads only and hand the kernel
plain integers (ctypes converts them by the argument types ``_build``
sets).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from ..fields import kernels as field_kernels
from ..fields.arith import FieldCtx
from ..fields.kernels import _device_index, _launch, _launch_args, _ptr, _raise_on
from ..utils import counters
from .keccak import _RC, _ROT, RATE

_M32 = 0xFFFFFFFF
_RC_HALVES = [(int(rc) & _M32, int(rc) >> 32) for rc in _RC]

# rho + pi: out lane j is lane _PI_SRC[j] rotated left by _PI_ROT[j]; chi pairs
# lane (x, y) with ((x + 1) % 5, y) and ((x + 2) % 5, y)
_PI_SRC = [0] * 25
_PI_ROT = [0] * 25
for _x in range(5):
    for _y in range(5):
        _PI_SRC[_y + 5 * ((2 * _x + 3 * _y) % 5)] = _x + 5 * _y
        _PI_ROT[_y + 5 * ((2 * _x + 3 * _y) % 5)] = _ROT[_x][_y]
_CHI_1 = [((x + 1) % 5) + 5 * y for y in range(5) for x in range(5)]
_CHI_2 = [((x + 2) % 5) + 5 * y for y in range(5) for x in range(5)]


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> dict:
    """The permutation's index and shift tables on ``device`` (cached)."""
    rot = torch.tensor(_PI_ROT, dtype=torch.int64, device=device)
    return {
        "src": torch.tensor(_PI_SRC, device=device),
        "swap": (rot >= 32)[:, None],  # a rotation by 32 or more swaps the halves first
        "shift": (rot % 32)[:, None],
        "chi1": torch.tensor(_CHI_1, device=device),
        "chi2": torch.tensor(_CHI_2, device=device),
        "rc": torch.tensor(_RC_HALVES, dtype=torch.int64, device=device),
    }


def _rotl_halves(x: torch.Tensor, swap: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Rotate the 64-bit lanes of x [..., n, 2] left by 32 * swap + shift
    (shift < 32; a shift of 0 moves nothing across, since x >> 32 is 0)."""
    x = torch.where(swap, x.flip(-1), x)
    return ((x << shift) & _M32) | (x.flip(-1) >> (32 - shift))


def keccak_f1600_device(A: torch.Tensor) -> torch.Tensor:
    """Keccak-f[1600] on a [..., 25, 2] int64 tensor of (lo, hi) halves,
    lane x + 5y at row x + 5y: the whole-state form of
    ``tpu_zk/transcript/device_fs.py:79 keccak_f1600_device``."""
    t = _tables(A.device)
    for i in range(24):
        grid = A.unflatten(-2, (5, 5))  # [..., y, x, 2]
        C = grid[..., 0, :, :] ^ grid[..., 1, :, :] ^ grid[..., 2, :, :] ^ grid[..., 3, :, :] ^ grid[..., 4, :, :]
        right = C.roll(-1, -2)
        D = C.roll(1, -2) ^ ((right << 1) & _M32) ^ (right.flip(-1) >> 31)  # C[x-1] ^ rotl(C[x+1], 1)
        B = _rotl_halves((grid ^ D[..., None, :, :]).flatten(-3, -2)[..., t["src"], :], t["swap"], t["shift"])
        A = B ^ ((B[..., t["chi1"], :] ^ _M32) & B[..., t["chi2"], :])
        A[..., 0, :] ^= t["rc"][i]
    return A


def _halves(state: torch.Tensor) -> torch.Tensor:
    """[25] int64 lane bits -> [25, 2] (lo, hi) halves in [0, 2^32)."""
    return torch.stack([state & _M32, (state >> 32) & _M32], dim=-1)


def _lanes(halves: torch.Tensor) -> torch.Tensor:
    """[25, 2] halves -> [25] int64 lane bits (the top half wraps into the sign)."""
    return halves[..., 0] | (halves[..., 1] << 32)


def _pack(block: torch.Tensor) -> torch.Tensor:
    """[136] byte values -> [17, 2] halves, little-endian within each half."""
    b = block.to(torch.int64).view(RATE // 8, 2, 4)
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)


def _to_bytes(halves: torch.Tensor) -> torch.Tensor:
    """[k, 2] halves -> [8k] uint8, little-endian."""
    return torch.stack([(halves >> s) & 0xFF for s in (0, 8, 16, 24)], dim=-1).reshape(-1).to(torch.uint8)


def _absorb_plain(A: torch.Tensor, tail: torch.Tensor, data: torch.Tensor):
    """(halves, tail bytes) after absorbing data: one permutation a full block."""
    stream = torch.cat([tail, data])
    full = stream.shape[0] // RATE
    for b in range(full):
        A = A.clone()
        A[: RATE // 8] ^= _pack(stream[b * RATE : (b + 1) * RATE])
        A = keccak_f1600_device(A)
    return A, stream[full * RATE :]


def _check_digest_field(ctx: FieldCtx) -> None:
    if ctx.L * 16 != 256:
        raise ValueError(f"{ctx.name}: a 32-byte digest is not reduced to {ctx.L} limbs (needs L * 16 = 256)")


def digest_limbs(ctx: FieldCtx, digest: torch.Tensor) -> torch.Tensor:
    """[32] uint8 little-endian digest -> its [L] 16-bit limbs (a value below
    2^256 = R, not reduced mod p); a field whose limbs do not span 256 bits
    raises."""
    _check_digest_field(ctx)
    b = digest.to(torch.int32).view(ctx.L, 2)
    return b[:, 0] | (b[:, 1] << 8)


def digest_to_mont_plain(ctx: FieldCtx, digest: torch.Tensor) -> torch.Tensor:
    """[32] uint8 little-endian digest -> [L] Montgomery limbs of digest mod p:
    its limbs times R^2, one CIOS product (valid for any first operand below
    R; see ``mont_mul_plain``)."""
    return field_kernels.mont_mul_plain(ctx, digest_limbs(ctx, digest), ctx.limbs(ctx.R2, digest.device))


def sponge_step_plain(state, buf, pos, data, digest=None, challenge=None, ctx: FieldCtx | None = None) -> None:
    """K7's function on tensors of any device, in place (see the module
    docstring); reads ``pos`` on the host."""
    p = int(pos[0])
    A, tail = _absorb_plain(_halves(state), buf[:p], data)
    if digest is not None:
        padded = torch.zeros(RATE, dtype=torch.int64, device=buf.device)
        padded[: tail.shape[0]] = tail
        padded[tail.shape[0]] ^= 0x01
        padded[RATE - 1] ^= 0x80
        clone = A.clone()
        clone[: RATE // 8] ^= _pack(padded)
        out = _to_bytes(keccak_f1600_device(clone)[:4])
        digest.copy_(out)
        if challenge is not None:
            challenge.copy_(digest_to_mont_plain(ctx, out))
        A, tail = _absorb_plain(A, tail, out)
    state.copy_(_lanes(A))
    buf.zero_()
    buf[: tail.shape[0]] = tail
    pos.fill_(tail.shape[0])


def pack_bytes_be(ctx: FieldCtx, plain: torch.Tensor) -> torch.Tensor:
    """[..., L] strict plain limbs -> [... * nbytes] uint8 big-endian byte
    stream (arkworks ``to_bytes_be``, the basic round and the claims)."""
    if ctx.L * 2 != ctx.nbytes:
        raise ValueError(f"{ctx.name}: {ctx.L} limbs do not serialize to {ctx.nbytes} bytes")
    rev = plain.flip(-1)
    return torch.stack([(rev >> 8) & 0xFF, rev & 0xFF], dim=-1).reshape(-1).to(torch.uint8)


def pack_bytes_le(ctx: FieldCtx, plain: torch.Tensor) -> torch.Tensor:
    """[..., L] strict plain limbs -> [... * nbytes] uint8 little-endian byte
    stream (the GKR round univariates, ``sumcheck_gkr_protocol.rs:145-150``)."""
    if ctx.L * 2 != ctx.nbytes:
        raise ValueError(f"{ctx.name}: {ctx.L} limbs do not serialize to {ctx.nbytes} bytes")
    return torch.stack([plain & 0xFF, (plain >> 8) & 0xFF], dim=-1).reshape(-1).to(torch.uint8)


def sponge_round_plain(state, buf, pos, mont, slot, digest, challenge, ctx: FieldCtx, big_endian: bool) -> None:
    """K7's round form on tensors of any device, in place: ``from_mont``'s
    product by 1 (K1's plain version) into ``slot``, the byte pack, then
    :func:`sponge_step_plain`."""
    slot.copy_(field_kernels.mont_mul_plain(ctx, mont, ctx.limbs(1, mont.device)))
    data = (pack_bytes_be if big_endian else pack_bytes_le)(ctx, slot)
    sponge_step_plain(state, buf, pos, data, digest, challenge, ctx)


ROUND_MAX_ELEMENTS = 128  # csrc/sponge.cu stages a round's 32-byte elements in one 4096-byte chunk


def _is(t: torch.Tensor, dtype: torch.dtype, shape: tuple) -> bool:
    return t.dtype == dtype and t.shape == shape and t.is_contiguous()


def _bad(what: str, msg: str, *tensors) -> ValueError:
    shapes = ", ".join(f"{t.dtype} {tuple(t.shape)}{'' if t.is_contiguous() else ' strided'}" for t in tensors)
    return ValueError(f"{what}: {msg}; got {shapes}")


def _check_sponge(what: str, state, buf, pos) -> None:
    if not (_is(state, torch.int64, (25,)) and _is(buf, torch.uint8, (RATE,)) and _is(pos, torch.int32, (1,))):
        raise _bad(what, f"state, buf and pos must be contiguous (25,) int64, ({RATE},) uint8 and (1,) int32",
                   state, buf, pos)


@functools.lru_cache(maxsize=None)
def _field_args(ctx: FieldCtx):
    """The challenge's field as K7 takes it (made once a field: a round's
    launch is a few microseconds): 32-bit modulus limbs, -p^{-1} mod 2^32
    and R^2 mod p as 8 32-bit limbs."""
    p32, n0inv = _launch_args(ctx)
    return p32, n0inv, (ctypes.c_uint32 * 8)(*[(ctx.R2 >> (32 * i)) & _M32 for i in range(8)])


def sponge_step(state: torch.Tensor, buf: torch.Tensor, pos: torch.Tensor, data: torch.Tensor,
                digest: torch.Tensor | None = None, challenge: torch.Tensor | None = None,
                ctx: FieldCtx | None = None) -> None:
    """K7, the byte form: absorb ``data`` into the sponge (state, buf, pos),
    and squeeze into ``digest`` (and ``challenge``, Montgomery limbs of
    ``ctx``) when given; everything in place.  ``buf`` must be zero from
    ``pos`` on, as every sponge made by :mod:`.device_fs` is."""
    what = "sponge_step"
    _check_sponge(what, state, buf, pos)
    if not (data.dtype == torch.uint8 and data.dim() == 1 and data.is_contiguous()):
        raise _bad(what, "data must be contiguous [k] uint8", data)
    tensors = (state, buf, pos, data)
    if digest is not None:
        if not _is(digest, torch.uint8, (32,)):
            raise _bad(what, "digest must be a contiguous [32] uint8 tensor", digest)
        tensors += (digest,)
    if challenge is not None:
        if digest is None or ctx is None:
            raise ValueError(f"{what}: a challenge needs a digest and a field")
        _check_digest_field(ctx)
        if not _is(challenge, torch.int32, (ctx.L,)):
            raise _bad(what, f"challenge must be a contiguous [{ctx.L}] int32 tensor", challenge)
        tensors += (challenge,)
    index = _device_index(*tensors)
    if index < 0:
        sponge_step_plain(state, buf, pos, data, digest, challenge, ctx)
        return
    p32, n0inv, r2 = _field_args(ctx) if challenge is not None else (None, 0, None)
    rc = _launch(_build.kernel_library().tzk_sponge_step, index, _ptr(state, 8), _ptr(buf, 8), pos.data_ptr(),
                 data.data_ptr(), data.shape[0], None if digest is None else digest.data_ptr(),
                 None if challenge is None else _ptr(challenge), 0 if ctx is None else ctx.L, p32, n0inv, r2)
    _raise_on(rc, what)
    sponge_step.launches += 1


sponge_step.launches = 0


def sponge_round(state: torch.Tensor, buf: torch.Tensor, pos: torch.Tensor, mont: torch.Tensor,
                 slot: torch.Tensor, digest: torch.Tensor, challenge: torch.Tensor, ctx: FieldCtx,
                 big_endian: bool) -> None:
    """K7, the round form: a round's ``w`` Montgomery elements ``mont``
    [w, 16] -> their plain limbs in ``slot`` [w, 16], absorbed as 32 w bytes
    (big- or little-endian elements) into the sponge (state, buf, pos), then
    squeezed into ``digest`` [32] uint8 and ``challenge`` [16] (Montgomery);
    everything in place.  Fields of 16 limbs only.  Counts ``from_mont``'s w
    products in :mod:`tpu_zk_torch.utils.counters`, as ``arith.from_mont``
    would."""
    what = "sponge_round"
    _check_sponge(what, state, buf, pos)
    _check_digest_field(ctx)
    L = ctx.L
    w = mont.shape[0] if mont.dim() == 2 else 0
    if not (1 <= w <= ROUND_MAX_ELEMENTS and _is(mont, torch.int32, (w, L)) and _is(slot, torch.int32, (w, L))
            and _is(digest, torch.uint8, (32,)) and _is(challenge, torch.int32, (L,))):
        raise _bad(what, f"mont and slot must be contiguous [w, {L}] int32 with 1 <= w <= {ROUND_MAX_ELEMENTS}, "
                   f"digest [32] uint8 and challenge [{L}] int32", mont, slot, digest, challenge)
    index = _device_index(state, buf, pos, mont, slot, digest, challenge)
    counters.bump(ctx.name, "mul", mont)
    if index < 0:
        sponge_round_plain(state, buf, pos, mont, slot, digest, challenge, ctx, big_endian)
        return
    p32, n0inv, r2 = _field_args(ctx)
    rc = _launch(_build.kernel_library().tzk_sponge_round, index, _ptr(state, 8), _ptr(buf, 8), pos.data_ptr(),
                 _ptr(mont), w, int(big_endian), _ptr(slot), digest.data_ptr(), _ptr(challenge), p32, n0inv, r2)
    _raise_on(rc, what)
    sponge_round.launches += 1


sponge_round.launches = 0
