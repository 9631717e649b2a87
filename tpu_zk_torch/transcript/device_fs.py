"""Device-resident Fiat-Shamir: a Keccak-256 sponge kept on the device.

Counterpart of :mod:`tpu_zk.transcript.device_fs`.  The sponge replicates
the ``sha3::Keccak256`` semantics of the host transcript
(:mod:`.fiat_shamir`): incremental absorb into a 136-byte rate buffer,
clone-finalize (pad 0x01 ... 0x80, or 0x81 when one byte is left) to
squeeze, then absorb of the 32-byte digest into the live sponge; challenges
reduce the digest little-endian mod p.  With the sponge on the device the
rounds of a fused prover (:mod:`tpu_zk_torch.sumcheck.fused`) chain with no
copy to the host: each round's transcript step is one K7 launch
(:func:`.kernels.sponge_round`, which also takes the round's elements out of
Montgomery form and packs their bytes).

Representation: ``state`` [25] int64 (each 64-bit lane's bits), ``buf``
[136] uint8 (the unabsorbed tail, zero from ``pos`` on) and ``pos`` [1] int32,
all three on the device.  ``tpu_zk`` has two forms, ``DeviceSponge`` with a
fill level fixed at trace time and ``absorb_dyn``/``squeeze_dyn`` with a
traced one; here the fill level always lives on the device, so one form
serves both.  Every operation updates the three tensors in place (torch's
arrays are not immutable, and a fused prove chains on one sponge); the
caller that needs the fill level on the host without a copy computes it
(:func:`tpu_zk_torch.sumcheck.fused.final_pos`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve
from ..fields import arith
from ..fields.arith import FieldCtx
from .keccak import RATE, Keccak256
from .kernels import digest_limbs, keccak_f1600_device, pack_bytes_be, pack_bytes_le, sponge_step

__all__ = ["DeviceSponge", "absorb_dyn", "squeeze_dyn", "digest_to_mont", "pack_bytes_be", "pack_bytes_le",
           "keccak_f1600_device"]


class DeviceSponge:
    """A Keccak-256 sponge on the device: ``state`` [25] int64, ``buf`` [136]
    uint8, ``pos`` [1] int32.  ``absorb``, ``squeeze`` and ``challenge_mont``
    update them in place and return the sponge, as ``tpu_zk``'s return the
    next one."""

    __slots__ = ("state", "buf", "pos")

    def __init__(self, state: torch.Tensor, buf: torch.Tensor, pos: torch.Tensor):
        self.state = state
        self.buf = buf
        self.pos = pos

    @classmethod
    def fresh(cls, device=None) -> "DeviceSponge":
        device = resolve(device)
        return cls(torch.zeros(25, dtype=torch.int64, device=device), torch.zeros(RATE, dtype=torch.uint8, device=device),
                   torch.zeros(1, dtype=torch.int32, device=device))

    @classmethod
    def from_host(cls, host_hasher: Keccak256, device=None) -> "DeviceSponge":
        """Seed from a host ``Keccak256`` (e.g. after absorbing the initial
        polynomial on the host, through the native Keccak)."""
        tail = np.frombuffer(host_hasher._buf, np.uint8)
        buf = np.zeros(RATE, np.uint8)
        buf[: len(tail)] = tail
        device = resolve(device)
        return cls(torch.from_numpy(np.asarray(host_hasher._state, np.uint64).view(np.int64).copy()).to(device),
                   torch.from_numpy(buf).to(device), torch.tensor([len(tail)], dtype=torch.int32, device=device))

    @staticmethod
    def to_host(state: torch.Tensor, buf: torch.Tensor, pos: int) -> Keccak256:
        """(state, buf) and the fill level known on the host -> a host
        ``Keccak256``, for continuing the transcript after a fused prove
        (one copy of 336 bytes)."""
        k = Keccak256()
        k._state = state.cpu().numpy().view(np.uint64).copy()
        k._buf = bytes(buf[:pos].cpu().numpy().tobytes())
        return k

    def absorb(self, data: torch.Tensor) -> "DeviceSponge":
        """Absorb ``data`` ([k] uint8 on the sponge's device, any k)."""
        sponge_step(self.state, self.buf, self.pos, data)
        return self

    def squeeze(self) -> tuple[torch.Tensor, "DeviceSponge"]:
        """Clone-finalize-reabsorb: ([32] uint8 digest, the sponge)."""
        digest = torch.empty(32, dtype=torch.uint8, device=self.state.device)
        sponge_step(self.state, self.buf, self.pos, _no_data(self.state.device), digest)
        return digest, self

    def challenge_mont(self, ctx: FieldCtx) -> tuple[torch.Tensor, "DeviceSponge"]:
        """Squeeze a field challenge: digest LE mod p, Montgomery [L]."""
        digest = torch.empty(32, dtype=torch.uint8, device=self.state.device)
        r = torch.empty(ctx.L, dtype=torch.int32, device=self.state.device)
        sponge_step(self.state, self.buf, self.pos, _no_data(self.state.device), digest, r, ctx)
        return r, self


def _no_data(device) -> torch.Tensor:
    return torch.empty(0, dtype=torch.uint8, device=device)


def absorb_dyn(state: torch.Tensor, buf: torch.Tensor, pos: torch.Tensor, data: torch.Tensor):
    """Absorb ``data`` ([k] uint8, any k) at the device fill level, in place;
    returns (state, buf, pos)."""
    sponge_step(state, buf, pos, data)
    return state, buf, pos


def squeeze_dyn(state: torch.Tensor, buf: torch.Tensor, pos: torch.Tensor):
    """Clone-finalize-reabsorb at the device fill level, in place: returns
    ([32] uint8 digest, state, buf, pos)."""
    digest = torch.empty(32, dtype=torch.uint8, device=state.device)
    sponge_step(state, buf, pos, _no_data(state.device), digest)
    return digest, state, buf, pos


def digest_to_mont(ctx: FieldCtx, digest: torch.Tensor) -> torch.Tensor:
    """[32] uint8 little-endian digest -> Montgomery [L] limbs of digest mod p.

    The raw digest (< 2^256 = R for the 256-bit-limb fields) is the first
    operand of one Montgomery product by R^2: (digest mod p) R, valid for any
    digest below R (K1 on the card, its plain version on the CPU).  A field
    whose limbs do not span 256 bits (BLS12-381 Fq) raises.
    """
    return arith.mont_mul(ctx, digest_limbs(ctx, digest), ctx.limbs(ctx.R2, digest.device))
