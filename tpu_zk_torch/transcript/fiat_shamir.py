"""Fiat-Shamir transcript, bit-identical to :mod:`tpu_zk.transcript.fiat_shamir`.

* ``append`` incrementally updates a Keccak256 state.
* ``sample_random_challenge`` clones the hasher, finalizes the clone to get a
  32-byte digest, then absorbs that digest back into the live hasher.
* ``random_challenge_as_field_element`` reduces the 32 bytes **little-endian**
  mod the field order (``from_le_bytes_mod_order``).
"""

from __future__ import annotations

from ..fields.arith import FieldCtx
from .keccak import Keccak256


class Transcript:
    def __init__(self):
        self._hasher = Keccak256()

    def append(self, data: bytes) -> None:
        self._hasher.update(data)

    def sample_random_challenge(self) -> bytes:
        digest = self._hasher.copy().digest()
        self._hasher.update(digest)
        return digest

    def random_challenge_as_field_element(self, ctx: FieldCtx) -> int:
        """Returns the challenge as a canonical python int in [0, p)."""
        return ctx.from_le_bytes_mod_order(self.sample_random_challenge())

    # -- checkpoint/resume ----------------------------------------------------
    def snapshot(self) -> bytes:
        return self._hasher.snapshot()

    @classmethod
    def from_snapshot(cls, blob: bytes) -> "Transcript":
        t = cls.__new__(cls)
        t._hasher = Keccak256.from_snapshot(blob)
        return t
