"""Keccak-256 (the pre-NIST pad-0x01 variant used by ``sha3::Keccak256``).

:class:`Keccak256` is the incremental hasher of the Fiat-Shamir transcript,
with ``.copy()`` for the transcript's clone-finalize-reabsorb pattern.  Its
permutation is the host C++ sponge ``native/keccak.cpp``, which this package
builds itself (:func:`tpu_zk_torch._build.keccak_library`); a failed build
raises, since the basic-sumcheck transcript absorbs the whole table (512 MiB
at 2^24 BN254 Fr elements) and a numpy sponge would take far too long.

:func:`keccak256_batch` hashes many equal-length messages and
:func:`merkle_levels` builds every level of a Merkle tree, both in one call
to the same native library (threaded over the messages).

:func:`keccak256_plain` is the numpy sponge, kept as the plain reference the
tests hold the native library against.
"""

from __future__ import annotations

import numpy as np

from .. import _build

RATE = 136  # bytes; Keccak-256 rate (1088 bits)

_RC = np.array(
    [
        0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
        0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
        0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
        0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
        0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
        0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
    ],
    dtype=np.uint64,
)

# rotation offsets indexed [x][y] (lane l = x + 5*y)
_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]


def _rotl(x: np.ndarray, s: int) -> np.ndarray:
    s %= 64
    if s == 0:
        return x
    return (x << np.uint64(s)) | (x >> np.uint64(64 - s))


def keccak_f1600(state: np.ndarray) -> np.ndarray:
    """Keccak-f[1600] permutation on ``state[..., 25]`` uint64 lanes (numpy)."""
    A = [state[..., i] for i in range(25)]
    for rnd in range(24):
        C = [A[x] ^ A[x + 5] ^ A[x + 10] ^ A[x + 15] ^ A[x + 20] for x in range(5)]
        D = [C[(x - 1) % 5] ^ _rotl(C[(x + 1) % 5], 1) for x in range(5)]
        A = [A[i] ^ D[i % 5] for i in range(25)]
        B = [None] * 25
        for x in range(5):
            for y in range(5):
                B[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(A[x + 5 * y], _ROT[x][y])
        A = [B[i] ^ ((~B[(i % 5 + 1) % 5 + 5 * (i // 5)]) & B[(i % 5 + 2) % 5 + 5 * (i // 5)]) for i in range(25)]
        A[0] = A[0] ^ _RC[rnd]
    return np.stack(A, axis=-1)


def _pad(tail: bytes) -> bytes:
    """Final block: tail || 0x01 0x00.. 0x80 (one 0x81 byte when one is left)."""
    pad_len = RATE - len(tail)
    if pad_len == 1:
        return tail + b"\x81"
    return tail + b"\x01" + b"\x00" * (pad_len - 2) + b"\x80"


def keccak256_plain(data: bytes) -> bytes:
    """Keccak-256 with the numpy permutation (the plain reference)."""
    data = bytes(data)
    full = len(data) // RATE * RATE
    state = np.zeros(25, dtype=np.uint64)
    for block in [data[i : i + RATE] for i in range(0, full, RATE)] + [_pad(data[full:])]:
        state[: RATE // 8] ^= np.frombuffer(block, dtype="<u8")
        state = keccak_f1600(state)
    return state[:4].tobytes()


class Keccak256:
    """Incremental Keccak-256 with sha3-crate-compatible behavior."""

    def __init__(self):
        self._lib = _build.keccak_library()
        self._state = np.zeros(25, dtype=np.uint64)
        self._buf = b""  # unabsorbed tail, shorter than RATE

    def _absorb(self, blocks: np.ndarray) -> None:
        self._lib.keccak_absorb_blocks(self._state.ctypes.data, blocks.ctypes.data, len(blocks) // RATE)

    def update(self, data) -> "Keccak256":
        mv = memoryview(data).cast("B")
        if self._buf:
            take = min(RATE - len(self._buf), len(mv))
            self._buf += bytes(mv[:take])
            mv = mv[take:]
            if len(self._buf) < RATE:
                return self
            self._absorb(np.frombuffer(self._buf, np.uint8))
            self._buf = b""
        full = len(mv) // RATE * RATE
        if full:
            # absorbed straight from the caller's buffer: no copy of the bulk
            self._absorb(np.frombuffer(mv[:full], np.uint8))
        self._buf = bytes(mv[full:])
        return self

    def copy(self) -> "Keccak256":
        c = Keccak256.__new__(Keccak256)
        c._lib = self._lib
        c._state = self._state.copy()
        c._buf = self._buf
        return c

    # -- checkpoint/resume ----------------------------------------------------
    def snapshot(self) -> bytes:
        """The sponge's state as bytes: the 200-byte state (25 little-endian
        lanes), then the unabsorbed tail; the same blob as ``tpu_zk``'s."""
        return self._state.astype("<u8").tobytes() + self._buf

    @classmethod
    def from_snapshot(cls, blob: bytes) -> "Keccak256":
        k = cls()
        k._state = np.frombuffer(blob[:200], dtype="<u8").astype(np.uint64)
        k._buf = bytes(blob[200:])
        return k

    def digest(self) -> bytes:
        c = self.copy()
        c._absorb(np.frombuffer(_pad(c._buf), np.uint8))
        return c._state[:4].tobytes()  # 32 bytes, little-endian lanes


def keccak256(data: bytes) -> bytes:
    return Keccak256().update(data).digest()


def keccak256_batch(messages: np.ndarray) -> np.ndarray:
    """Hash N equal-length messages: [N, msg_len] uint8 -> [N, 32] uint8."""
    n, mlen = messages.shape
    msgs = np.ascontiguousarray(messages, dtype=np.uint8)
    out = np.empty((n, 32), np.uint8)
    if n:
        _build.keccak_library().keccak256_many(msgs.ctypes.data, n, mlen, out.ctypes.data)
    return out


def merkle_levels(leaves: np.ndarray) -> np.ndarray:
    """Every level of a binary Merkle tree in one native call.

    leaves: [N, leaf_len] uint8, N a power of two.  Returns [2N-1, 32] uint8:
    the N leaf digests, then the N/2 nodes above them, ..., then the root.
    """
    n, leaf_len = leaves.shape
    msgs = np.ascontiguousarray(leaves, dtype=np.uint8)
    out = np.empty((2 * n - 1, 32), np.uint8)
    _build.keccak_library().merkle_build(msgs.ctypes.data, n, leaf_len, out.ctypes.data)
    return out
