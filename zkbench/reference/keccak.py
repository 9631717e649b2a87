"""Keccak-256 (the original padding, 0x01 ... 0x80), written for the reference.

:class:`Sponge` is the Fiat-Shamir transcript: bytes absorbed as they come,
a challenge is the digest of a copy, and that digest is absorbed again.
:func:`hash_blocks` hashes many one-block messages at once on torch int64
lanes (Merkle leaves and nodes).  Nothing here comes from the program under
test.
"""

from __future__ import annotations

import torch

RATE = 136
M64 = (1 << 64) - 1
RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000, 0x000000000000808B,
    0x0000000080000001, 0x8000000080008081, 0x8000000000008009, 0x000000000000008A, 0x0000000000000088,
    0x0000000080008009, 0x000000008000000A, 0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
# rotation of lane x + 5 y, and where pi sends it
ROT = [0, 1, 62, 28, 27, 36, 44, 6, 55, 20, 3, 10, 43, 25, 39, 41, 45, 15, 21, 8, 18, 2, 61, 56, 14]
PI_SRC = [0] * 25
for _x in range(5):
    for _y in range(5):
        PI_SRC[_y + 5 * ((2 * _x + 3 * _y) % 5)] = _x + 5 * _y


def _rotl(v: int, s: int) -> int:
    return ((v << s) | (v >> (64 - s))) & M64 if s else v


def permute(a: list[int]) -> list[int]:
    """Keccak-f[1600] on 25 lanes (Python ints)."""
    for rc in RC:
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        a = [a[i] ^ d[i % 5] for i in range(25)]
        b = [_rotl(a[PI_SRC[i]], ROT[PI_SRC[i]]) for i in range(25)]
        a = [b[i] ^ (~b[(i % 5 + 1) % 5 + 5 * (i // 5)] & b[(i % 5 + 2) % 5 + 5 * (i // 5)]) for i in range(25)]
        a[0] ^= rc
    return a


class Sponge:
    def __init__(self):
        self.lanes = [0] * 25
        self.buf = b""

    def update(self, data: bytes) -> None:
        self.buf += data
        while len(self.buf) >= RATE:
            self._absorb(self.buf[:RATE])
            self.buf = self.buf[RATE:]

    def _absorb(self, block: bytes) -> None:
        for i in range(RATE // 8):
            self.lanes[i] ^= int.from_bytes(block[8 * i:8 * i + 8], "little")
        self.lanes = permute(self.lanes)

    def digest(self) -> bytes:
        block = bytearray(self.buf + bytes(RATE - len(self.buf)))
        block[len(self.buf)] ^= 0x01
        block[RATE - 1] ^= 0x80
        lanes = list(self.lanes)
        for i in range(RATE // 8):
            lanes[i] ^= int.from_bytes(block[8 * i:8 * i + 8], "little")
        lanes = permute(lanes)
        return b"".join(v.to_bytes(8, "little") for v in lanes[:4])

    def challenge(self) -> bytes:
        """The transcript's squeeze: the digest so far, then absorbed."""
        d = self.digest()
        self.update(d)
        return d


def keccak256(data: bytes) -> bytes:
    s = Sponge()
    s.update(data)
    return s.digest()


# -- many one-block messages on torch int64 lanes ---------------------------------

def _signed(v: int) -> int:
    return v - (1 << 64) if v >> 63 else v


def hash_blocks(lanes: list[torch.Tensor], nbytes: int) -> torch.Tensor:
    """Keccak-256 of N messages of ``nbytes`` < 136 bytes each, given as their
    little-endian 64-bit lanes (``ceil(nbytes / 8)`` tensors of N int64, the
    last one holding zeros past the message) -> [4, N] digest lanes.

    The state is one [5 (y), 5 (x), N] tensor, so that a round is a few
    whole-state operations."""
    n, device = lanes[0].shape[0], lanes[0].device
    a = torch.zeros((25, n), dtype=torch.int64, device=device)
    a[:len(lanes)] = torch.stack(lanes)
    a[nbytes // 8] ^= 0x01 << (8 * (nbytes % 8))
    a[RATE // 8 - 1] ^= _signed(0x80 << 56)
    a = a.view(5, 5, n)
    rot = torch.tensor(ROT, dtype=torch.int64, device=device).view(5, 5, 1)
    low = (1 << rot) - 1
    src = torch.tensor(PI_SRC, device=device)
    rcs = [_signed(rc) for rc in RC]
    for rc in rcs:
        c = a[0] ^ a[1] ^ a[2] ^ a[3] ^ a[4]
        c1 = c.roll(-1, dims=0)
        a = a ^ (c.roll(1, dims=0) ^ ((c1 << 1) | ((c1 >> 63) & 1)))[None]
        a = (a << rot) | ((a >> (64 - rot)) & low)  # rho; lane 0 rotates by 0 and its mask is 0
        b = a.view(25, n)[src].view(5, 5, n)  # pi
        a = b ^ (~b.roll(-1, dims=1) & b.roll(-2, dims=1))  # chi
        a[0, 0] ^= rc
    return a.view(25, n)[:4]


def lanes_to_bytes(d: torch.Tensor) -> list[bytes]:
    """[4, N] digest lanes -> N 32-byte digests."""
    return [b"".join((v & M64).to_bytes(8, "little") for v in col) for col in d.T.cpu().tolist()]
