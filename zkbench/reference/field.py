"""Plain arithmetic modulo a prime p < 2^256, on torch tensors of any device.

An element is 16 limbs of 16 bits, least significant first, held in int64.
Tables are limb-major, ``[16, N]``, so that every limb operation reads one
contiguous row (any further axes are kept); a constant is ``[16, 1]`` and
broadcasts.  Every value a function returns is canonical (in [0, p)).

Products go through Montgomery's reduction with R = 2^256:
``mont(a, b) = a * b / R mod p``.  A multiplication by a known constant c
passes c * R mod p (:meth:`Field.const`), so that canonical tables stay
canonical: ``mont(a, const(c)) = a * c mod p``.

This module is the benchmark's own and imports nothing of the program under
test.
"""

from __future__ import annotations

import torch

L = 16
BITS = 16
MASK = (1 << BITS) - 1
HOST_BELOW = 1 << 10  # tables this small are finished with Python ints


def int_limbs(x: int) -> list[int]:
    return [(x >> (BITS * i)) & MASK for i in range(L)]


class Field:
    def __init__(self, p: int, device):
        if not 2 < p < 1 << (BITS * L):
            raise ValueError("the modulus must lie between 2 and 2^256")
        self.p = p
        self.R = 1 << (BITS * L)
        self.R2 = self.R * self.R % p
        self.pinv = (-pow(p, -1, 1 << BITS)) % (1 << BITS)
        self.device = torch.device(device)
        self.P = self.column(p)

    def _p(self, t: torch.Tensor) -> torch.Tensor:
        """p's limbs shaped to broadcast over a table of t's rank."""
        return self.P.view((L,) + (1,) * (t.dim() - 1))

    # -- conversions ------------------------------------------------------------
    def column(self, x: int) -> torch.Tensor:
        """The [16, 1] limbs of the integer x (not reduced)."""
        return torch.tensor(int_limbs(x), dtype=torch.int64, device=self.device)[:, None]

    def const(self, c: int) -> torch.Tensor:
        """The operand that multiplies a table by c: c R mod p."""
        return self.column(c % self.p * self.R % self.p)

    def table(self, values: list[int]) -> torch.Tensor:
        return torch.tensor([int_limbs(v % self.p) for v in values], dtype=torch.int64,
                            device=self.device).T.contiguous()

    def from_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """[N, 16] limb rows (any integer type) -> [16, N] int64 on this device."""
        return rows.to(self.device, torch.int64).T.contiguous()

    def ints(self, t: torch.Tensor) -> list[int]:
        """[16, N] -> N Python ints."""
        cols = t.T.cpu().tolist()
        return [sum(limb << (BITS * i) for i, limb in enumerate(col)) for col in cols]

    def from_montgomery(self, t: torch.Tensor) -> torch.Tensor:
        """u -> u / R mod p: the value whose Montgomery form the limbs u are."""
        return self.mont(t, self.column(1))

    # -- arithmetic ---------------------------------------------------------------
    def _carry(self, t: torch.Tensor) -> torch.Tensor:
        """Propagate signed lazy limbs in place; the top limb keeps the sign."""
        for j in range(t.shape[0] - 1):
            c = t[j] >> BITS  # arithmetic: floors negative limbs
            t[j] &= MASK
            t[j + 1] += c
        return t

    def _reduce_once(self, t: torch.Tensor) -> torch.Tensor:
        """[16 or 17, N] normalized limbs of a value in [0, 2p) -> [16, N] in [0, p)."""
        d = t.clone()
        d[:L] -= self._p(d)
        self._carry(d)
        keep = d[-1] < 0
        return torch.where(keep, t[:L], d[:L])

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        s = torch.zeros((L + 1,) + torch.broadcast_shapes(a.shape[1:], b.shape[1:]), dtype=torch.int64,
                        device=self.device)
        s[:L] = a + b
        return self._reduce_once(self._carry(s))

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        d = self._carry(a - b)
        neg = d[-1] < 0
        return torch.where(neg, self._carry(d + self._p(d)), d)

    def mont(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a * b / R mod p; either operand may be a [16, 1] constant."""
        shape = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
        acc = torch.zeros((2 * L + 1,) + shape, dtype=torch.int64, device=self.device)
        bb = b.expand((L,) + shape)
        for i in range(L):  # schoolbook: each limb gathers at most 16 products below 2^32
            acc[i:i + L].addcmul_(bb, a[i:i + 1])
        for i in range(L):  # one reduction step a limb: add m p so that limb i becomes 0 mod 2^16
            m = ((acc[i] & MASK) * self.pinv) & MASK
            acc[i:i + L].addcmul_(self._p(acc), m[None])
            acc[i + 1] += acc[i] >> BITS
        high = self._carry(acc[L:])  # (a b + M p) / R < 2p
        return self._reduce_once(high)

    def mul(self, a: torch.Tensor, c: int) -> torch.Tensor:
        """a * c mod p for a host integer c."""
        return self.mont(a, self.const(c))

    def sum(self, t: torch.Tensor) -> int:
        """The sum of a table's values mod p (exact int64 column sums)."""
        cols = t.sum(dim=1).tolist()
        return sum(c << (BITS * i) for i, c in enumerate(cols)) % self.p

    # -- multilinear tables (variable 0 is the most significant index bit) ---------
    def fold_first(self, t: torch.Tensor, r: int) -> torch.Tensor:
        """Fix variable 0 at r: lo + r (hi - lo) over the two halves."""
        half = t.shape[1] // 2
        lo, hi = t[:, :half], t[:, half:]
        return self.add(lo, self.mul(self.sub(hi, lo), r))

    def fold_last(self, t: torch.Tensor, r: int) -> torch.Tensor:
        """Fix the last variable at r: lo + r (hi - lo) over even and odd entries."""
        lo, hi = t[:, 0::2], t[:, 1::2]
        return self.add(lo, self.mul(self.sub(hi, lo), r))

    def evaluate(self, t: torch.Tensor, point: list[int]) -> int:
        """The table's multilinear extension at ``point`` (one value a variable)."""
        return self.partial_first(t, point)[0]

    def partial_first(self, t: torch.Tensor, point: list[int]) -> list[int]:
        """Fix the leading len(point) variables: the remaining table as ints."""
        for k, r in enumerate(point):
            if t.shape[1] <= HOST_BELOW:
                return _fold_ints(self.ints(t), point[k:], self.p)
            t = self.fold_first(t, r)
        return self.ints(t)


def _fold_ints(values: list[int], point: list[int], p: int) -> list[int]:
    for r in point:
        half = len(values) // 2
        values = [(lo + r * (hi - lo)) % p for lo, hi in zip(values[:half], values[half:])]
    return values
