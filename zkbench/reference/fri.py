"""The reference FRI prover: the low-degree extension of a polynomial by a
plain radix-2 NTT, Keccak-256 Merkle commitments, the commit-fold rounds
and the queries, with the Fiat-Shamir transcript of ``tpu_zk``'s FRI:

* a leaf is a value's 32 big-endian bytes, a node the 64 bytes of its
  children's digests; a round absorbs its root and squeezes beta
  (little-endian bytes mod p);
* a fold is f'(x^2) = (f(x) + f(-x))/2 + beta (f(x) - f(-x)) / (2x) over the
  first half of the domain, until ``2^final_log2`` values remain, which are
  absorbed big-endian;
* each query index is a little-endian 32-bit word of a squeeze, mod half
  the first domain; round r opens (i, i + half_r) for i = index mod half_r,
  with each value's Merkle path, leaf level first.

:func:`prove` returns the proof as plain data; :func:`compare` counts the
elements of another proof that differ from it.
"""

from __future__ import annotations

import torch

from .field import L, Field
from .gkr import Tally, be
from .keccak import Sponge, hash_blocks, lanes_to_bytes

CHUNK = 1 << 22  # leaves hashed at once


def root_of_unity(p: int, k: int) -> int:
    """The exact 2^k-th root of unity g^((p-1)/2^k) of the smallest base g >= 2."""
    for g in range(2, 1000):
        w = pow(g, (p - 1) >> k, p)
        if pow(w, 1 << k, p) == 1 and (k == 0 or pow(w, 1 << (k - 1), p) != 1):
            return w
    raise ValueError(f"no root of unity of order 2^{k}")


def powers(F: Field, w: int, n: int) -> torch.Tensor:
    """[16, n] operands that multiply by w^0 .. w^(n-1) (each times R), n a power of two."""
    t = F.table([1])
    step = w
    while t.shape[1] < n:
        t = torch.cat([t, F.mul(t, step)], dim=1)
        step = step * step % F.p
    return F.mont(t, F.column(F.R2))


def bit_reverse(n_log2: int, device) -> torch.Tensor:
    idx = torch.arange(1 << n_log2, device=device)
    rev = torch.zeros_like(idx)
    for b in range(n_log2):
        rev |= ((idx >> b) & 1) << (n_log2 - 1 - b)
    return rev


def ntt(F: Field, coeffs: torch.Tensor, w: int) -> torch.Tensor:
    """[16, N] coefficients -> the values at w^0 .. w^(N-1) (w of order N)."""
    N = coeffs.shape[1]
    k = N.bit_length() - 1
    x = coeffs[:, bit_reverse(k, coeffs.device)]
    tw = powers(F, w, max(N // 2, 1))
    for s in range(1, k + 1):
        m = 1 << s
        x = x.view(L, N // m, 2, m // 2)
        u, v = x[:, :, 0], F.mont(x[:, :, 1], tw[:, None, :: N // m])
        x = torch.stack([F.add(u, v), F.sub(u, v)], dim=2).reshape(L, N)
    return x


def leaf_lanes(values: torch.Tensor) -> list[torch.Tensor]:
    """[16, n] canonical values -> the 4 little-endian lanes of their 32 big-endian bytes."""
    lanes = []
    for t in range(4):
        lane = torch.zeros(values.shape[1], dtype=torch.int64, device=values.device)
        for u in range(8):
            s = 31 - 8 * t - u  # significance of big-endian byte 8t + u
            byte = (values[s // 2] >> (8 * (s % 2))) & 0xFF
            lane |= byte << (8 * u)
        lanes.append(lane)
    return lanes


def merkle_levels(values: torch.Tensor) -> list[torch.Tensor]:
    """Digest lanes of every level, [4, n] .. [4, 1] (the root last)."""
    n = values.shape[1]
    levels = [torch.cat([hash_blocks(leaf_lanes(values[:, i:i + CHUNK]), 32) for i in range(0, n, CHUNK)], dim=1)]
    while levels[-1].shape[1] > 1:
        d = levels[-1]
        levels.append(torch.cat([hash_blocks([d[j, i:i + 2 * CHUNK:2] for j in range(4)]
                                             + [d[j, i + 1:i + 2 * CHUNK:2] for j in range(4)], 64)
                                 for i in range(0, d.shape[1], 2 * CHUNK)], dim=1))
    return levels


def prove(F: Field, coeffs: torch.Tensor, domain_log2: int, final_log2: int, num_queries: int) -> dict:
    """The FRI proof of the polynomial with canonical coefficients ``coeffs``
    ([16, n], n <= 2^domain_log2) over the domain of size 2^domain_log2."""
    p, N = F.p, 1 << domain_log2
    w = root_of_unity(p, domain_log2)
    padded = torch.zeros((L, N), dtype=torch.int64, device=coeffs.device)
    padded[:, :coeffs.shape[1]] = coeffs
    codeword = ntt(F, padded, w)
    inv_x = powers(F, pow(w, p - 2, p), N // 2)
    inv2 = pow(2, p - 2, p)

    tr = Sponge()
    codewords, trees, roots = [], [], []
    for r in range(domain_log2 - final_log2):
        levels = merkle_levels(codeword)
        root = lanes_to_bytes(levels[-1])[0]
        tr.update(root)
        beta = int.from_bytes(tr.challenge(), "little") % p
        codewords.append(codeword)
        trees.append(levels)
        roots.append(root)
        half = codeword.shape[1] // 2
        a, b = codeword[:, :half], codeword[:, half:]
        even = F.mul(F.add(a, b), inv2)
        odd = F.mont(F.mul(F.sub(a, b), inv2), inv_x[:, :: 1 << r])
        codeword = F.add(even, F.mul(odd, beta))
    final = F.ints(codeword)
    for v in final:
        tr.update(be(v))

    indices: list[int] = []
    while len(indices) < num_queries:
        digest = tr.challenge()
        for off in range(0, 32, 4):
            if len(indices) < num_queries:
                indices.append(int.from_bytes(digest[off:off + 4], "little") % (N // 2))

    opened = []  # a round: the 2q opened values and their paths, leaf level first
    for cw, levels in zip(codewords, trees):
        half = cw.shape[1] // 2
        pos = [i for idx in indices for i in (idx % half, idx % half + half)]
        values = F.ints(cw[:, pos])
        at = torch.tensor(pos, device=cw.device)
        sibs = torch.stack([levels[lvl][:, (at >> lvl) ^ 1] for lvl in range(len(levels) - 1)], dim=2).cpu()
        paths = [lanes_to_bytes(sibs[:, j]) for j in range(len(pos))]
        opened.append((values, paths))
    queries = [[(indices[q] % (cw.shape[1] // 2), values[2 * q], values[2 * q + 1], paths[2 * q], paths[2 * q + 1])
                for cw, (values, paths) in zip(codewords, opened)] for q in range(num_queries)]
    return {"roots": roots, "final": final, "queries": queries}


def compare(got: dict, want: dict) -> Tally:
    """Count the elements of ``got`` that differ from the reference's ``want``."""
    t = Tally()
    t.expect(len(got["roots"]) == len(want["roots"]), "number of roots")
    for r, (a, b) in enumerate(zip(got["roots"], want["roots"])):
        t.expect(a == b, f"root {r}")
    t.expect(got["final"] == want["final"], "final codeword")
    t.expect(len(got["queries"]) == len(want["queries"]), "number of queries")
    for q, (ga, wa) in enumerate(zip(got["queries"], want["queries"])):
        t.expect(len(ga) == len(wa), f"query {q}: rounds")
        for r, (a, b) in enumerate(zip(ga, wa)):
            for name, x, y in zip(("index", "value lo", "value hi", "path lo", "path hi"), a, b):
                t.expect(x == y, f"query {q} round {r}: {name}")
    return t
