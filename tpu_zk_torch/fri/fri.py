"""FRI low-degree test with Merkle commitments and Fiat-Shamir queries;
proofs equal to :mod:`tpu_zk.fri.fri`'s, field for field.

Protocol (commit-fold): the prover holds evaluations of f over the
multiplicative group <w> of size N.  Each round: Merkle-commit the codeword,
absorb the root, squeeze beta, and fold

    f'(x^2) = (f(x) + f(-x))/2 + beta * (f(x) - f(-x)) / (2x)

halving the domain, until ``final_size``; the last codeword is sent in clear.
Query phase: indices drawn from the transcript; per round the prover opens
(i, i + N/2) with Merkle paths and the verifier recomputes the fold chain.

On the card: the leaf bytes (``from_mont`` through K1), every Merkle level
(K5), the fold (K1, K3) and the query phase's gathers.  The transcript stays
on the host: each round copies its 32-byte root back, absorbs it and
uploads beta, as the port's GKR prover does.  That gives the betas of
``tpu_zk``'s device sponge (``transcript/device_fs.py``), which exists to
avoid TPU round trips and is not ported.  The query phase gathers every
opened value and sibling on the card and copies them back at once.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..fields import arith
from ..fields.arith import FieldCtx, field_ctx
from ..merkle.device_merkle import field_leaf_bytes, merkle_tree_flat
from ..merkle.merkle import verify_path
from ..ntt.ntt import _twiddle_table, find_root_of_unity
from ..transcript.fiat_shamir import Transcript


def fold_codeword(ctx: FieldCtx, codeword: torch.Tensor, beta: torch.Tensor, inv_x: torch.Tensor,
                  inv2: torch.Tensor) -> torch.Tensor:
    """[N, L] -> [N/2, L]: one FRI fold at challenge beta (K1, K3).

    inv_x: [N/2, L] inverses of the first-half domain points; inv2, beta: [L].
    """
    half = codeword.shape[0] // 2
    return fold_halves(ctx, codeword[:half], codeword[half:], beta, inv_x, inv2)


def fold_halves(ctx: FieldCtx, fx: torch.Tensor, fnegx: torch.Tensor, beta: torch.Tensor, inv_x: torch.Tensor,
                inv2: torch.Tensor) -> torch.Tensor:
    """:func:`fold_codeword` on its two halves given apart (rows i of f(x)
    and of f(-x), and the inverses of their x)."""
    even = arith.mont_mul(ctx, arith.add(ctx, fx, fnegx), inv2)
    odd = arith.mont_mul(ctx, arith.mont_mul(ctx, arith.sub(ctx, fx, fnegx), inv2), inv_x)
    return arith.add(ctx, even, arith.mont_mul(ctx, odd, beta))


@dataclass
class FriQueryRound:
    index: int
    value_lo: int  # f(x_i)
    value_hi: int  # f(-x_i)
    path_lo: list[bytes]
    path_hi: list[bytes]


@dataclass
class FriProof:
    roots: list[bytes]
    final_codeword: list[int]
    queries: list[list[FriQueryRound]]  # [query][round]


class FriConfig:
    def __init__(self, field_name: str, domain_log2: int, final_size_log2: int = 2, num_queries: int = 20,
                 blowup_log2: int = 2):
        """Proves evaluations come from a polynomial of degree
        < 2^(domain_log2 - blowup_log2)."""
        assert blowup_log2 >= 1 and final_size_log2 >= blowup_log2
        self.field_name = field_name
        self.ctx = field_ctx(field_name)
        self.domain_log2 = domain_log2
        self.final_size_log2 = final_size_log2
        self.num_queries = num_queries
        self.blowup_log2 = blowup_log2
        self.root = find_root_of_unity(field_name, domain_log2)
        self.num_rounds = domain_log2 - final_size_log2
        self._tables: dict = {}

    def fold_tables(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """(the [N/2, L] inverses of round 0's first-half domain points, 1/2)
        in Montgomery form on ``device``, built there at first use (K1
        doublings).  Round r's domain is round 0's squared r times, so its
        inverses are this table at stride 2^r."""
        key = torch.device(device)
        if key not in self._tables:
            ctx, p = self.ctx, self.ctx.p
            inv_x = _twiddle_table(ctx, ctx.scalar(pow(self.root, p - 2, p), device=device), self.domain_log2 - 1)
            self._tables[key] = (inv_x, ctx.scalar(pow(2, p - 2, p), device=device))
        return self._tables[key]


def _level_offset(size: int, lvl: int) -> int:
    """Start of digest level ``lvl`` in the flat [2 size - 1, 32] tree of a
    ``size``-leaf tree (level i holds ``size >> i`` digests)."""
    return 0 if lvl == 0 else 2 * size - (size >> (lvl - 1))


def _gather_openings(ctx: FieldCtx, codewords, trees, vidx, sidx) -> tuple[np.ndarray, np.ndarray]:
    """Every round's opened values (plain limbs) and Merkle siblings,
    gathered on the codewords' device and copied to the host at once."""
    vals = arith.from_mont(ctx, torch.cat([cw[i] for cw, i in zip(codewords, vidx)]))
    sibs = torch.cat([t[i] for t, i in zip(trees, sidx)])
    both = torch.cat([vals.view(torch.uint8).reshape(-1), sibs.reshape(-1)]).cpu().numpy()
    n_val = vals.numel() * 4
    return both[:n_val].view(np.int32).reshape(vals.shape), both[n_val:].reshape(sibs.shape)


def _query_indices(transcript: Transcript, num: int, domain_size: int) -> list[int]:
    out = []
    while len(out) < num:
        digest = transcript.sample_random_challenge()
        for off in range(0, 32, 4):
            if len(out) >= num:
                break
            out.append(int.from_bytes(digest[off : off + 4], "little") % domain_size)
    return out


def prove(config: FriConfig, codeword, transcript: Transcript, device=None) -> FriProof:
    """codeword: [N, L] Montgomery evaluations over the size-N domain (a
    tensor keeps its device), or host ints (put on ``device``, by default
    the card)."""
    ctx = config.ctx
    if not isinstance(codeword, torch.Tensor):
        codeword = ctx.array(list(codeword), device=device)
    assert codeword.shape[0] == 1 << config.domain_log2
    inv_x, inv2 = config.fold_tables(codeword.device)

    codewords, trees, roots = [codeword], [], []
    current = codeword
    for r in range(config.num_rounds):
        tree = merkle_tree_flat(field_leaf_bytes(ctx, current))
        root = tree[-1].cpu().numpy().tobytes()
        transcript.append(root)
        beta = transcript.random_challenge_as_field_element(ctx)
        current = fold_codeword(ctx, current, ctx.scalar(beta, device=codeword.device), inv_x[:: 1 << r],
                                 inv2)
        trees.append(tree)
        roots.append(root)
        codewords.append(current)

    final_codeword = ctx.to_ints(current)
    for v in final_codeword:
        transcript.append(ctx.to_bytes_be(v))
    return _query_phase(config, codewords, trees, roots, final_codeword, transcript)


def _query_phase(config: FriConfig, codewords: list[torch.Tensor], trees: list[torch.Tensor], roots: list[bytes],
                 final_codeword: list[int], transcript: Transcript) -> FriProof:
    """Open the Fiat-Shamir query positions: one gather and one copy for
    every value and Merkle sibling of every round."""
    indices = _query_indices(transcript, config.num_queries, 1 << (config.domain_log2 - 1))
    tracked = list(indices)
    round_positions: list[list[int]] = []
    for r in range(config.num_rounds):
        half = 1 << (config.domain_log2 - r - 1)
        tracked = [i % half for i in tracked]
        round_positions.append(tracked)

    device = codewords[0].device
    vidx, sidx, nlevels_per_round = [], [], []
    for r, positions in enumerate(round_positions):
        size = 1 << (config.domain_log2 - r)
        opened = np.asarray([p for i in positions for p in (i, i + size // 2)], dtype=np.int64)
        vidx.append(torch.from_numpy(opened).to(device))
        nlevels = size.bit_length() - 1  # path levels (excludes the root)
        nlevels_per_round.append(nlevels)
        flat_idx = np.concatenate([_level_offset(size, lvl) + ((opened >> lvl) ^ 1) for lvl in range(nlevels)])
        sidx.append(torch.from_numpy(flat_idx).to(device))

    values, sibs = _gather_openings(config.ctx, codewords[: config.num_rounds], trees, vidx, sidx)
    values = config.ctx.to_ints(torch.from_numpy(values), mont=False)

    n_open = 2 * len(indices)
    paths: list[list[list[bytes]]] = []  # [round][opened slot] -> sibling digests, leaf level first
    base = 0
    for nlevels in nlevels_per_round:
        block = sibs[base : base + n_open * nlevels]
        base += n_open * nlevels
        paths.append([[block[lvl * n_open + slot].tobytes() for lvl in range(nlevels)] for slot in range(n_open)])

    queries = []
    for q in range(len(indices)):
        rounds = []
        for r in range(config.num_rounds):
            vals = values[r * n_open : (r + 1) * n_open]
            rounds.append(FriQueryRound(index=round_positions[r][q], value_lo=vals[2 * q], value_hi=vals[2 * q + 1],
                                        path_lo=paths[r][2 * q], path_hi=paths[r][2 * q + 1]))
        queries.append(rounds)
    return FriProof(roots=roots, final_codeword=final_codeword, queries=queries)


def verify(config: FriConfig, proof: FriProof, transcript: Transcript) -> bool:
    """On the host: the betas from the roots, the final codeword's degree,
    then every query's Merkle paths and fold chain."""
    ctx = config.ctx
    p = ctx.p
    if len(proof.roots) != config.num_rounds:
        return False

    betas = []
    for root in proof.roots:
        transcript.append(root)
        betas.append(transcript.random_challenge_as_field_element(ctx))
    for v in proof.final_codeword:
        transcript.append(ctx.to_bytes_be(v))

    # the final codeword must itself be low-degree: interpolate over its
    # (small) domain and check every coefficient at or above the bound is 0
    m = len(proof.final_codeword)
    if m != 1 << config.final_size_log2:
        return False
    w_final_inv = pow(pow(config.root, 1 << config.num_rounds, p), p - 2, p)
    m_inv = pow(m, p - 2, p)
    coeffs = [m_inv * sum(v * pow(w_final_inv, i * j, p) for i, v in enumerate(proof.final_codeword)) % p
              for j in range(m)]
    degree_bound = 1 << (config.final_size_log2 - config.blowup_log2)
    if any(c != 0 for c in coeffs[degree_bound:]):
        return False

    indices = _query_indices(transcript, config.num_queries, 1 << (config.domain_log2 - 1))
    if len(proof.queries) != len(indices):
        return False

    inv2 = pow(2, p - 2, p)
    for idx, rounds in zip(indices, proof.queries):
        if len(rounds) != config.num_rounds:
            return False
        pos = idx  # position of the value being tracked in the current codeword
        expected_next = None
        w = config.root
        for r, q in enumerate(rounds):
            half = 1 << (config.domain_log2 - r - 1)
            index = pos % half
            if q.index != index:
                return False
            if not verify_path(proof.roots[r], ctx.to_bytes_be(q.value_lo), index, q.path_lo):
                return False
            if not verify_path(proof.roots[r], ctx.to_bytes_be(q.value_hi), index + half, q.path_hi):
                return False
            if expected_next is not None and (q.value_lo if pos < half else q.value_hi) != expected_next:
                return False
            x_inv = pow(pow(w, index, p), p - 2, p)
            even = (q.value_lo + q.value_hi) * inv2 % p
            odd = (q.value_lo - q.value_hi) * inv2 % p * x_inv % p
            expected_next = (even + betas[r] * odd) % p
            w = w * w % p
            pos = index  # position in the folded (next) codeword
        if proof.final_codeword[pos] != expected_next:
            return False
    return True
