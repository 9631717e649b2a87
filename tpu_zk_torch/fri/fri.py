"""FRI low-degree test with Merkle commitments and Fiat-Shamir queries;
proofs equal to :mod:`tpu_zk.fri.fri`'s, field for field.

Protocol (commit-fold): the prover holds evaluations of f over the
multiplicative group <w> of size N.  Each round: Merkle-commit the codeword,
absorb the root, squeeze beta, and fold

    f'(x^2) = (f(x) + f(-x))/2 + beta * (f(x) - f(-x)) / (2x)

halving the domain, until ``final_size``; the last codeword is sent in clear.
Query phase: indices drawn from the transcript; per round the prover opens
(i, i + N/2) with Merkle paths and the verifier recomputes the fold chain.

On the card: the whole commit phase, as in ``tpu_zk``.  Each round
(:func:`_commit_round`) makes the leaf bytes (``from_mont`` through K1),
every Merkle level (K5), absorbs the root and squeezes beta on the device
sponge (:mod:`tpu_zk_torch.transcript.device_fs`, one launch of K7's byte
form) and folds at that beta (K1, K3); the rounds chain with no copy to
the host.
The roots, the final codeword and the sponge then come back in one copy,
and the host transcript continues from the sponge.  The query phase
gathers every opened value and sibling on the card and copies them back at
once.
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
from ..sumcheck.fused import final_pos
from ..transcript.device_fs import DeviceSponge
from ..transcript.fiat_shamir import Transcript
from ..transcript.kernels import sponge_step


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
    gathered on the codewords' device and copied to the host at once
    (nothing to open after no commit round)."""
    if not codewords:
        return np.zeros((0, ctx.L), np.int32), np.zeros((0, 32), np.uint8)
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


def _root_challenge(ctx: FieldCtx, sponge: DeviceSponge, root: torch.Tensor) -> torch.Tensor:
    """Absorb a round's Merkle root ([32] uint8 on the sponge's device) and
    squeeze beta: one K7 launch; beta's [L] Montgomery limbs stay there."""
    beta = torch.empty(ctx.L, dtype=torch.int32, device=root.device)
    digest = torch.empty(32, dtype=torch.uint8, device=root.device)
    sponge_step(sponge.state, sponge.buf, sponge.pos, root, digest, beta, ctx)
    return beta


def _commit_round(ctx: FieldCtx, sponge: DeviceSponge, codeword: torch.Tensor, inv_x: torch.Tensor,
                  inv2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One commit round on the codeword's device, nothing read back: the
    round's flat Merkle tree (K1 leaf bytes, K5 levels), beta from its root
    on the device sponge (K7) and the codeword folded at beta (K1, K3)."""
    tree = merkle_tree_flat(field_leaf_bytes(ctx, codeword))
    beta = _root_challenge(ctx, sponge, tree[-1])
    return tree, beta, fold_codeword(ctx, codeword, beta, inv_x, inv2)


def _hand_back(ctx: FieldCtx, transcript: Transcript, sponge: DeviceSponge, roots: list[torch.Tensor],
               final: torch.Tensor) -> tuple[list[bytes], list[int]]:
    """After the commit rounds on a sponge seeded from the transcript (one
    root a round): one copy of the sponge's state, the final codeword, the
    roots and the sponge's tail; the transcript goes on from the sponge, its
    fill level from :func:`final_pos` (not read back).  Returns (the roots'
    bytes, the final codeword's ints)."""
    parts = [sponge.state.view(torch.uint8), final.reshape(-1).view(torch.uint8), *roots, sponge.buf]
    sizes = [parts[0].numel(), parts[1].numel(), 32 * len(roots), sponge.buf.numel()]
    state, final_h, roots_h, buf = torch.cat(parts).cpu().split(sizes)
    pos = final_pos(len(transcript._hasher._buf), len(roots), 32)
    transcript._hasher = DeviceSponge.to_host(state.view(torch.int64), buf, pos)
    return ([row.tobytes() for row in roots_h.numpy().reshape(-1, 32)],
            ctx.to_ints(final_h.view(torch.int32).view(final.shape)))


def prove(config: FriConfig, codeword, transcript: Transcript, device=None) -> FriProof:
    """codeword: [N, L] Montgomery evaluations over the size-N domain (a
    tensor keeps its device), or host ints (put on ``device``, by default
    the card).  The commit phase runs on the codeword's device with the
    transcript on the device sponge; the host transcript takes over again
    for the final codeword and the query phase."""
    ctx = config.ctx
    if not isinstance(codeword, torch.Tensor):
        codeword = ctx.array(list(codeword), device=device)
    assert codeword.shape[0] == 1 << config.domain_log2
    inv_x, inv2 = config.fold_tables(codeword.device)

    sponge = DeviceSponge.from_host(transcript._hasher, codeword.device)
    codewords, trees = [codeword], []
    current = codeword
    for r in range(config.num_rounds):
        tree, _, current = _commit_round(ctx, sponge, current, inv_x[:: 1 << r], inv2)
        trees.append(tree)
        codewords.append(current)
    roots, final_codeword = _hand_back(ctx, transcript, sponge, [t[-1] for t in trees], current)

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
