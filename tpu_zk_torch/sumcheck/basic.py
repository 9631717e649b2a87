"""Basic non-interactive sumcheck over a multilinear evaluation table.

The table lives on its device (CUDA or CPU).  Each prover round is one K2
launch (fold + per-block sums) and a small reduction to the next round's
two half-sums.  With ``fused=True`` (the default, as in ``tpu_zk``) the
Fiat-Shamir transcript of the rounds runs on the device sponge
(:mod:`.fused`: one K7 launch a round, no copy to the host until the last
round); with ``fused=False`` each round copies its two elements to the host,
where the transcript absorbs their bytes and squeezes the next challenge.
Both give the same transcript bytes and proofs as :mod:`tpu_zk.sumcheck.basic`.

Transcript absorb order: full initial polynomial bytes (BE), claimed sum
(BE), then per round the 2-point univariate (BE) before squeezing the
challenge.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..fields.arith import FieldCtx
from ..poly.multilinear import MultilinearPolynomial, fold_and_half_sums, sum_halves
from ..transcript.device_fs import DeviceSponge
from ..transcript.fiat_shamir import Transcript
from . import fused as fused_prover


@dataclass
class SumcheckProof:
    initial_polynomial: MultilinearPolynomial
    initial_claimed_sum: int
    round_univariate_polynomials: list[MultilinearPolynomial]  # 2-entry eval form


class Prover:
    def __init__(self, polynomial: MultilinearPolynomial):
        self.ctx = polynomial.ctx
        self.initial_polynomial = polynomial
        self.initial_claimed_sum = polynomial.sum()
        self.transcript = Transcript()

    @classmethod
    def init(cls, ctx: FieldCtx, values, device=None) -> "Prover":
        return cls(MultilinearPolynomial.from_ints(ctx, values, device=device))

    def prove(self, fused: bool = True) -> SumcheckProof:
        ctx = self.ctx
        self.transcript.append(self.initial_polynomial.convert_to_bytes())
        self.transcript.append(ctx.to_bytes_be(self.initial_claimed_sum))

        table = self.initial_polynomial.table
        n = self.initial_polynomial.number_of_variables
        if fused:
            return self._prove_fused(table, n)
        round_polys = []
        univ_m = sum_halves(ctx, table)  # [2, L] Montgomery
        for rnd in range(n):
            round_polys.append(MultilinearPolynomial(ctx, univ_m))
            table, univ_m = host_round(ctx, self.transcript, table, univ_m, rnd < n - 1)

        return SumcheckProof(
            initial_polynomial=self.initial_polynomial,
            initial_claimed_sum=self.initial_claimed_sum,
            round_univariate_polynomials=round_polys,
        )

    def _prove_fused(self, table, n: int) -> SumcheckProof:
        """The rounds on the device sponge, seeded from the host transcript
        (which has absorbed the table and the claim); the round polynomials
        are slices of the Montgomery stack, and the host transcript is
        re-synced from the returned sponge (one copy)."""
        ctx = self.ctx
        hasher = self.transcript._hasher
        sponge = DeviceSponge.from_host(hasher, table.device)
        _, univs_mont, _, state, buf = fused_prover.fused_basic_prove(ctx, table, sponge.state, sponge.buf, sponge.pos)
        pos = fused_prover.final_pos(len(hasher._buf), n, 2 * ctx.nbytes)
        self.transcript._hasher = DeviceSponge.to_host(state, buf, pos)
        return SumcheckProof(
            initial_polynomial=self.initial_polynomial,
            initial_claimed_sum=self.initial_claimed_sum,
            round_univariate_polynomials=[MultilinearPolynomial(ctx, univs_mont[i]) for i in range(n)],
        )


def host_round(ctx: FieldCtx, transcript: Transcript, table: torch.Tensor, univ_m: torch.Tensor, fold_table: bool):
    """One round of the host-synced loop: the round univariate ``univ_m``
    ([2, L] Montgomery, the table's half-sums) copied to the host and
    absorbed (BE), the challenge squeezed, and, if ``fold_table``, the table
    folded at it with the next round's half-sums (one K2 launch).  Returns
    (table, univ_m), unchanged when nothing is folded (the last round)."""
    u0, u1 = ctx.to_ints(univ_m)
    transcript.append(ctx.to_bytes_be(u0) + ctx.to_bytes_be(u1))
    challenge = transcript.random_challenge_as_field_element(ctx)
    if not fold_table:
        return table, univ_m
    return fold_and_half_sums(ctx, table, ctx.scalar(challenge, device=table.device))


class Verifier:
    def __init__(self):
        self.transcript = Transcript()

    @classmethod
    def init(cls) -> "Verifier":
        return cls()

    def verify(self, proof: SumcheckProof) -> bool:
        ctx = proof.initial_polynomial.ctx
        p = ctx.p
        if len(proof.round_univariate_polynomials) != proof.initial_polynomial.number_of_variables:
            return False

        current_claim = proof.initial_claimed_sum % p
        self.transcript.append(proof.initial_polynomial.convert_to_bytes())
        self.transcript.append(ctx.to_bytes_be(proof.initial_claimed_sum))

        # one host copy for every round univariate
        tables = [u.table.cpu() for u in proof.round_univariate_polynomials]
        all_ints = ctx.to_ints(torch.stack(tables)) if tables else []
        pairs = [all_ints[2 * i : 2 * i + 2] for i in range(len(all_ints) // 2)]

        challenges = []
        for u0, u1 in pairs:
            if (u0 + u1) % p != current_claim:
                return False
            self.transcript.append(ctx.to_bytes_be(u0) + ctx.to_bytes_be(u1))
            r = self.transcript.random_challenge_as_field_element(ctx)
            challenges.append(r)
            # the 2-point eval-form univariate at r: u0 + r*(u1-u0)
            current_claim = (u0 + r * (u1 - u0)) % p

        final_evaluation = proof.initial_polynomial.evaluate(challenges)
        return final_evaluation == current_claim
