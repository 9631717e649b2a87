"""Degree-aware sumcheck over composed SumPolynomials (the GKR inner loop).

Counterpart of :mod:`tpu_zk.sumcheck.gkr_sumcheck`, host-synced: per round
the device evaluates the round univariate at t = 0..degree, one copy brings
those degree+1 sums to the host, which interpolates to coefficient form,
absorbs the **little-endian** coefficient bytes, squeezes the challenge, and
the device folds the whole ``[p, k, N, L]`` working set at it (one K2
launch, ``p*k`` batch rows).

The sample points need no generic multiply (``tpu_zk/gkr/fused_sparse.py
_round_lm`` :183-193): with d = hi - lo the factor tables at t are lo, hi,
hi + d, hi + 2d, ... (K3), so each point costs only the k - 1 collapse
products (K1) and one int64 limb sum.  The prover folds at every challenge,
the last one included, so after the final round each factor table holds its
value at the challenge point (``fused_sparse._round`` :120-135).

Reference parity: ``sumcheck_protocol/src/gkr_sumcheck/sumcheck_gkr_protocol.rs``
(prove :24-67, verify :69-106, generate_round_univariate :113-143,
univariate_to_bytes LE :145-150, field_element_to_bytes BE :152-154).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..fields import arith
from ..fields.arith import FieldCtx
from ..poly.composed import SumPolynomial, product_of_factors
from ..poly.multilinear import fold
from ..poly.univariate import DenseUnivariatePolynomial
from ..transcript.fiat_shamir import Transcript


@dataclass
class SumcheckProverProof:
    claimed_sum: int
    round_univariate_polynomials: list[DenseUnivariatePolynomial]
    random_challenges: list[int]


@dataclass
class SumcheckVerifierProof:
    is_proof_valid: bool
    random_challenges: list[int]
    last_claimed_sum: int


def generate_round_univariate(sum_polynomial: SumPolynomial) -> list[int]:
    """Evaluations of the round univariate at t = 0..degree (canonical ints).

    Mirrors sumcheck_gkr_protocol.rs:113-143: fold variable 0 at t, collapse
    elementwise (product over k, sum over p), grand-sum.  The sum over p and
    over the table is one exact int64 limb sum per point, reduced on the host.
    """
    ctx = sum_polynomial.ctx
    stacked = sum_polynomial.stacked
    k, N = stacked.shape[1], stacked.shape[2]
    if N < 2:
        raise ValueError("generate_round_univariate: no variable left to sum over")
    lo, hi = stacked[:, :, : N // 2], stacked[:, :, N // 2 :]
    step = arith.sub(ctx, hi, lo)
    lazy = []
    point = lo
    for t in range(k + 1):
        if t == 1:
            point = hi
        elif t > 1:
            point = arith.add(ctx, point, step)
        prod = product_of_factors(ctx, point.unbind(1))
        lazy.append(prod.reshape(-1, ctx.L).sum(dim=0, dtype=torch.int64))
    return arith.lazy_to_ints(ctx, torch.stack(lazy))


def prove(
    sum_polynomial: SumPolynomial,
    claimed_sum: int,
    transcript: Transcript,
    absorb_claim: bool = True,
) -> SumcheckProverProof:
    """absorb_claim=False continues an in-flight sumcheck (the sparse GKR
    prover runs one logical sumcheck as two phase-wise working sets)."""
    return prove_and_fold(sum_polynomial, claimed_sum, transcript, absorb_claim)[0]


def prove_and_fold(
    sum_polynomial: SumPolynomial,
    claimed_sum: int,
    transcript: Transcript,
    absorb_claim: bool = True,
) -> tuple[SumcheckProverProof, SumPolynomial]:
    """:func:`prove`, also returning the working set folded at every
    challenge: each factor table then holds one value, the factor's
    evaluation at the challenge point."""
    ctx = sum_polynomial.ctx
    degree = sum_polynomial.degree
    if absorb_claim:
        transcript.append(ctx.to_bytes_be(claimed_sum))

    x_values = list(range(degree + 1))
    round_polys: list[DenseUnivariatePolynomial] = []
    random_challenges: list[int] = []
    current = sum_polynomial
    for _ in range(sum_polynomial.number_of_variables):
        evaluations = generate_round_univariate(current)
        univariate = DenseUnivariatePolynomial.lagrange_interpolate(ctx, x_values, evaluations)
        transcript.append(univariate.to_bytes_le())
        round_polys.append(univariate)
        r = transcript.random_challenge_as_field_element(ctx)
        random_challenges.append(r)
        current = SumPolynomial(ctx, fold(ctx, current.stacked, 0, ctx.scalar(r, device=current.stacked.device)))

    proof = SumcheckProverProof(
        claimed_sum=claimed_sum,
        round_univariate_polynomials=round_polys,
        random_challenges=random_challenges,
    )
    return proof, current


def verify(proof: SumcheckProverProof, transcript: Transcript, ctx: FieldCtx) -> SumcheckVerifierProof:
    transcript.append(ctx.to_bytes_be(proof.claimed_sum))

    current_sum = proof.claimed_sum % ctx.p
    random_challenges: list[int] = []

    for round_polynomial in proof.round_univariate_polynomials:
        eval_at_zero = round_polynomial.evaluate(0)
        eval_at_one = round_polynomial.evaluate(1)
        if (eval_at_zero + eval_at_one) % ctx.p != current_sum:
            return SumcheckVerifierProof(False, [], current_sum)

        transcript.append(round_polynomial.to_bytes_le())
        r = transcript.random_challenge_as_field_element(ctx)
        current_sum = round_polynomial.evaluate(r)
        random_challenges.append(r)

    return SumcheckVerifierProof(True, random_challenges, current_sum)
