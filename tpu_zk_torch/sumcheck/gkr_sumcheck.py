"""Degree-aware sumcheck over composed SumPolynomials (the GKR inner loop).

Counterpart of :mod:`tpu_zk.sumcheck.gkr_sumcheck`.  Per round the device
evaluates the round univariate at t = 0..degree (:func:`.fused._round_lazy_sums`),
the evaluations are interpolated to coefficient form, the transcript absorbs
the **little-endian** coefficient bytes and squeezes the challenge, and the
device folds the whole ``[p, k, N, L]`` working set at it (one K2 launch,
``p*k`` batch rows).  With ``fused=True`` (the default, as in ``tpu_zk``)
the interpolation and the transcript run on the device too
(:func:`.fused.fused_gkr_sumcheck_prove`, one K7 launch a round) and the
host copies the coefficients and digests once, after the last round; with
``fused=False`` one copy a round brings the degree+1 sums to the host, which
interpolates and runs the host transcript.  The prover folds at every
challenge, the last one included, so after the final round each factor
table holds its value at the challenge point (``fused_sparse._round``
:120-135).

Reference parity: ``sumcheck_protocol/src/gkr_sumcheck/sumcheck_gkr_protocol.rs``
(prove :24-67, verify :69-106, generate_round_univariate :113-143,
univariate_to_bytes LE :145-150, field_element_to_bytes BE :152-154).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..fields import arith
from ..fields.arith import FieldCtx
from ..poly.composed import SumPolynomial
from ..poly.multilinear import fold
from ..poly.univariate import DenseUnivariatePolynomial
from ..transcript.device_fs import DeviceSponge
from ..transcript.fiat_shamir import Transcript
from . import fused as fused_prover


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
    return arith.lazy_to_ints(ctx, fused_prover._round_lazy_sums(ctx, sum_polynomial.stacked))


def prove(
    sum_polynomial: SumPolynomial,
    claimed_sum: int,
    transcript: Transcript,
    fused: bool = True,
    absorb_claim: bool = True,
) -> SumcheckProverProof:
    """absorb_claim=False continues an in-flight sumcheck (the sparse GKR
    prover runs one logical sumcheck as two phase-wise working sets)."""
    return prove_and_fold(sum_polynomial, claimed_sum, transcript, fused, absorb_claim)[0]


def prove_and_fold(
    sum_polynomial: SumPolynomial,
    claimed_sum: int,
    transcript: Transcript,
    fused: bool = True,
    absorb_claim: bool = True,
) -> tuple[SumcheckProverProof, SumPolynomial]:
    """:func:`prove`, also returning the working set folded at every
    challenge: each factor table then holds one value, the factor's
    evaluation at the challenge point."""
    ctx = sum_polynomial.ctx
    degree = sum_polynomial.degree
    if absorb_claim:
        transcript.append(ctx.to_bytes_be(claimed_sum))
    if fused:
        return _prove_fused(sum_polynomial, claimed_sum, transcript)

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


def _prove_fused(sum_polynomial: SumPolynomial, claimed_sum: int,
                 transcript: Transcript) -> tuple[SumcheckProverProof, SumPolynomial]:
    """The rounds on the device sponge, seeded from the host transcript;
    one copy of the coefficients and digests, and of the sponge to re-sync
    the host transcript, after the last round."""
    ctx = sum_polynomial.ctx
    n = sum_polynomial.number_of_variables
    width = sum_polynomial.degree + 1
    hasher = transcript._hasher
    sponge = DeviceSponge.from_host(hasher, sum_polynomial.stacked.device)
    coeffs, digests, state, buf, folded = fused_prover.fused_gkr_sumcheck_prove(
        ctx, sum_polynomial.stacked, sponge.state, sponge.buf, sponge.pos)
    flat = ctx.to_ints(coeffs.reshape(-1, ctx.L), mont=False)
    transcript._hasher = DeviceSponge.to_host(state, buf, fused_prover.final_pos(len(hasher._buf), n, width * ctx.nbytes))
    proof = SumcheckProverProof(
        claimed_sum=claimed_sum,
        round_univariate_polynomials=[DenseUnivariatePolynomial(ctx, flat[i * width : (i + 1) * width])
                                      for i in range(n)],
        random_challenges=[ctx.from_le_bytes_mod_order(bytes(d)) for d in digests.cpu().numpy()],
    )
    return proof, SumPolynomial(ctx, folded)


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
