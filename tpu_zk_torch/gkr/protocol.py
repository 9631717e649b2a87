"""The full (dense) GKR protocol over layered arithmetic circuits, and the
GKR proof type that every prover and verifier of the package shares.

Counterpart of :mod:`tpu_zk.gkr.protocol` (reference
``gkr/src/gkr_protocol.rs``: Proof :16-23, prove :26-143, verify :146-236).
The protocol runs on the host; every per-layer table operation (the wiring tables'
build and folds, the f(b,c) outer tables, the sumcheck rounds) runs on the
device of the circuit's inputs.  Transcript absorb order per layer: w0
bytes -> ra; sumcheck (claimed sum BE, LE round univariates); then wb
evaluation BE -> alpha, wc evaluation BE -> beta.

The reference's quirks are kept: w0 is padded to length 2, layer 0 has
three variables and is partially evaluated at ra on its single tables, and
wc is wb.  Layer i's wiring tables have 2^(3i+2) entries, so this pipeline
reaches depth 9 on an 80 GB card; :mod:`.sparse` is the linear-time prover
and verifier, and emits the same proofs.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..circuit.layered import Circuit
from ..poly.multilinear import MultilinearPolynomial
from ..sumcheck import gkr_sumcheck
from ..sumcheck.gkr_sumcheck import SumcheckProverProof
from ..transcript.fiat_shamir import Transcript
from .wiring import WiringPair, expected_layer_claim, layer_polynomial, split_half_evaluations


@dataclass
class Proof:
    circuit_output: list[int]
    claimed_sum: int
    sumcheck_proofs: list[SumcheckProverProof]
    wb_evaluations: list[int]
    wc_evaluations: list[int]


def _w0_padded(ctx, output_values: list[int], device=None) -> MultilinearPolynomial:
    vals = list(output_values)
    if len(vals) == 1:
        vals.append(0)  # pad to a 1-variable MLE (gkr_protocol.rs:42-47)
    return MultilinearPolynomial.from_ints(ctx, vals, device=device)


def _layer_wiring(circuit: Circuit, layer_index: int, device, random_challenge_a: int, alpha: int, beta: int,
                  rb_values: list[int], rc_values: list[int]):
    """The wiring MLEs over (b, c) that layer ``layer_index``'s sumcheck
    runs on: layer 0's single tables partially evaluated at ra, every other
    layer's pair alpha/beta-folded at the previous layer's (rb, rc)."""
    pair = WiringPair.for_layer(circuit, layer_index, device)
    if layer_index == 0:
        add_i_abc, mul_i_abc = pair.split()
        return add_i_abc.partial_evaluate(0, random_challenge_a), mul_i_abc.partial_evaluate(0, random_challenge_a)
    return pair.alpha_beta_fold(alpha, beta, rb_values, rc_values).split()


def _prove_layers(circuit: Circuit, circuit_evaluation, transcript: Transcript, random_challenge_a: int,
                  claimed_sum: int, succinct: bool):
    """Every layer's dense sumcheck.  Returns (claimed_sum, layer proofs,
    wb evaluations, wc evaluations, rb, rc).

    Plain GKR keeps rb and rc up to the next-to-last layer; the succinct
    protocol (``succinct_gkr_protocol.rs:119-126``) also keeps the last
    layer's, the points at which the input commitment is opened.  Both
    record and absorb wb/wc for every layer but the last.
    """
    ctx = circuit.ctx
    device = circuit_evaluation.layer_tables[-1].device
    n_layers = len(circuit.layers)
    layer_proofs: list[SumcheckProverProof] = []
    wb_evaluations: list[int] = []
    wc_evaluations: list[int] = []
    alpha = beta = 0
    rb_values: list[int] = []
    rc_values: list[int] = []

    for layer_index in range(n_layers):
        add_i_bc, mul_i_bc = _layer_wiring(circuit, layer_index, device, random_challenge_a, alpha, beta,
                                           rb_values, rc_values)
        wb_poly = circuit.w_i_polynomial(circuit_evaluation, layer_index + 1)
        wc_poly = wb_poly  # wc == wb (gkr_protocol.rs:88-89)

        fbc_polynomial = layer_polynomial(add_i_bc, mul_i_bc, wb_poly, wc_poly)
        sumcheck_proof = gkr_sumcheck.prove(fbc_polynomial, claimed_sum, transcript)
        layer_proofs.append(sumcheck_proof)
        last = layer_index == n_layers - 1

        sumcheck_challenges = sumcheck_proof.random_challenges
        if succinct or not last:
            middle = len(sumcheck_challenges) // 2
            rb_values = sumcheck_challenges[:middle]
            rc_values = sumcheck_challenges[middle:]
        if not last:
            wb_evaluation, wc_evaluation = split_half_evaluations(wb_poly, wc_poly, sumcheck_challenges)
            wb_evaluations.append(wb_evaluation)
            wc_evaluations.append(wc_evaluation)

            transcript.append(ctx.to_bytes_be(wb_evaluation))
            alpha = transcript.random_challenge_as_field_element(ctx)
            transcript.append(ctx.to_bytes_be(wc_evaluation))
            beta = transcript.random_challenge_as_field_element(ctx)
            claimed_sum = (alpha * wb_evaluation + beta * wc_evaluation) % ctx.p

    return claimed_sum, layer_proofs, wb_evaluations, wc_evaluations, rb_values, rc_values


def _start(ctx, output: list[int], transcript: Transcript, device) -> tuple[int, int]:
    """Absorb w0 and squeeze ra; returns (ra, the claimed sum w0(ra))."""
    w0_polynomial = _w0_padded(ctx, output, device)
    transcript.append(w0_polynomial.convert_to_bytes())
    random_challenge_a = transcript.random_challenge_as_field_element(ctx)
    return random_challenge_a, w0_polynomial.evaluate([random_challenge_a])


def prove(circuit: Circuit, inputs, device=None) -> Proof:
    """Dense GKR prove.  ``inputs`` is a Montgomery ``[N, L]`` tensor (proved
    on its device) or host ints (proved on ``device``, by default the
    package's default device); the wiring tables are built there too."""
    ctx = circuit.ctx
    circuit_evaluation = circuit.evaluate(inputs, materialize=False, device=device)
    transcript = Transcript()
    random_challenge_a, claimed_sum = _start(ctx, circuit_evaluation.output, transcript,
                                             circuit_evaluation.layer_tables[-1].device)
    claimed_sum, layer_proofs, wb_evaluations, wc_evaluations, _, _ = _prove_layers(
        circuit, circuit_evaluation, transcript, random_challenge_a, claimed_sum, succinct=False
    )
    return Proof(
        circuit_output=circuit_evaluation.output,
        claimed_sum=claimed_sum,
        sumcheck_proofs=layer_proofs,
        wb_evaluations=wb_evaluations,
        wc_evaluations=wc_evaluations,
    )


def _fits(circuit: Circuit, proof) -> bool:
    """Whether the proof has the dense pipeline's shape for the circuit:
    one sumcheck a layer, layer i over 2(i+1) variables, and wb/wc for
    every layer but the last."""
    n_layers = len(circuit.layers)
    return (
        len(proof.sumcheck_proofs) == n_layers
        and len(proof.wb_evaluations) == len(proof.wc_evaluations) == n_layers - 1
        and all(len(p.round_univariate_polynomials) == 2 * (i + 1) for i, p in enumerate(proof.sumcheck_proofs))
    )


def _verify_layers(circuit: Circuit, proof, device, input_poly: MultilinearPolynomial | None):
    """Every layer's sumcheck and wiring claim.  Returns the last layer's
    challenges, or None if the proof is rejected.

    With ``input_poly`` (plain GKR) the last layer's claim is checked against
    the inputs' MLE at (rb, rc).  Without it (succinct GKR) the last layer's
    claim is not checked and zero is absorbed for its wb and wc, as the
    reference verifier does (``succinct_gkr_protocol.rs:172-284``); the
    caller checks the two KZG openings instead.
    """
    ctx = circuit.ctx
    if not _fits(circuit, proof):
        return None
    n_layers = len(circuit.layers)
    transcript = Transcript()
    alpha = beta = 0
    prev_sumcheck_challenges: list[int] = []
    random_challenge_a, claimed_sum = _start(ctx, proof.circuit_output, transcript, device)

    for layer_index in range(n_layers):
        if claimed_sum != proof.sumcheck_proofs[layer_index].claimed_sum % ctx.p:
            return None
        verify_result = gkr_sumcheck.verify(proof.sumcheck_proofs[layer_index], transcript, ctx)
        if not verify_result.is_proof_valid:
            return None
        sumcheck_challenges = verify_result.random_challenges

        last = layer_index == n_layers - 1
        wb_evaluation = wc_evaluation = 0
        if not last:
            wb_evaluation = proof.wb_evaluations[layer_index]
            wc_evaluation = proof.wc_evaluations[layer_index]
        elif input_poly is not None:
            wb_evaluation, wc_evaluation = split_half_evaluations(input_poly, input_poly, sumcheck_challenges)

        if not last or input_poly is not None:
            if layer_index == 0:
                expected_claim = expected_layer_claim(
                    circuit, layer_index, sumcheck_challenges, wb_evaluation, wc_evaluation,
                    initial_random_challenge=random_challenge_a, device=device,
                )
            else:
                expected_claim = expected_layer_claim(
                    circuit, layer_index, sumcheck_challenges, wb_evaluation, wc_evaluation,
                    previous_sumcheck_challenges=prev_sumcheck_challenges, alpha=alpha, beta=beta, device=device,
                )
            if expected_claim != verify_result.last_claimed_sum:
                return None

        prev_sumcheck_challenges = list(sumcheck_challenges)
        transcript.append(ctx.to_bytes_be(wb_evaluation))
        alpha = transcript.random_challenge_as_field_element(ctx)
        transcript.append(ctx.to_bytes_be(wc_evaluation))
        beta = transcript.random_challenge_as_field_element(ctx)
        claimed_sum = (alpha * wb_evaluation + beta * wc_evaluation) % ctx.p

    return prev_sumcheck_challenges


def verify(circuit: Circuit, proof: Proof, inputs, device=None) -> bool:
    """Dense GKR verify: rebuilds and folds every layer's wiring tables.

    ``inputs`` is a Montgomery ``[N, L]`` tensor (checked on its device) or
    host ints (checked on ``device``, by default the package's default
    device).  A proof whose shape does not fit the circuit is rejected
    (``tpu_zk``'s raises or reads past it)."""
    ctx = circuit.ctx
    if isinstance(inputs, torch.Tensor):
        input_poly = MultilinearPolynomial(ctx, inputs)
    else:
        input_poly = MultilinearPolynomial.from_ints(ctx, list(inputs), device=device)
    return _verify_layers(circuit, proof, input_poly.table.device, input_poly) is not None
