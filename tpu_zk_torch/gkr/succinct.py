"""Succinct GKR: dense GKR with a multilinear-KZG commitment to the input
layer, and the succinct proof type that every succinct prover of the
package shares.

Counterpart of :mod:`tpu_zk.gkr.succinct` (reference
``gkr/src/succinct_gkr_protocol.rs``: SuccinctProof :22-32, prove_succinct
:35-169, verify_succinct :172-284).  Against plain GKR: the prover commits to
the input MLE up front, keeps rb/rc from the *last* layer's sumcheck and
appends two KZG openings there; the verifier does not check the last
layer's claim and checks the two openings instead, and it still absorbs wb
and wc for every layer (zero for the last one).  The linear-time pair is
in :mod:`.sparse`, and emits the same proofs.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..circuit.layered import Circuit
from ..kzg import multilinear_kzg
from ..kzg.multilinear_kzg import MultilinearKZGProof
from ..kzg.trusted_setup import TrustedSetup
from ..poly.multilinear import MultilinearPolynomial
from ..sumcheck.gkr_sumcheck import SumcheckProverProof
from ..transcript.fiat_shamir import Transcript
from . import protocol


@dataclass
class SuccinctProof:
    circuit_output: list[int]
    claimed_sum: int
    sumcheck_proofs: list[SumcheckProverProof]
    wb_evaluations: list[int]
    wc_evaluations: list[int]
    input_polynomial_commitment: tuple  # affine G1
    input_rb_proof: MultilinearKZGProof
    input_rc_proof: MultilinearKZGProof


def prove_succinct(circuit: Circuit, inputs, trusted_setup: TrustedSetup) -> SuccinctProof:
    """Dense succinct GKR prove.  ``inputs`` is a Montgomery ``[N, L]``
    tensor on the setup's device or host ints (placed there)."""
    ctx = circuit.ctx
    device = trusted_setup.curve.device
    table = inputs if isinstance(inputs, torch.Tensor) else ctx.array(list(inputs), device=device)
    circuit_evaluation = circuit.evaluate(table, materialize=False)

    input_polynomial = MultilinearPolynomial(ctx, table)
    input_commitment = multilinear_kzg.commit_to_polynomial(input_polynomial, trusted_setup)

    transcript = Transcript()
    random_challenge_a, claimed_sum = protocol._start(ctx, circuit_evaluation.output, transcript, table.device)
    claimed_sum, layer_proofs, wb_evaluations, wc_evaluations, rb_values, rc_values = protocol._prove_layers(
        circuit, circuit_evaluation, transcript, random_challenge_a, claimed_sum, succinct=True
    )
    output = circuit_evaluation.output
    del circuit_evaluation

    return SuccinctProof(
        circuit_output=output,
        claimed_sum=claimed_sum,
        sumcheck_proofs=layer_proofs,
        wb_evaluations=wb_evaluations,
        wc_evaluations=wc_evaluations,
        input_polynomial_commitment=input_commitment,
        input_rb_proof=multilinear_kzg.open_and_prove(input_polynomial, trusted_setup, rb_values),
        input_rc_proof=multilinear_kzg.open_and_prove(input_polynomial, trusted_setup, rc_values),
    )


def verify_succinct(circuit: Circuit, proof: SuccinctProof, trusted_setup: TrustedSetup) -> bool:
    """Dense verify of a succinct proof and the two KZG opening checks, on
    the setup's device.  A proof whose shape does not fit the circuit and
    the setup is rejected."""
    n_vars = trusted_setup.num_vars
    openings = (proof.input_rb_proof, proof.input_rc_proof)
    if any(len(o.proofs) != n_vars for o in openings):
        return False
    challenges = protocol._verify_layers(circuit, proof, trusted_setup.curve.device, None)
    if challenges is None or len(challenges) != 2 * n_vars:
        return False
    mid = len(challenges) // 2
    return all(
        multilinear_kzg.verify(trusted_setup, proof.input_polynomial_commitment, point, opening)
        for point, opening in zip((challenges[:mid], challenges[mid:]), openings)
    )
