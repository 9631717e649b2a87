"""Proof (de)serialization: basic sumcheck, GKR, succinct GKR and KZG openings.

The JSON is byte for byte :mod:`tpu_zk.utils.serialize`'s
(``sumcheck_proof_to_json``, ``gkr_proof_to_json``,
``succinct_proof_to_json``, ``kzg_proof_to_json``): canonical JSON with
hex-encoded field elements and affine points, independent of limb layout
and device.
"""

from __future__ import annotations

import json

from ..fields.arith import FieldCtx, field_ctx
from ..gkr.protocol import Proof
from ..gkr.succinct import SuccinctProof
from ..kzg.multilinear_kzg import MultilinearKZGProof
from ..poly.multilinear import MultilinearPolynomial
from ..poly.univariate import DenseUnivariatePolynomial
from ..sumcheck.basic import SumcheckProof
from ..sumcheck.gkr_sumcheck import SumcheckProverProof

FORMAT_VERSION = 1


def sumcheck_proof_to_json(proof: SumcheckProof) -> str:
    ctx = proof.initial_polynomial.ctx
    return json.dumps(
        {
            "version": FORMAT_VERSION,
            "kind": "sumcheck",
            "field": ctx.name,
            "initial_polynomial": [hex(v) for v in proof.initial_polynomial.to_ints()],
            "initial_claimed_sum": hex(proof.initial_claimed_sum),
            "round_univariates": [[hex(v) for v in u.to_ints()] for u in proof.round_univariate_polynomials],
        }
    )


def sumcheck_proof_from_json(data: str, device=None) -> SumcheckProof:
    obj = json.loads(data)
    if obj.get("kind") != "sumcheck" or obj.get("version") != FORMAT_VERSION:
        raise ValueError(f"not a version-{FORMAT_VERSION} sumcheck proof")
    ctx = field_ctx(obj["field"])
    return SumcheckProof(
        initial_polynomial=MultilinearPolynomial.from_ints(
            ctx, [int(v, 16) for v in obj["initial_polynomial"]], device=device
        ),
        initial_claimed_sum=int(obj["initial_claimed_sum"], 16),
        round_univariate_polynomials=[
            MultilinearPolynomial.from_ints(ctx, [int(v, 16) for v in u], device=device)
            for u in obj["round_univariates"]
        ],
    )


def _sumcheck_prover_proof_obj(p: SumcheckProverProof):
    return {
        "claimed_sum": hex(p.claimed_sum),
        "round_univariates": [[hex(c) for c in u.coefficients] for u in p.round_univariate_polynomials],
        "random_challenges": [hex(c) for c in p.random_challenges],
    }


def _sumcheck_prover_proof_from(ctx: FieldCtx, obj) -> SumcheckProverProof:
    return SumcheckProverProof(
        claimed_sum=int(obj["claimed_sum"], 16),
        round_univariate_polynomials=[
            DenseUnivariatePolynomial(ctx, [int(c, 16) for c in u]) for u in obj["round_univariates"]
        ],
        random_challenges=[int(c, 16) for c in obj["random_challenges"]],
    )


def gkr_proof_to_json(proof: Proof, field_name: str) -> str:
    return json.dumps(
        {
            "version": FORMAT_VERSION,
            "kind": "gkr",
            "field": field_name,
            "circuit_output": [hex(v) for v in proof.circuit_output],
            "claimed_sum": hex(proof.claimed_sum),
            "sumcheck_proofs": [_sumcheck_prover_proof_obj(p) for p in proof.sumcheck_proofs],
            "wb_evaluations": [hex(v) for v in proof.wb_evaluations],
            "wc_evaluations": [hex(v) for v in proof.wc_evaluations],
        }
    )


def gkr_proof_from_json(data: str) -> Proof:
    obj = json.loads(data)
    if obj.get("kind") != "gkr" or obj.get("version") != FORMAT_VERSION:
        raise ValueError(f"not a version-{FORMAT_VERSION} GKR proof")
    ctx = field_ctx(obj["field"])
    return Proof(
        circuit_output=[int(v, 16) for v in obj["circuit_output"]],
        claimed_sum=int(obj["claimed_sum"], 16),
        sumcheck_proofs=[_sumcheck_prover_proof_from(ctx, p) for p in obj["sumcheck_proofs"]],
        wb_evaluations=[int(v, 16) for v in obj["wb_evaluations"]],
        wc_evaluations=[int(v, 16) for v in obj["wc_evaluations"]],
    )


# -- succinct GKR and KZG ------------------------------------------------------


def _point(p):
    """Affine G1 int pair (or None for infinity) -> JSON value."""
    return None if p is None else [hex(p[0]), hex(p[1])]


def _unpoint(v):
    return None if v is None else (int(v[0], 16), int(v[1], 16))


def _kzg_proof_obj(p: MultilinearKZGProof):
    return {"evaluation": hex(p.evaluation), "proofs": [_point(q) for q in p.proofs]}


def _kzg_proof_from(obj) -> MultilinearKZGProof:
    return MultilinearKZGProof(evaluation=int(obj["evaluation"], 16), proofs=[_unpoint(q) for q in obj["proofs"]])


def kzg_proof_to_json(p: MultilinearKZGProof) -> str:
    return json.dumps({"version": FORMAT_VERSION, "kind": "kzg", **_kzg_proof_obj(p)})


def kzg_proof_from_json(data: str) -> MultilinearKZGProof:
    obj = json.loads(data)
    if obj.get("kind") != "kzg" or obj.get("version") != FORMAT_VERSION:
        raise ValueError(f"not a version-{FORMAT_VERSION} KZG proof")
    return _kzg_proof_from(obj)


def succinct_proof_to_json(proof: SuccinctProof, field_name: str) -> str:
    return json.dumps(
        {
            "version": FORMAT_VERSION,
            "kind": "succinct_gkr",
            "field": field_name,
            "circuit_output": [hex(v) for v in proof.circuit_output],
            "claimed_sum": hex(proof.claimed_sum),
            "sumcheck_proofs": [_sumcheck_prover_proof_obj(p) for p in proof.sumcheck_proofs],
            "wb_evaluations": [hex(v) for v in proof.wb_evaluations],
            "wc_evaluations": [hex(v) for v in proof.wc_evaluations],
            "input_commitment": _point(proof.input_polynomial_commitment),
            "input_rb_proof": _kzg_proof_obj(proof.input_rb_proof),
            "input_rc_proof": _kzg_proof_obj(proof.input_rc_proof),
        }
    )


def succinct_proof_from_json(data: str) -> SuccinctProof:
    obj = json.loads(data)
    if obj.get("kind") != "succinct_gkr" or obj.get("version") != FORMAT_VERSION:
        raise ValueError(f"not a version-{FORMAT_VERSION} succinct GKR proof")
    ctx = field_ctx(obj["field"])
    return SuccinctProof(
        circuit_output=[int(v, 16) for v in obj["circuit_output"]],
        claimed_sum=int(obj["claimed_sum"], 16),
        sumcheck_proofs=[_sumcheck_prover_proof_from(ctx, p) for p in obj["sumcheck_proofs"]],
        wb_evaluations=[int(v, 16) for v in obj["wb_evaluations"]],
        wc_evaluations=[int(v, 16) for v in obj["wc_evaluations"]],
        input_polynomial_commitment=_unpoint(obj["input_commitment"]),
        input_rb_proof=_kzg_proof_from(obj["input_rb_proof"]),
        input_rc_proof=_kzg_proof_from(obj["input_rc_proof"]),
    )
