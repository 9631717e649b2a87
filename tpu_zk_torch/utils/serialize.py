"""Basic-sumcheck proof (de)serialization.

The JSON is byte for byte :func:`tpu_zk.utils.serialize.sumcheck_proof_to_json`'s:
canonical JSON with hex-encoded field elements, independent of limb layout
and device.
"""

from __future__ import annotations

import json

from ..fields.arith import field_ctx
from ..poly.multilinear import MultilinearPolynomial
from ..sumcheck.basic import SumcheckProof

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
