"""The succinct GKR proof type: GKR with a multilinear-KZG commitment to the
input layer.

Counterpart of :mod:`tpu_zk.gkr.succinct`'s ``SuccinctProof`` (reference
``gkr/src/succinct_gkr_protocol.rs`` :22-32).  That module's dense
``prove_succinct``/``verify_succinct`` need the dense wiring tables, which
the port does not have; the linear-time pair is in :mod:`.sparse`.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..kzg.multilinear_kzg import MultilinearKZGProof
from ..sumcheck.gkr_sumcheck import SumcheckProverProof


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
