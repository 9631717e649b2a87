"""The GKR proof type, shared by the provers and verifiers.

Counterpart of :mod:`tpu_zk.gkr.protocol`'s ``Proof`` and ``_w0_padded``
(reference ``gkr/src/gkr_protocol.rs`` Proof :16-23, w0 padding :42-47).
The dense prove/verify pipeline of that module is not ported yet; the
linear-time prover and verifier are in :mod:`.sparse`.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..poly.multilinear import MultilinearPolynomial
from ..sumcheck.gkr_sumcheck import SumcheckProverProof


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
