"""GKR proofs of the tree-sum circuit through the program's public entries:
``sparse.prove_succinct`` with the inputs committed by multilinear KZG
(traffic ``commit_inputs: true``) or ``sparse.prove`` with public inputs.

Configuration keys: ``circuit`` and ``gate`` (only ``tree_sum`` with ``add``
gates, the circuit the reference's wiring knows), ``field``, ``curve``,
``depth`` (2^depth inputs, depth layers).  A statement is a table of 2^depth values made from
the seed, handed to the program as the Montgomery limbs it takes and to the
reference as the same limbs.
"""

from __future__ import annotations

import torch

from tpu_zk_torch.circuit.layered import tree_sum_circuit
from tpu_zk_torch.fields.arith import field_ctx
from tpu_zk_torch.gkr import sparse
from tpu_zk_torch.kzg.trusted_setup import TrustedSetup

from ..inputs import field_values, uniform_rows
from ..reference import gkr as ref
from ..reference.bn254 import MODULI
from ..reference.field import Field


class Entry:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        if (config["circuit"], config["gate"]) != ("tree_sum", "add"):
            raise ValueError(f"the gkr entry proves the tree of ADD gates only, not {config['circuit']!r} "
                             f"with {config['gate']!r} gates")
        self.depth = config["depth"]
        self.device = torch.device(device)
        self.seed = seed
        self.ctx = field_ctx(config["field"])
        self.p = MODULI[config["field"]]
        self.commit = traffic["commit_inputs"]
        self.circuit = tree_sum_circuit(self.ctx, self.depth)
        self.taus = field_values(self.p, self.depth, seed, "taus") if self.commit else None
        self.setup = (TrustedSetup.initialize_setup(config["curve"], self.taus, device=self.device)
                      if self.commit else None)

    def inputs(self, k: int) -> torch.Tensor:
        return uniform_rows(self.p, 1 << self.depth, self.seed, k, self.device)

    def prove(self, table: torch.Tensor):
        if self.commit:
            return sparse.prove_succinct(self.circuit, table, self.setup)
        return sparse.prove(self.circuit, table)

    @staticmethod
    def plain(proof) -> dict:
        out = {
            "output": list(proof.circuit_output),
            "claimed_sum": proof.claimed_sum,
            "layers": [{"claimed_sum": lp.claimed_sum,
                        "polys": [list(u.coefficients) for u in lp.round_univariate_polynomials],
                        "challenges": list(lp.random_challenges)} for lp in proof.sumcheck_proofs],
            "wb": list(proof.wb_evaluations),
            "wc": list(proof.wc_evaluations),
        }
        if hasattr(proof, "input_polynomial_commitment"):
            point = proof.input_polynomial_commitment
            out["commitment"] = None if point is None else tuple(point)
            out["openings"] = [{"evaluation": o.evaluation,
                                "points": [None if q is None else tuple(q) for q in o.proofs]}
                               for o in (proof.input_rb_proof, proof.input_rc_proof)]
        return out

    def unreduced(self, plain: dict) -> dict:
        """The control: every field element of the proof left as v + p."""
        p = self.p
        out = dict(plain, output=[v + p for v in plain["output"]], claimed_sum=plain["claimed_sum"] + p,
                   wb=[v + p for v in plain["wb"]], wc=[v + p for v in plain["wc"]])
        out["layers"] = [{"claimed_sum": lp["claimed_sum"] + p, "polys": [[c + p for c in u] for u in lp["polys"]],
                          "challenges": [r + p for r in lp["challenges"]]} for lp in plain["layers"]]
        if "openings" in plain:
            out["openings"] = [dict(o, evaluation=o["evaluation"] + p) for o in plain["openings"]]
        return out

    def close(self) -> None:
        self.setup = self.circuit = None

    def reference(self, k: int):
        """The reference's judge of proofs of statement k: plain proof -> Tally."""
        F = Field(self.p, self.device)
        table = F.from_montgomery(F.from_rows(self.inputs(k)))
        st = ref.Statement(F, table, self.taus)
        return lambda plain: ref.check(st, plain, self.depth, self.commit)
