"""A low-degree extension and its FRI proof through the program's public
entries: the polynomial's coefficients zero-padded to the domain,
``NTT.forward`` to the codeword, then ``fri.prove`` on a fresh transcript.

Configuration keys: ``field``, ``domain_log2``, ``blowup_log2`` (the
polynomial has 2^(domain_log2 - blowup_log2) coefficients),
``final_size_log2`` and ``num_queries``.  A statement is the coefficient
table made from the seed, handed to the program as the Montgomery limbs it
takes and to the reference as the same limbs.
"""

from __future__ import annotations

import torch

from tpu_zk_torch.fri import fri
from tpu_zk_torch.ntt.ntt import NTT
from tpu_zk_torch.transcript.fiat_shamir import Transcript

from ..inputs import uniform_rows
from ..reference import fri as ref
from ..reference.bn254 import MODULI
from ..reference.field import Field


class Entry:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.cfg = config
        self.device = torch.device(device)
        self.seed = seed
        self.p = MODULI[config["field"]]
        self.log_n = config["domain_log2"]
        self.n_coeffs = 1 << (self.log_n - config["blowup_log2"])
        self.fri = fri.FriConfig(config["field"], self.log_n, final_size_log2=config["final_size_log2"],
                                 num_queries=config["num_queries"], blowup_log2=config["blowup_log2"])
        self.ntt = NTT(config["field"], self.log_n, device=self.device)

    def inputs(self, k: int) -> torch.Tensor:
        return uniform_rows(self.p, self.n_coeffs, self.seed, k, self.device)

    def prove(self, coeffs: torch.Tensor):
        padded = torch.zeros((1 << self.log_n, coeffs.shape[1]), dtype=coeffs.dtype, device=coeffs.device)
        padded[: coeffs.shape[0]] = coeffs
        return fri.prove(self.fri, self.ntt.forward(padded), Transcript())

    @staticmethod
    def plain(proof) -> dict:
        return {"roots": list(proof.roots), "final": list(proof.final_codeword),
                "queries": [[(q.index, q.value_lo, q.value_hi, list(q.path_lo), list(q.path_hi)) for q in rounds]
                            for rounds in proof.queries]}

    def unreduced(self, plain: dict) -> dict:
        """The control: every field element of the proof left as v + p."""
        p = self.p
        return dict(plain, final=[v + p for v in plain["final"]],
                    queries=[[(i, lo + p, hi + p, a, b) for i, lo, hi, a, b in rounds] for rounds in plain["queries"]])

    def close(self) -> None:
        self.fri = self.ntt = None

    def reference(self, k: int):
        """The reference's judge of proofs of statement k: plain proof -> Tally."""
        F = Field(self.p, self.device)
        coeffs = F.from_montgomery(F.from_rows(self.inputs(k)))
        want = ref.prove(F, coeffs, self.log_n, self.cfg["final_size_log2"], self.cfg["num_queries"])
        return lambda plain: ref.compare(plain, want)
