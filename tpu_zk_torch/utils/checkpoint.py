"""Mid-proof checkpoint and resume for long-running provers.

Counterpart of :mod:`tpu_zk.utils.checkpoint`, in its format: a blob is an
npz of numeric arrays with one JSON metadata entry (format version 2; no
pickle either way, so a blob from untrusted storage can at worst fail to
parse).  Limb tables are saved as ``uint32`` arrays of 16-bit limbs
(Montgomery form), the same integers as this package's int32 limbs, and the
transcript as its snapshot bytes (``Keccak256.snapshot``, byte-equal to
``tpu_zk``'s), so a blob written by either package loads in the other and
finishes to the same proof.  A resumed proof is bit-identical to one made
in a single call.
"""

from __future__ import annotations

import io
import json

import numpy as np
import torch

from ..fields.arith import field_ctx
from ..gkr import sparse
from ..poly.multilinear import MultilinearPolynomial, sum_halves
from ..sumcheck import basic
from ..sumcheck.basic import SumcheckProof
from ..transcript.fiat_shamir import Transcript
from .convert import limbs_from_numpy, limbs_to_numpy

CHECKPOINT_FORMAT_VERSION = 2  # npz + JSON (``tpu_zk``'s v1 was pickle, which neither package reads)


def _dump_state(arrays: dict, meta: dict) -> bytes:
    buf = io.BytesIO()
    meta = dict(meta, format_version=CHECKPOINT_FORMAT_VERSION)
    np.savez(buf, __meta__=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8), **arrays)
    return buf.getvalue()


def _load_state(blob: bytes) -> tuple[dict, dict]:
    """(arrays, metadata) of a blob; ValueError for anything but an npz+JSON
    blob of a version this module reads."""
    try:
        with np.load(io.BytesIO(blob), allow_pickle=False) as z:
            meta = json.loads(bytes(z["__meta__"].tobytes()).decode())
            arrays = {k: z[k] for k in z.files if k != "__meta__"}
    except Exception as e:
        raise ValueError("unreadable checkpoint: not a v2 npz+JSON blob (pickle blobs are not loadable; "
                         "re-create the checkpoint)") from e
    version = meta.get("format_version", 1)
    if version != CHECKPOINT_FORMAT_VERSION:
        raise ValueError(f"checkpoint format v{version}; this package reads v{CHECKPOINT_FORMAT_VERSION}")
    return arrays, meta


class CheckpointableSumcheckProver:
    """Basic-sumcheck prover that can pause and resume between rounds; its
    proof and transcript are bit-identical to ``sumcheck.basic.Prover``'s.
    Each round is ``basic.Prover``'s ``fused=False`` round
    (:func:`tpu_zk_torch.sumcheck.basic.host_round`); the table lives on its
    device.  Like that loop, the last round folds nothing, so a blob saved
    after it holds the two-entry table where ``tpu_zk``'s holds one entry
    (neither is read again)."""

    def __init__(self, polynomial: MultilinearPolynomial):
        self.ctx = polynomial.ctx
        self.initial_polynomial = polynomial
        self.initial_claimed_sum = polynomial.sum()
        self.transcript = Transcript()
        self.transcript.append(polynomial.convert_to_bytes())
        self.transcript.append(self.ctx.to_bytes_be(self.initial_claimed_sum))
        self.current = polynomial.table
        self.round = 0
        self.round_polys: list[MultilinearPolynomial] = []
        self._univ_m = None  # the current table's half-sums: the next round univariate

    @property
    def total_rounds(self) -> int:
        return self.initial_polynomial.number_of_variables

    def step(self) -> None:
        """Run one sumcheck round."""
        if self.round >= self.total_rounds:
            raise ValueError("every round has run")
        ctx = self.ctx
        if self._univ_m is None:
            self._univ_m = sum_halves(ctx, self.current)
        self.round_polys.append(MultilinearPolynomial(ctx, self._univ_m))
        self.current, self._univ_m = basic.host_round(ctx, self.transcript, self.current, self._univ_m,
                                                      self.round < self.total_rounds - 1)
        self.round += 1

    def run(self, max_rounds: int | None = None) -> SumcheckProof | None:
        """Run up to ``max_rounds`` rounds; returns the proof when complete."""
        budget = max_rounds if max_rounds is not None else self.total_rounds
        while self.round < self.total_rounds and budget > 0:
            self.step()
            budget -= 1
        if self.round == self.total_rounds:
            return SumcheckProof(
                initial_polynomial=self.initial_polynomial,
                initial_claimed_sum=self.initial_claimed_sum,
                round_univariate_polynomials=self.round_polys,
            )
        return None

    def save(self) -> bytes:
        arrays = {
            "initial_table": limbs_to_numpy(self.initial_polynomial.table),
            "current_table": limbs_to_numpy(self.current),
            "transcript": np.frombuffer(self.transcript.snapshot(), dtype=np.uint8),
        }
        for i, u in enumerate(self.round_polys):
            arrays[f"round_poly_{i}"] = limbs_to_numpy(u.table)
        meta = {
            "field": self.ctx.name,
            "round": self.round,
            "n_round_polys": len(self.round_polys),
            "initial_claimed_sum": hex(self.initial_claimed_sum),
        }
        return _dump_state(arrays, meta)

    @classmethod
    def load(cls, blob: bytes, device=None) -> "CheckpointableSumcheckProver":
        """Resume from a blob, on ``device`` (the package's default if none)."""
        arrays, meta = _load_state(blob)
        ctx = field_ctx(meta["field"])
        self = cls.__new__(cls)
        self.ctx = ctx
        self.initial_polynomial = MultilinearPolynomial(ctx, limbs_from_numpy(arrays["initial_table"], device))
        self.initial_claimed_sum = int(meta["initial_claimed_sum"], 16)
        self.transcript = Transcript.from_snapshot(arrays["transcript"].tobytes())
        self.current = limbs_from_numpy(arrays["current_table"], device)
        self.round = meta["round"]
        self.round_polys = [MultilinearPolynomial(ctx, limbs_from_numpy(arrays[f"round_poly_{i}"], device))
                            for i in range(meta["n_round_polys"])]
        self._univ_m = None
        return self


class CheckpointableSparseGkrProver:
    """Layer-granular pause and resume for the linear-time GKR prover
    (:class:`tpu_zk_torch.gkr.sparse.LayerProver`); its proof is
    bit-identical to ``gkr.sparse.prove``'s.

    A blob holds the protocol state at a layer boundary: the transcript
    bytes, alpha and beta, the previous layer's rb and rc, the running claim
    and the layer proofs so far, with the inputs.  The circuit's tables are
    evaluated again from the inputs on load (one pass on the device) rather
    than saved: at 2^24 inputs they are gigabytes.
    """

    def __init__(self, circuit, inputs, device=None, fused: bool = True):
        ctx = circuit.ctx
        self._inputs_table = inputs if isinstance(inputs, torch.Tensor) else ctx.array(list(inputs), device=device)
        self._prover = sparse.LayerProver(circuit, circuit.evaluate(self._inputs_table, materialize=False),
                                          fused=fused)

    @property
    def layer(self) -> int:
        return self._prover.layer

    @property
    def total_layers(self) -> int:
        return len(self._prover.circuit.layers)

    def step(self) -> None:
        """Prove one layer (two-phase sparse sumcheck and claim fold)."""
        if self._prover.done:
            raise ValueError("every layer is proved")
        self._prover.step()

    def run(self, max_layers: int | None = None):
        """Prove up to ``max_layers`` more layers; the Proof when complete."""
        budget = max_layers if max_layers is not None else self.total_layers
        while not self._prover.done and budget > 0:
            self.step()
            budget -= 1
        return self._prover.proof() if self._prover.done else None

    def save(self) -> bytes:
        meta, transcript = self._prover.state()
        arrays = {
            "inputs": limbs_to_numpy(self._inputs_table),
            "transcript": np.frombuffer(transcript, dtype=np.uint8),
        }
        return _dump_state(arrays, {"field": self._prover.ctx.name, **meta})

    @classmethod
    def load(cls, circuit, blob: bytes, device=None, fused: bool = True) -> "CheckpointableSparseGkrProver":
        """Resume ``circuit``'s prove from a blob, on ``device`` (the
        package's default if none)."""
        arrays, meta = _load_state(blob)
        ctx = field_ctx(meta["field"])
        if circuit.ctx != ctx:
            raise ValueError(f"checkpoint of a {ctx.name} prove, circuit over {circuit.ctx.name}")
        self = cls.__new__(cls)
        self._inputs_table = limbs_from_numpy(arrays["inputs"], device)
        ev = circuit.evaluate(self._inputs_table, materialize=False)
        self._prover = sparse.LayerProver.from_state(circuit, ev, meta, arrays["transcript"].tobytes(), fused=fused)
        return self
