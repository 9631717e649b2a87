"""Linear-time (Libra-style) GKR prover and verifier over sparse wiring,
plain and succinct (inputs committed with multilinear KZG).

Counterpart of :mod:`tpu_zk.gkr.sparse` (prove, verify, prove_succinct,
verify_succinct) and of :mod:`tpu_zk.gkr.fused_sparse`'s ``prove`` and
``prove_succinct``, which emit the same bytes: one prover serves both.  Each
layer's sumcheck over (b, c) runs in two phases, each over
``s = log2(width)`` variables, with bookkeeping tables of size ``width``
built from the sparse gate list in O(gates) device work (eq tables, gathers,
one exact segment sum per phase):

Phase 1 (variables b):   sum_c f(b,c) = w(b)*(A1(b) + M1(b)) + A2(b)
    A1[l] += W_out[g]             (add gates)     A1 = sum_c add(.,b,c)
    A2[l] += W_out[g]*w[r_g]      (add gates)     A2 = sum_c add(.,b,c) w(c)
    M1[l] += W_out[g]*w[r_g]      (mul gates)     M1 = sum_c mul(.,b,c) w(c)
Phase 2 (variables c, b* fixed):
         f(b*,c) = A'(c)*(w(b*) + w(c)) + (M'(c)*w(b*)) * w(c)
    A'[r] += W_out[g]*eq(b*, l_g)  (add gates),  M' likewise (mul gates)

with ``W_out[g] = eq(ra, out_g)`` for layer 0 and
``alpha*eq(rb, out_g) + beta*eq(rc, out_g)`` below it.

Unlike ``tpu_zk``'s TPU prover (``fused_sparse._drive_layers``), this one
has no pool of compiled device programs.  With ``fused=True`` (the default)
each phase's rounds run on the device sponge (:mod:`tpu_zk_torch.sumcheck.fused`,
one K7 launch a round) and the host reads the phase's coefficients and
challenges once at its end; with ``fused=False`` each round copies its
degree+1 sums to the host and the host transcript squeezes the challenge.
w(b*) and w(rc) are read from the fully folded working sets (as
``fused_sparse._layer_small`` does) instead of evaluating the layer's MLE
again.
"""

from __future__ import annotations

import torch

from ..circuit.layered import Circuit, Layer
from ..fields import arith
from ..fields.arith import FieldCtx
# tpu_zk.gkr.sparse's public name; this module calls arith.mont_segment_sum, which gkr/breakdown.py wraps
from ..fields.arith import mont_segment_sum  # noqa: F401
from ..kzg import multilinear_kzg
from ..kzg.trusted_setup import TrustedSetup
from ..poly.composed import SumPolynomial
from ..poly.multilinear import MultilinearPolynomial
from ..poly.univariate import DenseUnivariatePolynomial
from ..sumcheck import gkr_sumcheck
from ..transcript.fiat_shamir import Transcript
from .protocol import Proof, _w0_padded
from .succinct import SuccinctProof

# ---------------------------------------------------------------------------
# device building blocks
# ---------------------------------------------------------------------------


def eq_table(ctx: FieldCtx, challenges: list[int], device) -> torch.Tensor:
    """[2^k, L] Montgomery eq(r, x) over the hypercube; variable 0 is the
    most significant index bit (the fold convention of ``poly.multilinear``).
    One K1 launch per variable."""
    t = ctx.one_mont(device)[None]
    if not challenges:
        return t
    points = ctx.array([v for r in challenges for v in (1 - r, r)], device=device).view(-1, 2, ctx.L)
    for i in range(points.shape[0]):
        # the new variable is less significant than every one before it
        t = arith.mont_mul(ctx, t[:, None, :], points[i]).reshape(-1, ctx.L)
    return t


def _out_weights(ctx: FieldCtx, layer_index: int, outs: torch.Tensor, ra: int, alpha: int, beta: int,
                 rb_values: list[int], rc_values: list[int]) -> torch.Tensor:
    """W_out gathered at each gate's output index: the sparse form of the
    dense pipeline's folded add_i/mul_i 'a' variables."""
    return _out_weight_table(ctx, layer_index, ra, alpha, beta, rb_values, rc_values, outs.device)[outs]


def _out_weight_table(ctx: FieldCtx, layer_index: int, ra: int, alpha: int, beta: int, rb_values: list[int],
                      rc_values: list[int], device) -> torch.Tensor:
    """W_out at every output index: eq(ra, .) for layer 0, else
    alpha eq(rb, .) + beta eq(rc, .)."""
    if layer_index == 0:
        return eq_table(ctx, [ra], device)  # the layer-0 output variable is 1 bit
    a = arith.mont_mul(ctx, eq_table(ctx, rb_values, device), ctx.scalar(alpha, device=device))
    b = arith.mont_mul(ctx, eq_table(ctx, rc_values, device), ctx.scalar(beta, device=device))
    return arith.add(ctx, a, b)


def _phase1_tables(ctx: FieldCtx, layer: Layer, w_table: torch.Tensor, w_out: torch.Tensor):
    """(A1 + M1, A2), each [S, L], from the sparse gate list: one segment sum
    of both tables' per-gate terms."""
    lefts, rights, _, is_add = layer.on(w_table.device)
    wr = arith.mont_mul(ctx, w_out, w_table[rights])  # W_out * w(c) per gate
    terms = torch.stack([torch.where(is_add, w_out, wr), torch.where(is_add, wr, 0)], dim=1)
    t = arith.mont_segment_sum(ctx, terms, lefts, w_table.shape[0])
    return t[:, 0], t[:, 1]


def _phase2_tables(ctx: FieldCtx, layer: Layer, w_out: torch.Tensor, b_star: list[int], size: int):
    """(A', M'), each [size, L], with eq(b*, left) folded into the gate weights."""
    lefts, rights, _, is_add = layer.on(w_out.device)
    w_eq = arith.mont_mul(ctx, w_out, eq_table(ctx, b_star, w_out.device)[lefts])
    terms = torch.stack([torch.where(is_add, w_eq, 0), torch.where(is_add, 0, w_eq)], dim=1)
    t = arith.mont_segment_sum(ctx, terms, rights, size)
    return t[:, 0], t[:, 1]


# ---------------------------------------------------------------------------
# protocol
# ---------------------------------------------------------------------------


def _layer_sumcheck(ctx: FieldCtx, layer: Layer, w_table: torch.Tensor, w_out: torch.Tensor,
                    claimed_sum: int, transcript: Transcript, fused: bool = True):
    """One layer's (b, c) sumcheck in two phases.  Returns the merged proof
    (the dense pipeline's single 2s-variable sumcheck, byte for byte) and
    the Montgomery [L] values w(b*) and w(rc)."""
    S = w_table.shape[0]
    if S & (S - 1):
        raise ValueError(f"layer table of {S} entries: GKR needs a power of two")
    a1m1, a2 = _phase1_tables(ctx, layer, w_table, w_out)
    ones = ctx.one_mont(w_table.device).expand(S, ctx.L)
    h1 = SumPolynomial(ctx, torch.stack([torch.stack([w_table, a1m1]), torch.stack([a2, ones])]))
    ph1, done1 = gkr_sumcheck.prove_and_fold(h1, claimed_sum, transcript, fused)
    wb_m = done1.stacked[0, 0, 0]  # w folded at every phase-1 challenge: w(b*)

    a_p, m_p = _phase2_tables(ctx, layer, w_out, ph1.random_challenges, S)
    w_plus = arith.add(ctx, w_table, wb_m)  # w(b*) + w(c) elementwise
    m_scaled = arith.mont_mul(ctx, m_p, wb_m)  # M'(c) * w(b*)
    h2 = SumPolynomial(ctx, torch.stack([torch.stack([a_p, w_plus]), torch.stack([m_scaled, w_table])]))
    ph2, done2 = gkr_sumcheck.prove_and_fold(h2, claimed_sum, transcript, fused, absorb_claim=False)
    wc_m = done2.stacked[1, 1, 0]  # w(rc)

    proof = gkr_sumcheck.SumcheckProverProof(
        claimed_sum=claimed_sum,
        round_univariate_polynomials=ph1.round_univariate_polynomials + ph2.round_univariate_polynomials,
        random_challenges=ph1.random_challenges + ph2.random_challenges,
    )
    return proof, wb_m, wc_m


class LayerProver:
    """A GKR prove over an evaluated circuit, one layer a :meth:`step`: the
    transcript, the layer proofs, the wb/wc evaluations, alpha, beta, the
    last layer's rb and rc, the running claim and the next layer's index.

    Plain GKR stops recording rb and rc after the next-to-last layer; the
    succinct protocol (``succinct_gkr_protocol.rs:119-126``) also keeps those
    of the *last* layer, the points at which the input commitment is opened.
    Both append and absorb wb/wc for every layer but the last.  The state
    between two steps (:meth:`state`, :meth:`from_state`) is what
    :mod:`tpu_zk_torch.utils.checkpoint` saves.
    """

    def __init__(self, circuit: Circuit, ev, succinct: bool = False, fused: bool = True):
        self.circuit = circuit
        self.ctx = ctx = circuit.ctx
        self.ev = ev
        self.succinct = succinct
        self.fused = fused
        self.transcript = Transcript()
        self.layer_proofs = []
        self.wb_evaluations: list[int] = []
        self.wc_evaluations: list[int] = []
        self.alpha = self.beta = 0
        self.rb_values: list[int] = []
        self.rc_values: list[int] = []
        self.layer = 0
        self.output = ev.output
        w0_polynomial = _w0_padded(ctx, ev.output, ev.layer_tables[-1].device)
        self.transcript.append(w0_polynomial.convert_to_bytes())
        self.random_challenge_a = self.transcript.random_challenge_as_field_element(ctx)
        self.claimed_sum = w0_polynomial.evaluate([self.random_challenge_a])

    @property
    def done(self) -> bool:
        return self.layer == len(self.circuit.layers)

    def step(self) -> None:
        """Prove the next layer and fold its claims into the next one's."""
        ctx, layer_index = self.ctx, self.layer
        sumcheck_proof, wb_m, wc_m = self._layer_sumcheck(layer_index)
        self.layer_proofs.append(sumcheck_proof)
        last = layer_index == len(self.circuit.layers) - 1

        if self.succinct or not last:
            sumcheck_challenges = sumcheck_proof.random_challenges
            middle = len(sumcheck_challenges) // 2
            self.rb_values = sumcheck_challenges[:middle]
            self.rc_values = sumcheck_challenges[middle:]
        if not last:
            wb_evaluation, wc_evaluation = ctx.to_ints(torch.stack([wb_m, wc_m]))
            self.wb_evaluations.append(wb_evaluation)
            self.wc_evaluations.append(wc_evaluation)

            self.transcript.append(ctx.to_bytes_be(wb_evaluation))
            self.alpha = self.transcript.random_challenge_as_field_element(ctx)
            self.transcript.append(ctx.to_bytes_be(wc_evaluation))
            self.beta = self.transcript.random_challenge_as_field_element(ctx)
            self.claimed_sum = (self.alpha * wb_evaluation + self.beta * wc_evaluation) % ctx.p
        self.layer += 1
        if self.done:
            self.ev = None  # the layer tables: no step reads them again

    def _layer_sumcheck(self, layer_index: int):
        """The layer's two-phase sumcheck: (proof, w(b*), w(rc))."""
        layer = self.circuit.layers[layer_index]
        device = self.ev.layer_tables[-1].device
        w_out = _out_weights(self.ctx, layer_index, layer.on(device)[2], self.random_challenge_a, self.alpha,
                             self.beta, self.rb_values, self.rc_values)
        return _layer_sumcheck(self.ctx, layer, self.ev.layer_tables[layer_index + 1], w_out, self.claimed_sum,
                               self.transcript, self.fused)

    def state(self) -> tuple[dict, bytes]:
        """The protocol state between two steps: JSON-ready values (field
        elements as hex strings, under ``tpu_zk``'s checkpoint keys) and the
        transcript's snapshot bytes."""
        hexes = lambda values: [hex(v) for v in values]  # noqa: E731
        meta = {
            "layer": self.layer,
            "proofs": [{"claimed_sum": hex(p.claimed_sum),
                        "coeffs": [hexes(q.coefficients) for q in p.round_univariate_polynomials],
                        "challenges": hexes(p.random_challenges)} for p in self.layer_proofs],
            "wb": hexes(self.wb_evaluations),
            "wc": hexes(self.wc_evaluations),
            "alpha": hex(self.alpha),
            "beta": hex(self.beta),
            "rb": hexes(self.rb_values),
            "rc": hexes(self.rc_values),
            "ra": hex(self.random_challenge_a),
            "claimed_sum": hex(self.claimed_sum),
        }
        return meta, self.transcript.snapshot()

    @classmethod
    def from_state(cls, circuit: Circuit, ev, meta: dict, transcript: bytes, succinct: bool = False,
                   fused: bool = True) -> "LayerProver":
        """The prover at the layer boundary that :meth:`state` gave ``meta``
        and ``transcript`` for; ``ev`` is the circuit evaluated on the same
        inputs."""
        ctx = circuit.ctx
        ints = lambda values: [int(v, 16) for v in values]  # noqa: E731
        self = cls(circuit, ev, succinct, fused)
        self.transcript = Transcript.from_snapshot(transcript)
        self.layer_proofs = [
            gkr_sumcheck.SumcheckProverProof(
                claimed_sum=int(p["claimed_sum"], 16),
                round_univariate_polynomials=[DenseUnivariatePolynomial(ctx, ints(c)) for c in p["coeffs"]],
                random_challenges=ints(p["challenges"]),
            )
            for p in meta["proofs"]
        ]
        self.wb_evaluations, self.wc_evaluations = ints(meta["wb"]), ints(meta["wc"])
        self.alpha, self.beta = int(meta["alpha"], 16), int(meta["beta"], 16)
        self.rb_values, self.rc_values = ints(meta["rb"]), ints(meta["rc"])
        self.random_challenge_a = int(meta["ra"], 16)
        self.claimed_sum = int(meta["claimed_sum"], 16)
        self.layer = meta["layer"]
        if self.done:
            self.ev = None
        return self

    def proof(self) -> Proof:
        return Proof(
            circuit_output=self.output,
            claimed_sum=self.claimed_sum,
            sumcheck_proofs=self.layer_proofs,
            wb_evaluations=self.wb_evaluations,
            wc_evaluations=self.wc_evaluations,
        )


def _prove_layers(circuit: Circuit, ev, succinct: bool, fused: bool = True) -> LayerProver:
    """Every layer's sumcheck over an evaluated circuit: the finished
    :class:`LayerProver`."""
    state = LayerProver(circuit, ev, succinct, fused)
    while not state.done:
        state.step()
    return state


def prove(circuit: Circuit, inputs, device=None, fused: bool = True) -> Proof:
    """Linear-time GKR prove; the same Proof and bytes as ``tpu_zk``'s
    ``sparse.prove`` and ``fused_sparse.prove``.

    ``inputs`` is a Montgomery ``[N, L]`` tensor (proved on its device, the
    practical form at 2^20+ inputs) or a host int list (proved on
    ``device``, by default the package's default device).  ``fused`` runs
    each layer's sumcheck rounds on the device sponge (the default, as in
    ``tpu_zk``); ``fused=False`` syncs with the host transcript every round.
    The alpha/beta squeezes between layers are on the host transcript either
    way, as in ``tpu_zk``.
    """
    ev = circuit.evaluate(inputs, materialize=False, device=device)
    return _prove_layers(circuit, ev, False, fused).proof()


def prove_succinct(circuit: Circuit, inputs, trusted_setup: TrustedSetup, fused: bool = True) -> SuccinctProof:
    """Succinct GKR (KZG-committed inputs) on the linear-time prover: the
    same proof and transcript bytes as ``tpu_zk``'s ``sparse.prove_succinct``
    and ``fused_sparse.prove_succinct`` (``gkr/src/succinct_gkr_protocol.rs``
    :35-169).

    ``inputs`` is a Montgomery ``[N, L]`` tensor on the setup's device or a
    host int list (placed there).  The commitment is made before the layers
    and the layers' working sets are gone before the two openings, so the
    three never share the device's memory.
    """
    ctx = circuit.ctx
    table = inputs if isinstance(inputs, torch.Tensor) else ctx.array(list(inputs), device=trusted_setup.curve.device)
    input_polynomial = MultilinearPolynomial(ctx, table)
    input_commitment = multilinear_kzg.commit_to_polynomial(input_polynomial, trusted_setup)

    layers = _prove_layers(circuit, circuit.evaluate(table, materialize=False), True, fused)
    return SuccinctProof(
        circuit_output=layers.output,
        claimed_sum=layers.claimed_sum,
        sumcheck_proofs=layers.layer_proofs,
        wb_evaluations=layers.wb_evaluations,
        wc_evaluations=layers.wc_evaluations,
        input_polynomial_commitment=input_commitment,
        input_rb_proof=multilinear_kzg.open_and_prove(input_polynomial, trusted_setup, layers.rb_values),
        input_rc_proof=multilinear_kzg.open_and_prove(input_polynomial, trusted_setup, layers.rc_values),
    )


def _sparse_wiring_eval(ctx: FieldCtx, layer: Layer, w_out: torch.Tensor, bc_challenges: list[int]):
    """(add_eval, mul_eval) of the folded wiring at the sumcheck point,
    straight from the gate list: O(width + gates), never a dense table."""
    device = w_out.device
    lefts, rights, _, is_add = layer.on(device)
    half = len(bc_challenges) // 2
    eq_b = eq_table(ctx, bc_challenges[:half], device)[lefts]
    eq_c = eq_table(ctx, bc_challenges[half:], device)[rights]
    per_gate = arith.mont_mul(ctx, arith.mont_mul(ctx, w_out, eq_b), eq_c)
    terms = torch.stack([torch.where(is_add, per_gate, 0), torch.where(is_add, 0, per_gate)])
    add_eval, mul_eval = arith.lazy_to_ints(ctx, terms.sum(dim=1, dtype=torch.int64))
    return add_eval, mul_eval


def _layer_vars(circuit: Circuit, layer_index: int, n_inputs: int) -> int | None:
    """log2 of the table a layer reads (its b and c variables each), or None
    when that table's size is not a power of two."""
    last = layer_index == len(circuit.layers) - 1
    size = n_inputs if last else circuit.layers[layer_index + 1].width
    return None if size & (size - 1) else size.bit_length() - 1


def _verify_layers(circuit: Circuit, proof, n_inputs: int, device, input_poly: MultilinearPolynomial | None):
    """Every layer's sumcheck check.  Returns the last layer's (rb, rc), or
    None if the proof is rejected.

    With ``input_poly`` (plain GKR) the last layer's claim is checked against
    the inputs' MLE at (rb, rc).  Without it (succinct GKR) the last layer's
    wiring claim is not checked and zero is absorbed for its wb and wc, as
    the reference verifier does (``succinct_gkr_protocol.rs:172-284``); the
    caller checks the two KZG openings at (rb, rc) instead.
    """
    ctx = circuit.ctx
    n_layers = len(circuit.layers)
    if (len(proof.sumcheck_proofs) != n_layers or len(proof.wb_evaluations) != n_layers - 1
            or len(proof.wc_evaluations) != n_layers - 1):
        return None

    transcript = Transcript()
    alpha = beta = 0
    prev_challenges: list[int] = []

    w0_polynomial = _w0_padded(ctx, proof.circuit_output, device)
    transcript.append(w0_polynomial.convert_to_bytes())
    random_challenge_a = transcript.random_challenge_as_field_element(ctx)
    claimed_sum = w0_polynomial.evaluate([random_challenge_a])

    for layer_index, layer in enumerate(circuit.layers):
        s = _layer_vars(circuit, layer_index, n_inputs)
        layer_proof = proof.sumcheck_proofs[layer_index]
        if s is None or len(layer_proof.round_univariate_polynomials) != 2 * s:
            return None
        if claimed_sum != layer_proof.claimed_sum % ctx.p:
            return None
        verify_result = gkr_sumcheck.verify(layer_proof, transcript, ctx)
        if not verify_result.is_proof_valid:
            return None
        sumcheck_challenges = verify_result.random_challenges

        last = layer_index == n_layers - 1
        wb_evaluation = wc_evaluation = 0
        if not last:
            wb_evaluation = proof.wb_evaluations[layer_index]
            wc_evaluation = proof.wc_evaluations[layer_index]
        elif input_poly is not None:
            wb_evaluation = input_poly.evaluate(sumcheck_challenges[:s])
            wc_evaluation = input_poly.evaluate(sumcheck_challenges[s:])

        if not last or input_poly is not None:
            mid = len(prev_challenges) // 2
            w_out = _out_weights(ctx, layer_index, layer.on(device)[2], random_challenge_a, alpha, beta,
                                 prev_challenges[:mid], prev_challenges[mid:])
            add_r, mul_r = _sparse_wiring_eval(ctx, layer, w_out, sumcheck_challenges)
            expected_claim = (add_r * (wb_evaluation + wc_evaluation)
                              + mul_r * (wb_evaluation * wc_evaluation)) % ctx.p
            if expected_claim != verify_result.last_claimed_sum:
                return None

        prev_challenges = list(sumcheck_challenges)
        transcript.append(ctx.to_bytes_be(wb_evaluation))
        alpha = transcript.random_challenge_as_field_element(ctx)
        transcript.append(ctx.to_bytes_be(wc_evaluation))
        beta = transcript.random_challenge_as_field_element(ctx)
        claimed_sum = (alpha * wb_evaluation + beta * wc_evaluation) % ctx.p

    mid = len(prev_challenges) // 2
    return prev_challenges[:mid], prev_challenges[mid:]


def verify(circuit: Circuit, proof: Proof, inputs, device=None) -> bool:
    """GKR verify with O(gates) wiring evaluations (no dense 2^(3i+2) tables).

    ``inputs`` is a Montgomery ``[N, L]`` tensor (checked on its device) or a
    host int list (checked on ``device``, by default the package's default
    device), N a power of two.  A proof whose shape does not fit the circuit
    is rejected."""
    ctx = circuit.ctx
    if isinstance(inputs, torch.Tensor):
        input_poly = MultilinearPolynomial(ctx, inputs)
    else:
        input_poly = MultilinearPolynomial.from_ints(ctx, list(inputs), device=device)
    table = input_poly.table
    return _verify_layers(circuit, proof, table.shape[0], table.device, input_poly) is not None


def verify_succinct(circuit: Circuit, proof: SuccinctProof, trusted_setup: TrustedSetup) -> bool:
    """Sparse-wiring verify of a succinct proof and the two KZG opening
    checks (``gkr/src/succinct_gkr_protocol.rs:172-284``), on the setup's
    device.  A proof whose shape does not fit the circuit and the setup is
    rejected."""
    n_vars = trusted_setup.num_vars
    openings = (proof.input_rb_proof, proof.input_rc_proof)
    if any(len(o.proofs) != n_vars for o in openings):
        return False
    points = _verify_layers(circuit, proof, 1 << n_vars, trusted_setup.curve.device, None)
    if points is None:
        return False
    return all(
        multilinear_kzg.verify(trusted_setup, proof.input_polynomial_commitment, point, opening)
        for point, opening in zip(points, openings)
    )
