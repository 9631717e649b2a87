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

Unlike ``tpu_zk``'s TPU prover (``fused_sparse._drive_layers``), this one has no pool of fused device
programs and no device sponge: on a local card a host sync costs
microseconds, so each round copies its degree+1 sums to the host and the
host transcript squeezes the challenge.  w(b*) and w(rc) are read from the
fully folded working sets (as ``fused_sparse._layer_small`` does) instead of
evaluating the layer's MLE again.
"""

from __future__ import annotations

import torch

from ..circuit.layered import Circuit, Layer
from ..fields import arith
from ..fields.arith import FieldCtx
from ..kzg import multilinear_kzg
from ..kzg.trusted_setup import TrustedSetup
from ..poly.composed import SumPolynomial
from ..poly.multilinear import MultilinearPolynomial
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
    device = outs.device
    if layer_index == 0:
        return eq_table(ctx, [ra], device)[outs]  # the layer-0 output variable is 1 bit
    a = arith.mont_mul(ctx, eq_table(ctx, rb_values, device), ctx.scalar(alpha, device=device))
    b = arith.mont_mul(ctx, eq_table(ctx, rc_values, device), ctx.scalar(beta, device=device))
    return arith.add(ctx, a, b)[outs]


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
                    claimed_sum: int, transcript: Transcript):
    """One layer's (b, c) sumcheck in two phases.  Returns the merged proof
    (the dense pipeline's single 2s-variable sumcheck, byte for byte) and
    the Montgomery [L] values w(b*) and w(rc)."""
    S = w_table.shape[0]
    if S & (S - 1):
        raise ValueError(f"layer table of {S} entries: GKR needs a power of two")
    a1m1, a2 = _phase1_tables(ctx, layer, w_table, w_out)
    ones = ctx.one_mont(w_table.device).expand(S, ctx.L)
    h1 = SumPolynomial(ctx, torch.stack([torch.stack([w_table, a1m1]), torch.stack([a2, ones])]))
    ph1, done1 = gkr_sumcheck.prove_and_fold(h1, claimed_sum, transcript)
    wb_m = done1.stacked[0, 0, 0]  # w folded at every phase-1 challenge: w(b*)

    a_p, m_p = _phase2_tables(ctx, layer, w_out, ph1.random_challenges, S)
    w_plus = arith.add(ctx, w_table, wb_m)  # w(b*) + w(c) elementwise
    m_scaled = arith.mont_mul(ctx, m_p, wb_m)  # M'(c) * w(b*)
    h2 = SumPolynomial(ctx, torch.stack([torch.stack([a_p, w_plus]), torch.stack([m_scaled, w_table])]))
    ph2, done2 = gkr_sumcheck.prove_and_fold(h2, claimed_sum, transcript, absorb_claim=False)
    wc_m = done2.stacked[1, 1, 0]  # w(rc)

    proof = gkr_sumcheck.SumcheckProverProof(
        claimed_sum=claimed_sum,
        round_univariate_polynomials=ph1.round_univariate_polynomials + ph2.round_univariate_polynomials,
        random_challenges=ph1.random_challenges + ph2.random_challenges,
    )
    return proof, wb_m, wc_m


def _prove_layers(circuit: Circuit, ev, succinct: bool):
    """Every layer's sumcheck over an evaluated circuit.  Returns
    (claimed_sum, layer proofs, wb evaluations, wc evaluations, rb, rc).

    Plain GKR stops recording after the next-to-last layer; the succinct
    protocol (``succinct_gkr_protocol.rs:119-126``) also keeps rb and rc of
    the *last* layer, the points at which the input commitment is opened.
    Both append and absorb wb/wc for every layer but the last.
    """
    ctx = circuit.ctx
    device = ev.layer_tables[-1].device
    n_layers = len(circuit.layers)

    transcript = Transcript()
    layer_proofs = []
    wb_evaluations: list[int] = []
    wc_evaluations: list[int] = []
    alpha = beta = 0
    rb_values: list[int] = []
    rc_values: list[int] = []

    w0_polynomial = _w0_padded(ctx, ev.output, device)
    transcript.append(w0_polynomial.convert_to_bytes())
    random_challenge_a = transcript.random_challenge_as_field_element(ctx)
    claimed_sum = w0_polynomial.evaluate([random_challenge_a])

    for layer_index, layer in enumerate(circuit.layers):
        w_out = _out_weights(ctx, layer_index, layer.on(device)[2], random_challenge_a, alpha, beta,
                             rb_values, rc_values)
        sumcheck_proof, wb_m, wc_m = _layer_sumcheck(
            ctx, layer, ev.layer_tables[layer_index + 1], w_out, claimed_sum, transcript
        )
        layer_proofs.append(sumcheck_proof)
        last = layer_index == n_layers - 1

        if succinct or not last:
            sumcheck_challenges = sumcheck_proof.random_challenges
            middle = len(sumcheck_challenges) // 2
            rb_values = sumcheck_challenges[:middle]
            rc_values = sumcheck_challenges[middle:]
        if not last:
            wb_evaluation, wc_evaluation = ctx.to_ints(torch.stack([wb_m, wc_m]))
            wb_evaluations.append(wb_evaluation)
            wc_evaluations.append(wc_evaluation)

            transcript.append(ctx.to_bytes_be(wb_evaluation))
            alpha = transcript.random_challenge_as_field_element(ctx)
            transcript.append(ctx.to_bytes_be(wc_evaluation))
            beta = transcript.random_challenge_as_field_element(ctx)
            claimed_sum = (alpha * wb_evaluation + beta * wc_evaluation) % ctx.p

    return claimed_sum, layer_proofs, wb_evaluations, wc_evaluations, rb_values, rc_values


def prove(circuit: Circuit, inputs, device=None) -> Proof:
    """Linear-time GKR prove; the same Proof and bytes as ``tpu_zk``'s
    ``sparse.prove`` and ``fused_sparse.prove``.

    ``inputs`` is a Montgomery ``[N, L]`` tensor (proved on its device, the
    practical form at 2^20+ inputs) or a host int list (proved on
    ``device``, by default the package's default device).
    """
    ev = circuit.evaluate(inputs, materialize=False, device=device)
    claimed_sum, layer_proofs, wb_evaluations, wc_evaluations, _, _ = _prove_layers(circuit, ev, succinct=False)
    return Proof(
        circuit_output=ev.output,
        claimed_sum=claimed_sum,
        sumcheck_proofs=layer_proofs,
        wb_evaluations=wb_evaluations,
        wc_evaluations=wc_evaluations,
    )


def prove_succinct(circuit: Circuit, inputs, trusted_setup: TrustedSetup) -> SuccinctProof:
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

    ev = circuit.evaluate(table, materialize=False)
    output = ev.output
    claimed_sum, layer_proofs, wb_evaluations, wc_evaluations, rb_values, rc_values = _prove_layers(
        circuit, ev, succinct=True
    )
    del ev

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
