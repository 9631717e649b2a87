"""Wiring-predicate MLEs (add_i / mul_i) for the dense GKR layer relation.

Counterpart of :mod:`tpu_zk.gkr.wiring`.  A layer's two wiring tables travel
as one ``[2, N, L]`` tensor (axis 0 = add/mul), so every fold is one K2
launch over both tables (two batch rows) and every scalar product one K1
launch.  The GKR layer relation

    f_r(b, c) = add_r(b, c) * (w(b) + w(c)) + mul_r(b, c) * (w(b) * w(c))

is kept factored as a 2-term SumPolynomial (:func:`layer_polynomial`), so the
sumcheck folds all four member tables a round in one launch.  Reference
parity: the free helpers of ``gkr/src/utils.rs`` (fbc assembly :8-21,
alpha/beta wiring fold :23-68, half-split evaluation :70-82, verifier claims
:84-135).
"""

from __future__ import annotations

import torch

from ..fields import arith
from ..fields.arith import FieldCtx
from ..poly.composed import ProductPolynomial, SumPolynomial, _point
from ..poly.multilinear import MultilinearPolynomial, fold


class WiringPair:
    """A layer's ``add_i`` / ``mul_i`` MLEs as one ``[2, N, L]`` table."""

    def __init__(self, ctx: FieldCtx, stacked: torch.Tensor):
        self.ctx = ctx
        self.stacked = stacked  # [2, N, L]

    # -- constructors ---------------------------------------------------------
    @classmethod
    def of(cls, add_i: MultilinearPolynomial, mul_i: MultilinearPolynomial) -> "WiringPair":
        """The pair of two separate tables (a copy of both); a circuit's own
        pair comes from :meth:`for_layer` without one."""
        return cls(add_i.ctx, torch.stack([add_i.table, mul_i.table]))

    @classmethod
    def for_layer(cls, circuit, layer_index: int, device=None) -> "WiringPair":
        return cls(circuit.ctx, circuit.wiring_table(layer_index, device))

    # -- batched table ops ----------------------------------------------------
    def fold_first_vars(self, points) -> "WiringPair":
        """Fold variable 0 at each point in turn: one K2 launch a point for
        both tables."""
        t = self.stacked
        for p in points:
            t = fold(self.ctx, t, 0, _point(self.ctx, p, t.device))
        return WiringPair(self.ctx, t)

    def linear_combine(self, alpha, other: "WiringPair", beta) -> "WiringPair":
        """``alpha * self + beta * other`` elementwise over the pair."""
        device = self.stacked.device
        a = arith.mont_mul(self.ctx, self.stacked, _point(self.ctx, alpha, device))
        b = arith.mont_mul(self.ctx, other.stacked, _point(self.ctx, beta, device))
        return WiringPair(self.ctx, arith.add(self.ctx, a, b))

    def alpha_beta_fold(self, alpha, beta, rb_values, rc_values) -> "WiringPair":
        """``alpha * pair(rb, ., .) + beta * pair(rc, ., .)``: how GKR reduces
        the two outstanding claims (at rb and rc) to one wiring pair for the
        next layer's sumcheck (``gkr/src/utils.rs:23-68``).

        ``len(rb) + len(rc)`` K2 launches, then two K1 and one K3.  The rb
        chain is done before the rc chain starts, so besides the pair only
        one chain's first two folds (half and a quarter of the pair) are
        live at a time.
        """
        return self.fold_first_vars(rb_values).linear_combine(alpha, self.fold_first_vars(rc_values), beta)

    def evaluate(self, points):
        """Fold everything; return canonical ints ``(add_i(r), mul_i(r))``."""
        vals = self.ctx.to_ints(self.fold_first_vars(points).stacked[:, 0, :])
        return int(vals[0]), int(vals[1])

    def split(self):
        return MultilinearPolynomial(self.ctx, self.stacked[0]), MultilinearPolynomial(self.ctx, self.stacked[1])


def gate_claim(ctx: FieldCtx, add_r: int, mul_r: int, wb: int, wc: int) -> int:
    """The GKR layer relation ``add_i(r)*(wb+wc) + mul_i(r)*(wb*wc)``."""
    return (add_r * (wb + wc) + mul_r * (wb * wc)) % ctx.p


def layer_polynomial(
    add_i_bc: MultilinearPolynomial,
    mul_i_bc: MultilinearPolynomial,
    w_b: MultilinearPolynomial,
    w_c: MultilinearPolynomial,
) -> SumPolynomial:
    """f(b,c) as a factored 2-term SumPolynomial (``gkr/src/utils.rs:8-21``):
    the ``|wb| x |wc|`` outer tables are one K3 and one K1 launch."""
    return SumPolynomial.from_products(
        [
            ProductPolynomial.from_mles([add_i_bc, w_b.tensor_add(w_c)]),
            ProductPolynomial.from_mles([mul_i_bc, w_b.tensor_mul(w_c)]),
        ]
    )


def split_half_evaluations(wb_poly: MultilinearPolynomial, wc_poly: MultilinearPolynomial, sumcheck_challenges):
    """The layer-below MLE at the b-half and the c-half of the sumcheck
    challenge point (``gkr/src/utils.rs:70-82``)."""
    half = len(sumcheck_challenges) // 2
    return wb_poly.evaluate(sumcheck_challenges[:half]), wc_poly.evaluate(sumcheck_challenges[half:])


def expected_layer_claim(
    circuit,
    layer_index: int,
    sumcheck_challenges,
    wb_evaluation: int,
    wc_evaluation: int,
    *,
    initial_random_challenge=None,
    previous_sumcheck_challenges=None,
    alpha=None,
    beta=None,
    device=None,
) -> int:
    """The verifier's recomputed claim for one GKR layer.

    Layer 0 (pass ``initial_random_challenge``): the wiring pair at
    ``(ra, r_bc)`` under the gate relation (``gkr/src/utils.rs:84-111``).
    Deeper layers (pass the previous round's challenges and
    ``alpha``/``beta``): the pair alpha/beta-folded at the previous (rb, rc)
    first (``gkr/src/utils.rs:113-135``).

    The verifier builds and folds the full wiring tables here (on ``device``,
    by default the package's default device): like the reference, it is not
    succinct in circuit size; :mod:`.sparse`'s verifier is.
    """
    pair = WiringPair.for_layer(circuit, layer_index, device)
    if initial_random_challenge is not None:
        add_r, mul_r = pair.evaluate([initial_random_challenge, *sumcheck_challenges])
    else:
        half = len(previous_sumcheck_challenges) // 2
        folded = pair.alpha_beta_fold(
            alpha, beta, previous_sumcheck_challenges[:half], previous_sumcheck_challenges[half:]
        )
        add_r, mul_r = folded.evaluate(sumcheck_challenges)
    return gate_claim(circuit.ctx, add_r, mul_r, wb_evaluation, wc_evaluation)
