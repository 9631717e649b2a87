"""Round-by-round interactive sumcheck (a verifier with true randomness).

Counterpart of :mod:`tpu_zk.sumcheck.interactive` (reference
``sumcheck_protocol/src/basic_sumcheck/sumcheck_interactive_simulation.rs``:
Prover :5-44, split_polynomial_and_sum_each :47-62, Verifier :66-113), on the
same kernels as the non-interactive prover: a K2 fold a round, and the half
sums of the table.  In the last round the table has one entry, and the
reference's ``split_at(0)`` leaves an empty left half: its univariate is
``[0, value]``.
"""

from __future__ import annotations

import secrets

from ..poly.multilinear import MultilinearPolynomial, fold, sum_halves


class Prover:
    def __init__(self, polynomial: MultilinearPolynomial):
        self.ctx = polynomial.ctx
        self.initial_polynomial = polynomial
        self.initial_claimed_sum = polynomial.sum()
        self.current = polynomial.table
        self.round = 0

    def prove(self, random_challenge: int):
        """(claimed sum, round univariate [u(0), u(1)]) of the next round;
        round 0 ignores the challenge, every later round first folds at it."""
        ctx = self.ctx
        if self.round == 0:
            self.round += 1
            return self.initial_claimed_sum, ctx.to_ints(sum_halves(ctx, self.current))
        self.current = fold(ctx, self.current, 0, ctx.scalar(random_challenge, device=self.current.device))
        self.round += 1
        new_claim = MultilinearPolynomial(ctx, self.current).sum()
        if self.current.shape[0] == 1:
            return new_claim, [0, ctx.to_ints(self.current)[0]]  # split_at(0)
        return new_claim, ctx.to_ints(sum_halves(ctx, self.current))


class Verifier:
    def __init__(self, polynomial: MultilinearPolynomial):
        self.ctx = polynomial.ctx
        self.initial_polynomial = polynomial
        self.current_claimed_sum = 0
        self.challenges: list[int] = []

    def verify(self, claimed_sum: int, univariate: list[int]) -> bool:
        if len(univariate) != 2:
            return False
        u0, u1 = univariate
        if (u0 + u1) % self.ctx.p != claimed_sum % self.ctx.p:
            return False
        self.current_claimed_sum = claimed_sum % self.ctx.p
        return True

    def generate_challenge(self) -> int:
        c = secrets.randbelow(self.ctx.p)
        self.challenges.append(c)
        return c

    def oracle_check(self) -> bool:
        return self.current_claimed_sum == self.initial_polynomial.evaluate(self.challenges)
