"""Dense univariate polynomials (host-side, exact python-int arithmetic).

Counterpart of :mod:`tpu_zk.poly.univariate`.  The polynomials of every
protocol path are tiny (degree <= 3 in GKR-sumcheck rounds), so they stay on
the host in exact integer arithmetic mod p; the device holds the 2^n tables.

Reference parity: ``polynomials/src/univariate/dense_univariate.rs``
(evaluate :57-68, lagrange_interpolate :74-98, multiply_polynomials :142-162,
add_polynomials :164-182).
"""

from __future__ import annotations

from ..fields.arith import FieldCtx


class DenseUnivariatePolynomial:
    """Coefficients little-endian (coefficients[i] is the x^i term), ints mod p."""

    def __init__(self, ctx: FieldCtx, coefficients):
        self.ctx = ctx
        self.coefficients = [c % ctx.p for c in coefficients]

    def degree(self) -> int:
        return len(self.coefficients) - 1

    def evaluate(self, value: int) -> int:
        p = self.ctx.p
        result = 0
        current_power = 1
        for c in self.coefficients:
            result = (result + c * current_power) % p
            current_power = current_power * value % p
        return result

    @classmethod
    def lagrange_interpolate(cls, ctx: FieldCtx, x_values, y_values) -> "DenseUnivariatePolynomial":
        final = [0]
        for index, x_value in enumerate(x_values):
            final = add_coeffs(ctx, final, _lagrange_basis(ctx, y_values[index], x_value, x_values))
        return cls(ctx, final)

    def to_bytes_le(self) -> bytes:
        """Coefficients serialized little-endian (GKR-sumcheck rounds absorb LE;
        reference ``sumcheck_gkr_protocol.rs:145-150``)."""
        return b"".join(self.ctx.to_bytes_le(c) for c in self.coefficients)

    def to_bytes_be(self) -> bytes:
        return b"".join(self.ctx.to_bytes_be(c) for c in self.coefficients)


def _lagrange_basis(ctx: FieldCtx, y_point: int, focus_x: int, interpolating_set) -> list[int]:
    p = ctx.p
    numerator = [1]
    for x in interpolating_set:
        if x % p != focus_x % p:
            numerator = mul_coeffs(ctx, numerator, [(-x) % p, 1])
    denominator = DenseUnivariatePolynomial(ctx, numerator).evaluate(focus_x)
    scale = y_point * pow(denominator, p - 2, p) % p
    return [c * scale % p for c in numerator]


def mul_coeffs(ctx: FieldCtx, left, right) -> list[int]:
    p = ctx.p
    out = [0] * (len(left) + len(right) - 1)
    for i, a in enumerate(left):
        for j, b in enumerate(right):
            out[i + j] = (out[i + j] + a * b) % p
    return out


def add_coeffs(ctx: FieldCtx, left, right) -> list[int]:
    p = ctx.p
    if len(left) < len(right):
        left, right = right, left
    out = list(left)
    for i, c in enumerate(right):
        out[i] = (out[i] + c) % p
    return out
