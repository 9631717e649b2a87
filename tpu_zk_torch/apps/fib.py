"""Fibonacci by interpolation (reference ``fibonacci_evaluation/src/fib_eval.rs:4-27``),
the counterpart of :mod:`tpu_zk.apps.fib`, on host ints."""

from __future__ import annotations

from ..fields.arith import FieldCtx
from ..poly.univariate import DenseUnivariatePolynomial

X_VALUES = [1, 2, 3, 4, 5, 6, 7]
Y_VALUES = [1, 2, 3, 5, 8, 13, 21]


def evaluation(ctx: FieldCtx, evaluation_value: int) -> int:
    polynomial = DenseUnivariatePolynomial.lagrange_interpolate(ctx, X_VALUES, Y_VALUES)
    return polynomial.evaluate(evaluation_value)
