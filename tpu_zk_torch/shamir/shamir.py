"""Shamir secret sharing (both reference variants), on host ints.

Counterpart of :mod:`tpu_zk.shamir.shamir`, over the port's exact
univariate polynomials: threshold-degree interpolation is tiny, and the
card has nothing to add.

Reference parity:
  * v1: ``shamir_secret_sharing/src/shamir_secret_sharing.rs`` -- the secret
    as coefficient 0, random coefficients, shares evaluated at x = 1..n-1:
    the reference's loop ``for i in 1..number_shares`` yields
    ``number_shares - 1`` shares (:31-35), and so does this one.
  * v2 ("password"): ``shamir_s_sharing.rs`` -- interpolate through
    (password, secret) and random points, retrying until the polynomial has
    exact degree threshold-1 (:13-44); recover by evaluating at the
    password.
"""

from __future__ import annotations

import secrets

from ..fields.arith import FieldCtx
from ..poly.univariate import DenseUnivariatePolynomial


def shares(ctx: FieldCtx, secret: int, threshold: int, number_shares: int):
    y_values = [secret % ctx.p] + [secrets.randbelow(ctx.p) for _ in range(1, threshold)]
    polynomial = DenseUnivariatePolynomial(ctx, y_values)
    return [(i, polynomial.evaluate(i)) for i in range(1, number_shares)]


def recover_secret(ctx: FieldCtx, share_list) -> int:
    x_values = [s[0] for s in share_list]
    y_values = [s[1] for s in share_list]
    return DenseUnivariatePolynomial.lagrange_interpolate(ctx, x_values, y_values).evaluate(0)


def s_shares(ctx: FieldCtx, secret: int, password: int, threshold: int, number_shares: int):
    while True:
        x_values = [password % ctx.p] + list(range(1, threshold))
        y_values = [secret % ctx.p] + [secrets.randbelow(ctx.p) for _ in range(1, threshold)]
        polynomial = DenseUnivariatePolynomial.lagrange_interpolate(ctx, x_values, y_values)
        if polynomial.degree() == threshold - 1 and polynomial.coefficients[-1] != 0:
            return [(i, polynomial.evaluate(i)) for i in range(1, number_shares)]


def s_recover_secret(ctx: FieldCtx, share_list, password: int) -> int:
    x_values = [s[0] for s in share_list]
    y_values = [s[1] for s in share_list]
    return DenseUnivariatePolynomial.lagrange_interpolate(ctx, x_values, y_values).evaluate(password)
