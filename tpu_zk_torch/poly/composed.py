"""Composed (product / sum) polynomials -- the GKR sumcheck working set.

Counterpart of :mod:`tpu_zk.poly.composed`.  A ProductPolynomial is a stacked
``[k, N, L]`` limb tensor (k same-size MLE factors), a SumPolynomial is
``[p, k, N, L]``.  Partial evaluation folds all members in one K2 launch
over the stacked tensor (``p*k`` batch rows); the elementwise collapse is a
product over the k axis (K1) then a sum over the p axis (K3).  The reference
stores these as Vecs of polynomials
(``polynomials/src/composed/product_polynomial.rs:6-8``,
``sum_polynomial.rs:7-9``); the semantics are the same.
"""

from __future__ import annotations

import torch

from ..fields import arith
from ..fields.arith import FieldCtx
from .multilinear import MultilinearPolynomial, fold


def product_of_factors(ctx: FieldCtx, factors) -> torch.Tensor:
    """Elementwise product of a sequence of Montgomery tensors (one K1
    launch per factor after the first)."""
    factors = iter(factors)
    prod = next(factors)
    for f in factors:
        prod = arith.mont_mul(ctx, prod, f)
    return prod


def collapse_sum_of_products(ctx: FieldCtx, stacked: torch.Tensor) -> torch.Tensor:
    """[p, k, N, L] -> [N, L]: elementwise product over k, then sum over p.

    Mirrors ``SumPolynomial::add_polynomials_element_wise``
    (sum_polynomial.rs:57-76) composed with
    ``ProductPolynomial::multiply_polynomials_element_wise``
    (product_polynomial.rs:58-73).
    """
    prod = product_of_factors(ctx, stacked.unbind(1))
    acc = prod[0]
    for i in range(1, stacked.shape[0]):
        acc = arith.add(ctx, acc, prod[i])
    return acc


def _point(ctx: FieldCtx, value, device) -> torch.Tensor:
    """A challenge as a Montgomery [L] tensor (host ints are converted)."""
    return ctx.scalar(int(value), device=device) if isinstance(value, int) else value


class ProductPolynomial:
    def __init__(self, ctx: FieldCtx, stacked: torch.Tensor):
        if stacked.dim() != 3:
            raise ValueError(f"ProductPolynomial: expected [k, N, L], got {tuple(stacked.shape)}")
        self.ctx = ctx
        self.stacked = stacked  # [k, N, L]

    @classmethod
    def from_mles(cls, polys: list[MultilinearPolynomial]) -> "ProductPolynomial":
        n = polys[0].number_of_variables
        if any(q.number_of_variables != n for q in polys):
            raise ValueError("different number of variables")
        return cls(polys[0].ctx, torch.stack([q.table for q in polys]))

    @property
    def degree(self) -> int:
        return self.stacked.shape[0]

    @property
    def number_of_variables(self) -> int:
        return int(self.stacked.shape[1]).bit_length() - 1

    def evaluate(self, values) -> int:
        t = self.stacked
        for v in values:
            t = fold(self.ctx, t, 0, _point(self.ctx, v, t.device))
        return self.ctx.to_ints(product_of_factors(self.ctx, t[:, 0]))

    def partial_evaluate(self, var: int, value) -> "ProductPolynomial":
        r = _point(self.ctx, value, self.stacked.device)
        return ProductPolynomial(self.ctx, fold(self.ctx, self.stacked, var, r))

    def multiply_polynomials_element_wise(self) -> MultilinearPolynomial:
        if self.stacked.shape[0] < 2:
            raise ValueError("more than one polynomial required for mul operation")
        return MultilinearPolynomial(self.ctx, product_of_factors(self.ctx, self.stacked.unbind(0)))

    def convert_to_bytes(self) -> bytes:
        return b"".join(f.convert_to_bytes() for f in self.mles())

    def mles(self) -> list[MultilinearPolynomial]:
        return [MultilinearPolynomial(self.ctx, f) for f in self.stacked]


class SumPolynomial:
    def __init__(self, ctx: FieldCtx, stacked: torch.Tensor):
        if stacked.dim() != 4:
            raise ValueError(f"SumPolynomial: expected [p, k, N, L], got {tuple(stacked.shape)}")
        self.ctx = ctx
        self.stacked = stacked  # [p, k, N, L]

    @classmethod
    def from_products(cls, products: list[ProductPolynomial]) -> "SumPolynomial":
        n = products[0].number_of_variables
        if any(q.number_of_variables != n for q in products):
            raise ValueError("different number of variables")
        if any(q.degree != products[0].degree for q in products):
            raise ValueError("products of different degrees")
        return cls(products[0].ctx, torch.stack([q.stacked for q in products]))

    @property
    def degree(self) -> int:
        return self.stacked.shape[1]

    @property
    def number_of_variables(self) -> int:
        return int(self.stacked.shape[2]).bit_length() - 1

    def evaluate(self, values) -> int:
        acc = 0
        for i in range(self.stacked.shape[0]):
            acc = (acc + ProductPolynomial(self.ctx, self.stacked[i]).evaluate(values)) % self.ctx.p
        return acc

    def partial_evaluate(self, var: int, value) -> "SumPolynomial":
        r = _point(self.ctx, value, self.stacked.device)
        return SumPolynomial(self.ctx, fold(self.ctx, self.stacked, var, r))

    def add_polynomials_element_wise(self) -> MultilinearPolynomial:
        if self.stacked.shape[0] < 2:
            raise ValueError("more than one product polynomial required for add operation")
        return MultilinearPolynomial(self.ctx, collapse_sum_of_products(self.ctx, self.stacked))

    def convert_to_bytes(self) -> bytes:
        return b"".join(
            ProductPolynomial(self.ctx, self.stacked[i]).convert_to_bytes() for i in range(self.stacked.shape[0])
        )
