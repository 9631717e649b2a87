"""Multilinear polynomials in evaluation (boolean-hypercube) form.

The table of ``2^n`` evaluations is a ``[..., N, L]`` int32 limb tensor in
Montgomery form, on the device it was made on.  The core op is the
partial-evaluation *fold* ``y1 + r*(y2 - y1)`` over pairs at stride
``2^(n-1-var)``; every fold goes through the K2 kernel wrapper
(:func:`tpu_zk_torch.fields.kernels.fold`), for tables of any size.

Counterpart of :mod:`tpu_zk.poly.multilinear`, with one layout, ``[N, L]``,
at every public function.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..fields import arith, kernels
from ..fields.arith import FieldCtx

# elements summed by one K2 block (power of two, at most kernels.MAX_FOLD_BLOCK)
FOLD_BLOCK = 1024


def fold(ctx: FieldCtx, table: torch.Tensor, var: int, r: torch.Tensor) -> torch.Tensor:
    """Partially evaluate variable ``var`` at Montgomery scalar ``r [L]``.

    table: [..., N, L] -> [..., N/2, L].  Variable 0 is the most-significant
    index bit (pairs are the two halves of the table), as in the reference;
    the 2^var leading index bits become K2's batch rows.
    """
    *batch, N, L = table.shape
    trail = N >> (var + 1)
    rows = math.prod(batch) << var
    flat = table.reshape(rows, 2 * trail, L).contiguous()
    folded, _ = kernels.fold(ctx, flat, r, min(FOLD_BLOCK, trail))
    return folded.reshape(*batch, N // 2, L)


def fold_and_half_sums(ctx: FieldCtx, table: torch.Tensor, r: torch.Tensor):
    """One basic-sumcheck round: fold variable 0, and return the Montgomery
    half-sums of the *folded* table (the next round univariate).

    table: [N, L], N >= 4 a power of two -> (folded [N/2, L], univ_mont [2, L]).
    One K2 launch; its per-block sums never straddle the two halves because
    the block divides T/2.
    """
    folded, lazy = fold_and_lazy_half_sums(ctx, table, r)
    return folded, arith.reduce_lazy(ctx, lazy)


def fold_and_lazy_half_sums(ctx: FieldCtx, table: torch.Tensor, r: torch.Tensor):
    """:func:`fold_and_half_sums` with the half-sums left as int64 sums of
    strict wide limbs [2, L+2], which add exactly across tables (a sharded
    round adds every shard's before :func:`~tpu_zk_torch.fields.arith.reduce_lazy`)."""
    N, L = table.shape
    T = N // 2
    if N < 4 or N & (N - 1):
        raise ValueError(f"fold_and_half_sums: table of {N} rows (needs a power of two >= 4)")
    folded, wide = kernels.fold(ctx, table.reshape(1, N, L).contiguous(), r, min(FOLD_BLOCK, T // 2))
    G = wide.shape[1]
    return folded[0], wide[0].reshape(2, G // 2, L + 2).sum(dim=1, dtype=torch.int64)


def sum_halves(ctx: FieldCtx, table: torch.Tensor) -> torch.Tensor:
    """[N, L] -> [2, L]: modular sums of the two halves (one sumcheck round's
    univariate in evaluation form)."""
    N = table.shape[0]
    return arith.sum_mod(ctx, table.reshape(2, N // 2, ctx.L), axis=1)


def round0_univariate(ctx: FieldCtx, table: torch.Tensor) -> torch.Tensor:
    """The first sumcheck round's univariate: [N, L] -> the half sums [2, L]
    in plain form."""
    return arith.from_mont(ctx, sum_halves(ctx, table))


def fused_round(ctx: FieldCtx, table: torch.Tensor, r: torch.Tensor):
    """One sumcheck round: fold variable 0 at the Montgomery challenge ``r``
    and sum the folded table's halves -> (the next univariate [2, L] in
    plain form, the folded table [N/2, L]); one K2 launch."""
    folded, univ_m = fold_and_half_sums(ctx, table, r)
    return arith.from_mont(ctx, univ_m), folded


def fold_chain(ctx: FieldCtx, table: torch.Tensor, rs: torch.Tensor) -> torch.Tensor:
    """Fold variable 0 at each point of ``rs [k, L]`` in turn."""
    for i in range(rs.shape[0]):
        table = fold(ctx, table, 0, rs[i])
    return table


def tensor_add(ctx: FieldCtx, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Outer sum: out[i*Nc + j] = b[i] + c[j] (evaluation_form.rs:108-124);
    one K3 launch over the materialized [Nb*Nc, L] operands."""
    return arith.add(ctx, b[:, None, :], c[None, :, :]).reshape(-1, ctx.L)


def tensor_mul(ctx: FieldCtx, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Outer product: out[i*Nc + j] = b[i] * c[j] (evaluation_form.rs:126-143);
    one K1 launch over the materialized [Nb*Nc, L] operands."""
    return arith.mont_mul(ctx, b[:, None, :], c[None, :, :]).reshape(-1, ctx.L)


def limbs_to_bytes_be(ctx: FieldCtx, plain_limbs: torch.Tensor) -> bytes:
    """[N, L] strict *plain* (non-Montgomery) limbs -> concatenated BE bytes.

    The bytes are laid out on the tensor's device; one copy brings them to
    the host.
    """
    if ctx.L * 2 != ctx.nbytes:
        raise NotImplementedError(f"{ctx.name}: {ctx.L} limbs do not serialize to {ctx.nbytes} bytes")
    be = plain_limbs.flip(-1)
    pairs = torch.stack([(be >> 8) & 0xFF, be & 0xFF], dim=-1).to(torch.uint8)
    return pairs.cpu().numpy().tobytes()


class MultilinearPolynomial:
    """Evaluation-form MLE over a limb table (Montgomery form)."""

    def __init__(self, ctx: FieldCtx, table: torch.Tensor):
        n = table.shape[0]
        if n == 0 or n & (n - 1):
            raise ValueError("Evaluated values must be a power of 2")
        if table.shape[-1] != ctx.L:
            raise ValueError(f"table limbs {table.shape[-1]} != L={ctx.L}")
        self.ctx = ctx
        self.table = table

    # -- constructors --------------------------------------------------------
    @classmethod
    def from_ints(cls, ctx: FieldCtx, values, device=None) -> "MultilinearPolynomial":
        return cls(ctx, ctx.array(list(values), device=device))

    # -- reference API -------------------------------------------------------
    def __len__(self):
        return self.table.shape[0]

    @property
    def number_of_variables(self) -> int:
        return int(self.table.shape[0]).bit_length() - 1

    def partial_evaluate(self, var: int, value) -> "MultilinearPolynomial":
        return MultilinearPolynomial(self.ctx, fold(self.ctx, self.table, var, self._as_scalar(value)))

    def evaluate(self, values) -> int:
        """Evaluate at a point (list of ints / scalars); returns canonical int."""
        values = list(values)
        if not values:
            return self.ctx.to_ints(self.table[0])
        rs = torch.stack([self._as_scalar(v) for v in values])
        return self.ctx.to_ints(fold_chain(self.ctx, self.table, rs)[0])

    def scalar_mul(self, value) -> "MultilinearPolynomial":
        return MultilinearPolynomial(self.ctx, arith.mont_mul(self.ctx, self.table, self._as_scalar(value)))

    def add(self, other: "MultilinearPolynomial") -> "MultilinearPolynomial":
        self._same_length(other, "Polynomials must have same number of evaluations for addition")
        return MultilinearPolynomial(self.ctx, arith.add(self.ctx, self.table, other.table))

    def tensor_add(self, other: "MultilinearPolynomial") -> "MultilinearPolynomial":
        self._same_length(other, "Different polynomial length")
        return MultilinearPolynomial(self.ctx, tensor_add(self.ctx, self.table, other.table))

    def tensor_mul(self, other: "MultilinearPolynomial") -> "MultilinearPolynomial":
        self._same_length(other, "Different polynomial length")
        return MultilinearPolynomial(self.ctx, tensor_mul(self.ctx, self.table, other.table))

    def sum(self) -> int:
        return self.ctx.to_ints(arith.sum_mod(self.ctx, self.table))

    def convert_to_bytes(self) -> bytes:
        """Big-endian canonical bytes of every evaluation, concatenated."""
        return limbs_to_bytes_be(self.ctx, arith.from_mont(self.ctx, self.table))

    def to_ints(self):
        return self.ctx.to_ints(self.table)

    # -- helpers -------------------------------------------------------------
    def _as_scalar(self, value) -> torch.Tensor:
        if isinstance(value, (int, np.integer)):
            return self.ctx.scalar(int(value), device=self.table.device)
        return value  # already a Montgomery [L] limb vector

    def _same_length(self, other: "MultilinearPolynomial", message: str) -> None:
        if len(self) != len(other):
            raise ValueError(f"{message}: {len(self)} != {len(other)}")

    def __eq__(self, other):
        return (
            isinstance(other, MultilinearPolynomial)
            and len(self) == len(other)
            and bool(torch.equal(self.table, other.table.to(self.table.device)))
        )
