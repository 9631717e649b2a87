"""Sharded basic sumcheck: the 2^n evaluation table split over a mesh.

Counterpart of :mod:`tpu_zk.parallel.sharded_sumcheck`.  The *low*
``log2(D)`` index bits are the shard axis: shard d holds the logical rows
j*D + d, j = 0 .. N/D - 1.  The sumcheck folds the most-significant
variable, so every fold pairs two rows of one shard: each shard folds its
own table (K2) and returns the int64 limb sums of its two folded halves,
and one exact cross-shard sum of those, reduced once, is the round's
univariate.  When each shard is down to one row, the D rows (shard d is
logical row d) are gathered and the last ``log2(D)`` rounds run on the
one-device code.  The transcript is the host's, as in ``tpu_zk``; proofs
equal :mod:`tpu_zk_torch.sumcheck.basic`'s.
"""

from __future__ import annotations

import torch

from ..fields.arith import FieldCtx, reduce_lazy
from ..poly.multilinear import MultilinearPolynomial, fold, fold_and_lazy_half_sums, sum_halves
from ..sumcheck.basic import SumcheckProof, host_round
from ..transcript.fiat_shamir import Transcript
from .mesh import Mesh, cross_shard_sum, gather, replicated, scatter


def _sharded_half_sums(ctx: FieldCtx, mesh: Mesh, shards: list) -> torch.Tensor:
    """Shards [M, L] -> [2, L] Montgomery on the primary: per-shard half
    sums, then one exact cross-shard sum."""
    lazy = mesh.map(lambda i, dev: shards[i].view(2, shards[i].shape[0] // 2, ctx.L).sum(dim=1, dtype=torch.int64))
    return reduce_lazy(ctx, cross_shard_sum(mesh, lazy))


def _sharded_fold(ctx: FieldCtx, mesh: Mesh, shards: list, r: dict) -> list:
    """Shards [M, L] -> [M/2, L]: fold the top logical variable at ``r``
    (replicated Montgomery [L]), shard-local (K2 on each shard)."""
    return mesh.map(lambda i, dev: fold(ctx, shards[i], 0, r[dev]))


def _sharded_fold_and_half_sums(ctx: FieldCtx, mesh: Mesh, shards: list, r: dict):
    """One round on shards of M >= 4 rows: each shard's fold and lazy half
    sums (one K2 launch), then one cross-shard sum of the lazy sums."""
    out = mesh.map(lambda i, dev: fold_and_lazy_half_sums(ctx, shards[i], r[dev]))
    folded = [None if o is None else o[0] for o in out]
    return folded, reduce_lazy(ctx, cross_shard_sum(mesh, [None if o is None else o[1] for o in out]))


def to_sharded_layout(ctx: FieldCtx, table: torch.Tensor, mesh: Mesh) -> list:
    """[N, L] logical table -> D shards [N/D, L]; shard d holds rows j*D + d."""
    D, N = mesh.size, table.shape[0]
    if N % D or N < 2 * D:
        raise ValueError(f"sharded sumcheck: a table of {N} rows does not split over {D} shards (needs N >= 2D)")
    t = table.reshape(N // D, D, ctx.L).transpose(0, 1)
    return scatter(mesh, lambda d: t[d].contiguous())


class ShardedProver:
    """The basic-sumcheck prover over a mesh (the same proofs as
    :class:`tpu_zk_torch.sumcheck.basic.Prover`)."""

    def __init__(self, polynomial: MultilinearPolynomial, mesh: Mesh):
        self.ctx = ctx = polynomial.ctx
        self.mesh = mesh
        self.initial_polynomial = polynomial
        self.sharded = to_sharded_layout(ctx, polynomial.table, mesh)
        self._first_univariate = _sharded_half_sums(ctx, mesh, self.sharded)
        self.initial_claimed_sum = sum(ctx.to_ints(self._first_univariate)) % ctx.p
        self.transcript = Transcript()

    def prove(self) -> SumcheckProof:
        ctx, mesh, transcript = self.ctx, self.mesh, self.transcript
        transcript.append(self.initial_polynomial.convert_to_bytes())
        transcript.append(ctx.to_bytes_be(self.initial_claimed_sum))

        shards, table = self.sharded, None
        univ_m = self._first_univariate
        n = self.initial_polynomial.number_of_variables
        round_polys = []
        for rnd in range(n):
            round_polys.append(MultilinearPolynomial(ctx, univ_m))
            if table is not None:  # the gathered table: the one-device round
                table, univ_m = host_round(ctx, transcript, table, univ_m, rnd < n - 1)
                continue
            u0, u1 = ctx.to_ints(univ_m)
            transcript.append(ctx.to_bytes_be(u0) + ctx.to_bytes_be(u1))
            challenge = transcript.random_challenge_as_field_element(ctx)
            if rnd == n - 1:
                break
            r = replicated(mesh, ctx.scalar(challenge, device=mesh.primary))
            if shards[mesh.local[0]].shape[0] >= 4:
                shards, univ_m = _sharded_fold_and_half_sums(ctx, mesh, shards, r)
            else:  # one row a shard after this fold: shard d is logical row d
                table = gather(mesh, _sharded_fold(ctx, mesh, shards, r))
                univ_m = sum_halves(ctx, table)

        return SumcheckProof(
            initial_polynomial=self.initial_polynomial,
            initial_claimed_sum=self.initial_claimed_sum,
            round_univariate_polynomials=round_polys,
        )
