"""Sharded multi-pass NTT: K6 passes on each shard, one all_to_all before the last.

Counterpart of :mod:`tpu_zk.parallel.sharded_ntt`, over the port's plan
(:class:`tpu_zk_torch.ntt.sixstep.SixStepPlan`), which views the table as
[m_0, ..., m_{R-1}, L] and runs one K6 pass a digit in place:

  - passes 0 .. R-2 keep the **last** digit axis n_{R-1} sharded: shard s
    holds its block of m_{R-1}/D values of it, every pass's columns lie
    within one shard, and each shard runs K6 on its columns with its slice
    of the pre-twiddles;
  - one ``all_to_all`` then shards the **first** axis (the first pass's
    output digit) instead, which makes n_{R-1} local for the last pass;
  - the last pass stores in natural order, as the plan's does: shard s
    holds the outputs k = j D + rev(s) (rev: the bit reversal of log2(D)
    bits), at local row j, and the exit gather interleaves them.

The arithmetic of every element is the plan's, so the output equals
``plan(table)`` limb for limb.
"""

from __future__ import annotations

import math

import torch

from ..ntt import kernels
from ..ntt.sixstep import SixStepPlan, _bit_reverse
from .mesh import Mesh, all_shards, all_to_all, copy_to, replicated, scatter


class ShardedSixStep:
    """One plan's tables cut for a mesh: per pass the stage twiddles
    replicated, and each shard's pre-twiddles and last-pass output rows."""

    def __init__(self, plan: SixStepPlan, mesh: Mesh):
        ms, D = plan.ms, mesh.size
        self.plan, self.mesh = plan, mesh
        self.shardable = len(ms) > 1 and ms[0] % D == 0 and ms[-1] % D == 0
        if not self.shardable:
            return
        L, R, m_last = plan.ctx.L, len(ms), ms[-1]
        mb = m_last // D
        self.tws = [replicated(mesh, t) for t in plan.tws]
        self.pres = [None]
        for i in range(1, R - 1):  # sliced along n_{R-1}, the fastest axis of C_i
            A, m, C = math.prod(ms[:i]), ms[i], math.prod(ms[i + 1 :])
            pre = plan.pres[i].view(A, m, C // m_last, m_last, L)
            self.pres.append(scatter(mesh, lambda s: pre[..., s * mb : (s + 1) * mb, :].contiguous()
                                     .view(A, m, C // D, L)))
        A = plan.N // m_last
        last = plan.pres[R - 1].view(D, A // D, m_last, 1, L)  # sliced along the first axis
        self.last_pre = scatter(mesh, lambda s: last[s])
        rows = plan.dst.view(D, plan.N // D) // D
        self.last_dst = scatter(mesh, lambda s: rows[s])
        self.scale = None if plan.scale is None else replicated(mesh, plan.scale)
        rev = _bit_reverse(D.bit_length() - 1)
        self.shard_of_residue = [int(rev[c]) for c in range(D)]  # the shard holding outputs k = c mod D

    def __call__(self, table: torch.Tensor) -> torch.Tensor:
        """[N, L] Montgomery -> transformed [N, L] on the primary."""
        plan, mesh = self.plan, self.mesh
        if not self.shardable:
            return plan(copy_to(table, plan.device))
        ctx, ms, L, D = plan.ctx, plan.ms, plan.ctx.L, mesh.size
        if table.shape != (plan.N, L):
            raise ValueError(f"sharded NTT: expected a [{plan.N}, {L}] table, got {tuple(table.shape)}")
        R, m_last = len(ms), ms[-1]
        mb = m_last // D
        x = table.view(plan.N // m_last, m_last, L)
        shards = scatter(mesh, lambda s: x[:, s * mb : (s + 1) * mb].contiguous())
        for i in range(R - 1):
            A, m, C = math.prod(ms[:i]), ms[i], math.prod(ms[i + 1 :]) // D
            shards = mesh.map(lambda s, dev: kernels.dif_pass(
                ctx, shards[s].view(A, m, C, L), self.tws[i][dev],
                None if self.pres[i] is None else self.pres[i][s]).view(-1, mb, L))
        # the digit turn: shard the first axis, make n_{R-1} local
        shards = all_to_all(mesh, shards, split_dim=0, concat_dim=1)
        A = plan.N // m_last // D
        shards = mesh.map(lambda s, dev: kernels.dif_pass(
            ctx, shards[s].view(A, m_last, 1, L), self.tws[R - 1][dev], self.last_pre[s],
            None if self.scale is None else self.scale[dev], self.last_dst[s]).view(-1, 1, L))
        # the exit gather: output k = j D + c lies at row j of the shard of residue c
        every = all_shards(mesh, shards)
        return torch.cat([every[s] for s in self.shard_of_residue], dim=1).view(plan.N, L)


def sharded_sixstep(plan: SixStepPlan, table: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """[N, L] Montgomery -> transformed [N, L], computed over the mesh."""
    return ShardedSixStep(plan, mesh)(table)
