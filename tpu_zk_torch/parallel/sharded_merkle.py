"""Sharded Merkle tree: each shard hashes its leaves and builds its subtree.

Counterpart of :mod:`tpu_zk.parallel.sharded_merkle`.  A block of N/D
consecutive leaves is one aligned subtree, so each shard builds its
subtree's levels (:func:`tpu_zk_torch.merkle.device_merkle.merkle_levels_device`,
one K5 launch a level) on its own device.  The levels are gathered (one
all_gather a level between processes) into one flat tree on every
process's primary, laid out as
:func:`tpu_zk_torch.merkle.device_merkle.merkle_tree_flat` lays it out, and
the top ``log2(D)`` levels hash from the D subtree roots there (K5).  The
levels equal :func:`tpu_zk_torch.merkle.device_merkle.merkle_field_tree`'s.
"""

from __future__ import annotations

import torch

from ..fields.arith import FieldCtx
from ..merkle.device_merkle import field_leaf_bytes, merkle_field_tree, merkle_levels_device
from ..merkle.kernels import keccak_rows
from .mesh import Mesh, gather, shard_leading


def shardable(N: int, D: int) -> bool:
    """Whether N leaves split into D > 1 aligned subtrees (N/D a power of two)."""
    return D > 1 and N % D == 0 and (N // D) & (N // D - 1) == 0


def sharded_tree_flat(ctx: FieldCtx, mesh: Mesh, shards: list[torch.Tensor]) -> torch.Tensor:
    """Each shard's [n, L] Montgomery leaves -> the [2 n D - 1, 32] flat tree
    on the primary (the leaf digests, then each level above, the root last)."""
    D, n = mesh.size, shards[mesh.local[0]].shape[0]
    subtrees = mesh.map(lambda k, dev: merkle_levels_device(field_leaf_bytes(ctx, shards[k])))
    flat = torch.empty((2 * n * D - 1, 32), dtype=torch.uint8, device=mesh.primary)
    off = 0
    for level in range(n.bit_length()):  # level i of every subtree, side by side
        width = n >> level
        flat[off : off + width * D] = gather(mesh, [None if t is None else t[level] for t in subtrees])
        off += width * D
    off, width = off - D, D  # the subtree roots: hash the top log2(D) levels from them
    while width > 1:
        keccak_rows(flat[off : off + width].view(width // 2, 64), out=flat[off + width : off + width + width // 2])
        off, width = off + width, width // 2
    return flat


def sharded_merkle_field_tree(ctx: FieldCtx, table: torch.Tensor, mesh: Mesh) -> tuple[torch.Tensor, ...]:
    """[N, L] Montgomery field leaves -> the tree's digest levels ([N, 32],
    ..., [1, 32]) on the primary; the leaves and subtrees are hashed on the
    shards."""
    D, N = mesh.size, int(table.shape[0])
    if not shardable(N, D):
        return merkle_field_tree(ctx, table.to(mesh.primary))  # one subtree: the one-device tree
    flat = sharded_tree_flat(ctx, mesh, shard_leading(mesh, table))
    levels, off = [], 0
    while N >= 1:
        levels.append(flat[off : off + N])
        off, N = off + N, N // 2
    return tuple(levels)
