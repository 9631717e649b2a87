"""Sharded FRI commit: each round's Merkle tree and fold on the shards.

Counterpart of :mod:`tpu_zk.parallel.sharded_fri`.  The codeword is cut
into D blocks of consecutive rows.  Each commit round:

  - builds the round's tree with :func:`.sharded_merkle.sharded_tree_flat`
    (each shard's subtree, the top ``log2(D)`` levels on the primary);
  - absorbs the root and squeezes beta on the replicated device sponge: one
    K7 launch on each distinct device of every process, all absorbing the
    same bytes (:func:`tpu_zk_torch.fri.fri._root_challenge`);
  - folds: row i pairs with row i + N/2, so shard k's rows pair with shard
    k + D/2's; new shard j takes half of old shard j // 2's rows and the
    same half of old shard j // 2 + D/2's (:func:`.mesh.exchange`).

Every process gathers each round's codeword for the query phase.  Once a
fold would leave fewer than 2 rows a shard, the remaining rounds are
``fri.prove``'s own (:func:`tpu_zk_torch.fri.fri._commit_round` on the
primary's sponge), as in ``tpu_zk``.  The roots, the final codeword and the
primary's sponge come back in one copy, as in ``fri.prove``, and the
transcript bytes, roots, final codeword and openings equal its.
"""

from __future__ import annotations

import torch

from ..fields.arith import FieldCtx
from ..fri.fri import (FriConfig, FriProof, _commit_round, _hand_back, _query_phase, _root_challenge, fold_codeword,
                       fold_halves)
from ..transcript.device_fs import DeviceSponge
from ..transcript.fiat_shamir import Transcript
from .mesh import Mesh, copy_to, exchange, gather, replicated, shard_leading
from .sharded_merkle import shardable, sharded_tree_flat


def _sharded_fold(ctx: FieldCtx, mesh: Mesh, shards: list, beta: dict, inv_x: dict, inv2: dict) -> list:
    """D shards of n rows -> D shards of n/2 rows: new shard j folds rows
    [(j % 2) n/2, (j % 2 + 1) n/2) of old shards j // 2 and j // 2 + D/2
    (one exchange); ``inv_x[dev]`` is the round's [N/2, L] table of inverses."""
    D, h = mesh.size, shards[mesh.local[0]].shape[0] // 2
    halves = [slice((j % 2) * h, (j % 2 + 1) * h) for j in range(D)]
    pairs = exchange(mesh, shards, [[(j // 2, halves[j]), (j // 2 + D // 2, halves[j])] for j in range(D)])
    return mesh.map(lambda j, dev: fold_halves(ctx, *pairs[j], beta[dev], inv_x[dev][j * h : (j + 1) * h],
                                               inv2[dev]))


def prove(config: FriConfig, codeword, transcript: Transcript, mesh: Mesh) -> FriProof:
    """Sharded-commit FRI prove; the same proof as ``fri.prove``.  ``codeword``
    is a [N, L] Montgomery tensor or host ints (put on the primary)."""
    ctx, D = config.ctx, mesh.size
    if not isinstance(codeword, torch.Tensor):
        codeword = ctx.array(list(codeword), device=mesh.primary)
    codeword = copy_to(codeword, mesh.primary)
    N = codeword.shape[0]
    assert N == 1 << config.domain_log2

    sponges = {dev: DeviceSponge.from_host(transcript._hasher, dev) for dev in mesh.distinct}
    tables = {dev: config.fold_tables(dev) for dev in mesh.distinct}
    inv2 = {dev: t[1] for dev, t in tables.items()}

    shards = shard_leading(mesh, codeword) if shardable(N, D) and N >= 2 * D else None
    current = codeword
    codewords, trees = [codeword], []
    for r in range(config.num_rounds):
        inv_x = {dev: t[0][:: 1 << r] for dev, t in tables.items()}
        if shards is None:  # the one-device tail
            tree, _, current = _commit_round(ctx, sponges[mesh.primary], current, inv_x[mesh.primary],
                                             inv2[mesh.primary])
        else:
            tree = sharded_tree_flat(ctx, mesh, shards)
            root = replicated(mesh, tree[-1])
            beta = {dev: _root_challenge(ctx, sponge, root[dev]) for dev, sponge in sponges.items()}
            if (N >> r) // 2 >= 2 * D:
                shards = _sharded_fold(ctx, mesh, shards, beta, inv_x, inv2)
                current = gather(mesh, shards)
            else:
                shards = None
                current = fold_codeword(ctx, current, beta[mesh.primary], inv_x[mesh.primary], inv2[mesh.primary])
        trees.append(tree)
        codewords.append(current)

    roots, final_codeword = _hand_back(ctx, transcript, sponges[mesh.primary], [t[-1] for t in trees], current)
    for v in final_codeword:
        transcript.append(ctx.to_bytes_be(v))
    return _query_phase(config, codewords, trees, roots, final_codeword, transcript)
