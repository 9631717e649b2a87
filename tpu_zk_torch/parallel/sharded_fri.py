"""Sharded FRI commit: each round's Merkle tree and fold on the shards.

Counterpart of :mod:`tpu_zk.parallel.sharded_fri`.  The codeword is cut
into D blocks of consecutive rows.  Each commit round:

  - builds the round's tree with :func:`.sharded_merkle.sharded_tree_flat`
    (each shard's subtree, the top ``log2(D)`` levels on the primary);
  - absorbs the root and squeezes beta on the replicated device sponge: one
    K7 launch on each distinct device of every process, all absorbing the
    same bytes;
  - folds: row i pairs with row i + N/2, so shard k's rows pair with shard
    k + D/2's; new shard j takes half of old shard j // 2's rows and the
    same half of old shard j // 2 + D/2's (:func:`.mesh.exchange`).

Every process gathers each round's codeword for the query phase.  Once a
fold would leave fewer than 2 rows a shard, the remaining rounds take the
one-device path, as in ``tpu_zk``.  The transcript bytes, roots, final
codeword and openings equal :func:`tpu_zk_torch.fri.fri.prove`'s, which
keeps this transcript on the host.
"""

from __future__ import annotations

import torch

from ..fields.arith import FieldCtx
from ..fri.fri import FriConfig, FriProof, _query_phase, fold_codeword, fold_halves
from ..merkle.device_merkle import field_leaf_bytes, merkle_tree_flat
from ..sumcheck.fused import final_pos
from ..transcript.device_fs import DeviceSponge
from ..transcript.fiat_shamir import Transcript
from ..transcript.kernels import sponge_step
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

    hasher = transcript._hasher
    sponges = {dev: DeviceSponge.from_host(hasher, dev) for dev in mesh.distinct}
    tables = {dev: config.fold_tables(dev) for dev in mesh.distinct}
    inv2 = {dev: t[1] for dev, t in tables.items()}

    shards = shard_leading(mesh, codeword) if shardable(N, D) and N >= 2 * D else None
    current = codeword
    codewords, trees, roots = [codeword], [], []
    for r in range(config.num_rounds):
        tree = (sharded_tree_flat(ctx, mesh, shards) if shards is not None
                else merkle_tree_flat(field_leaf_bytes(ctx, current)))
        beta, root = {}, replicated(mesh, tree[-1])
        for dev, sponge in sponges.items():
            beta[dev] = torch.empty(ctx.L, dtype=torch.int32, device=dev)
            digest = torch.empty(32, dtype=torch.uint8, device=dev)
            sponge_step(sponge.state, sponge.buf, sponge.pos, root[dev], digest, beta[dev], ctx)
        inv_x = {dev: t[0][:: 1 << r] for dev, t in tables.items()}
        size = N >> r
        if shards is not None and size // 2 >= 2 * D:
            shards = _sharded_fold(ctx, mesh, shards, beta, inv_x, inv2)
            current = gather(mesh, shards)
        else:
            shards = None
            current = fold_codeword(ctx, current, beta[mesh.primary], inv_x[mesh.primary], inv2[mesh.primary])
        trees.append(tree)
        roots.append(tree[-1])
        codewords.append(current)

    primary = sponges[mesh.primary]
    transcript._hasher = DeviceSponge.to_host(primary.state, primary.buf, final_pos(len(hasher._buf), config.num_rounds, 32))
    root_bytes = [row.tobytes() for row in torch.stack(roots).cpu().numpy()] if roots else []
    final_codeword = ctx.to_ints(current)
    for v in final_codeword:
        transcript.append(ctx.to_bytes_be(v))
    return _query_phase(config, codewords, trees, root_bytes, final_codeword, transcript)
