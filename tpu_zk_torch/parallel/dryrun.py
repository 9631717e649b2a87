"""The multi-device dry run: counterpart of ``dryrun_multichip`` in ``tpu_zk``'s
``__graft_entry__.py``.

It makes the same three checks over a mesh of ``n_devices`` shards: one
sharded sumcheck round (shard-local fold, cross-shard half sums), the
sharded MSM against the host's double-and-add, and the sharded sparse GKR
prove of a BLS12-381 Fr sum tree of depth 5 against the one-device prover.
Run it as ``python3 -m tpu_zk_torch.parallel.dryrun [n_devices] [device ...]``.
"""

from __future__ import annotations

import sys

from ..circuit.layered import ADD, tree_sum_circuit
from ..curves.ec_device import DeviceCurve
from ..fields.arith import field_ctx
from ..gkr import sparse
from . import sharded_gkr
from .mesh import make_mesh, replicated, shard_leading
from .sharded_msm import sharded_msm
from .sharded_sumcheck import _sharded_fold, _sharded_half_sums


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Run the three sharded paths over ``n_devices`` shards on ``devices``
    (default: this process's cards) and, after
    :func:`~.mesh.init_distributed`, over every process of the group, as
    ``tpu_zk``'s runs over ``jax.devices()``; assert each against one
    device, in every process."""
    mesh = make_mesh(n_devices, devices)
    D = mesh.size

    # a sharded sumcheck round: shard-local fold, cross-shard half sums
    ctx = field_ctx("bn254_fr")
    M = 8  # rows a shard
    shards = shard_leading(mesh, ctx.array([(i * 13 + 5) % 257 for i in range(D * M)], device=mesh.primary))
    univ = _sharded_half_sums(ctx, mesh, shards)
    folded = _sharded_fold(ctx, mesh, shards, replicated(mesh, ctx.scalar(999, device=mesh.primary)))
    assert tuple(univ.shape) == (2, ctx.L)
    assert all(tuple(folded[i].shape) == (M // 2, ctx.L) for i in mesh.local)

    # the sharded MSM (per-shard Pippenger, then a tree of the partial sums) against the host
    dc = DeviceCurve("bn254", device=mesh.primary)
    hc = dc.host
    g = hc.g1_generator()
    ks = list(range(1, D * 2 + 1))
    points = [hc.g1_affine(hc.g1_mul(g, k)) for k in ks]
    scalars = [7 * k + 3 for k in ks]
    assert sharded_msm(dc, mesh, points, scalars) == hc.g1_affine(hc.g1_mul(g, sum(k * s for k, s in zip(ks, scalars))))

    # the sharded sparse-GKR layer loop: the one-device prover's proof
    fr = field_ctx("bls12_381_fr")
    circuit = tree_sum_circuit(fr, 5, op=ADD)
    inputs = [(i * 13 + 5) % 89 for i in range(32)]
    p_sh = sharded_gkr.prove(circuit, inputs, mesh)
    p_ref = sparse.prove(circuit, inputs, device=mesh.primary)
    assert p_sh.claimed_sum == p_ref.claimed_sum
    for pa, pb in zip(p_sh.sumcheck_proofs, p_ref.sumcheck_proofs, strict=True):
        assert pa.random_challenges == pb.random_challenges
        assert [q.coefficients for q in pa.round_univariate_polynomials] == [
            q.coefficients for q in pb.round_univariate_polynomials
        ]


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else None, sys.argv[2:] or None)
    print("dryrun_multichip: ok")
