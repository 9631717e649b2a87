"""Sharded linear-time (Libra) GKR prover: gates and working sets over a mesh.

Counterpart of :mod:`tpu_zk.parallel.sharded_gkr`.  ``tpu_zk``'s builds on
its fused prover's pool of compiled programs; this one builds on the port's
prover, :mod:`tpu_zk_torch.gkr.sparse` (its phase tables, its layer loop
:class:`~tpu_zk_torch.gkr.sparse.LayerProver`, and the rounds of
:mod:`tpu_zk_torch.sumcheck.fused`):

  - **gates** are cut into D blocks of consecutive gates, the last padded
    with no-op ADD gates whose output weight is zeroed, so padding adds
    exact zeros;
  - **segment sums**: each shard sums its gates' terms into int64 lazy limb
    sums over all S buckets (``mont_segment_sum``'s ``index_add_``); each
    shard's bucket block is the sum of every shard's lazy block
    (:func:`.mesh.reduce_scatter`), reduced once, so the tables are the
    one-device tables exactly.  A bucket sums
    at most G terms of 16-bit limbs: exact below 2^47 gates;
  - **the working set** ``[p, k, S, L]`` is interleaved: the low
    ``log2(D)`` index bits are the shard axis (shard d holds rows
    j D + d), so every fold of the top variable stays on one shard (K2);
  - **each round** adds the shards' lazy sums of the round univariate's
    evaluations (``fused._round_lazy_sums``: p S / 2 terms in all, below
    2^48 a limb up to S = 2^31, as on one device) and reduces them once
    (``lazy_to_mont``); the interpolated Montgomery coefficients are
    replicated and absorbed on the replicated device sponge, one K7 round
    launch on each distinct device of every process (each takes them out of
    Montgomery form itself), and each shard folds at its device's challenge;
  - **the last log2(D) rounds** of each phase run on the gathered D-row
    working set, gathered on every process's primary
    (:func:`fused.fused_gkr_sumcheck_prove` with the primary's sponge);
    each process's host transcript is re-synced from it at the end of the
    phase and seeds the next phase's replicas.

Layers narrower than 2D rows take the one-device layer sumcheck, as in
``tpu_zk``.  The proof (claimed sums, wb/wc evaluations, challenges,
coefficients) equals :func:`tpu_zk_torch.gkr.sparse.prove`'s.
"""

from __future__ import annotations

import torch

from ..circuit.layered import Circuit, Layer
from ..fields import arith
from ..fields.arith import FieldCtx
from ..gkr import sparse
from ..gkr.protocol import Proof
from ..poly.multilinear import fold
from ..poly.univariate import DenseUnivariatePolynomial
from ..sumcheck import fused
from ..sumcheck.gkr_sumcheck import SumcheckProverProof
from ..transcript.device_fs import DeviceSponge
from ..transcript.fiat_shamir import Transcript
from ..transcript.kernels import sponge_round
from .mesh import Mesh, copy_to, cross_shard_sum, gather, reduce_scatter, replicated, scatter


def _interleave(mesh: Mesh, table: torch.Tensor) -> list:
    """[S, L] logical -> D shards [S/D, L]: shard d, row j = logical row j D + d."""
    S, L = table.shape
    t = table.view(S // mesh.size, mesh.size, L)
    return scatter(mesh, lambda d: t[:, d].contiguous())


def _pad_gates(mesh: Mesh, layer: Layer) -> list:
    """The layer's gates in D blocks of ceil(G/D), each on its shard's device:
    (lefts, rights, outs, is_add [g, 1], valid [g, 1] or None).  The last
    blocks are padded with gate (0, 0, 0, ADD), valid False; the others are
    views of the layer's cached device arrays."""
    G, D = len(layer.lefts), mesh.size
    per = -(-G // D)

    def block(k: int, dev: torch.device):
        lo, hi = min(k * per, G), min((k + 1) * per, G)
        lefts, rights, outs, is_add = (t[lo:hi] for t in layer.on(dev))
        pad = per - (hi - lo)
        valid = None
        if pad:
            zeros = torch.zeros(pad, dtype=torch.int64, device=dev)
            lefts, rights, outs = (torch.cat([t, zeros]) for t in (lefts, rights, outs))
            is_add = torch.cat([is_add, torch.ones((pad, 1), dtype=torch.bool, device=dev)])
            valid = (torch.arange(per, device=dev) < hi - lo)[:, None]
        return lefts, rights, outs, is_add, valid

    return mesh.map(block)


def _mask_rows(x: torch.Tensor, valid: torch.Tensor | None) -> torch.Tensor:
    """Zero the rows of padding gates."""
    return x if valid is None else torch.where(valid, x, 0)


def _segment_sums(ctx: FieldCtx, mesh: Mesh, terms: list, S: int) -> list:
    """Each shard's gate terms and interleaved buckets ``terms[k] = ([g, 2,
    L], [g])`` (bucket d M + j is logical row j D + d) -> D shards [M, 2, L]
    of the exact Montgomery sums: each shard's int64 lazy sums over all S
    buckets, one table at a time, reduce-scattered (shard d gets buckets
    d M .. d M + M - 1 of every shard's table, added before one
    reduction)."""

    def lazy_tables():
        for k in mesh.local:
            vals, buckets = terms[k]
            lazy = torch.zeros((S,) + vals.shape[1:], dtype=torch.int64, device=mesh.devices[k])
            lazy.index_add_(0, buckets, vals.to(torch.int64))
            yield lazy
            del lazy

    acc = reduce_scatter(mesh, lazy_tables())
    return mesh.map(lambda d, dev: arith.reduce_lazy(ctx, acc[d]))


def _phase1_sharded(ctx: FieldCtx, mesh: Mesh, gates: list, w_rep: dict, w_int: list, w_out: list,
                    S: int) -> list:
    """Phase-1 working sets [2, 2, M, L] on each shard, [[w, A1 + M1], [A2, 1]]
    (``sparse._phase1_tables`` on each shard's gates)."""
    D, M = mesh.size, S // mesh.size

    def terms(k: int, dev: torch.device):
        lefts, rights, _, is_add, _ = gates[k]
        wo = w_out[k]
        wr = arith.mont_mul(ctx, wo, w_rep[dev][rights])
        return (torch.stack([torch.where(is_add, wo, wr), torch.where(is_add, wr, 0)], dim=1),
                (lefts % D) * M + lefts // D)

    tables = _segment_sums(ctx, mesh, mesh.map(terms), S)
    return mesh.map(lambda k, dev: torch.stack([torch.stack([w_int[k], tables[k][:, 0]]),
                                                torch.stack([tables[k][:, 1], ctx.one_mont(dev).expand(M, ctx.L)])]))


def _phase2_sharded(ctx: FieldCtx, mesh: Mesh, gates: list, w_int: list, w_out: list, b_star: list[int],
                    wb_m: torch.Tensor, S: int) -> list:
    """Phase-2 working sets [2, 2, M, L], [[A', w(b*) + w], [M' w(b*), w]]
    (``sparse._phase2_tables`` on each shard's gates)."""
    D, M = mesh.size, S // mesh.size
    eq_b = {dev: sparse.eq_table(ctx, b_star, dev) for dev in mesh.distinct}
    wb = replicated(mesh, wb_m)

    def terms(k: int, dev: torch.device):
        lefts, rights, _, is_add, _ = gates[k]
        w_eq = arith.mont_mul(ctx, w_out[k], eq_b[dev][lefts])
        return (torch.stack([torch.where(is_add, w_eq, 0), torch.where(is_add, 0, w_eq)], dim=1),
                (rights % D) * M + rights // D)

    tables = _segment_sums(ctx, mesh, mesh.map(terms), S)
    return mesh.map(lambda k, dev: torch.stack([
        torch.stack([tables[k][:, 0], arith.add(ctx, w_int[k], wb[dev])]),
        torch.stack([arith.mont_mul(ctx, tables[k][:, 1], wb[dev]), w_int[k]])]))


def _round_sharded(ctx: FieldCtx, mesh: Mesh, stacked: list, vinv: torch.Tensor, sponges: dict,
                   coeffs: torch.Tensor, digest: torch.Tensor, challenge: torch.Tensor) -> list:
    """One round over the interleaved working sets [p, k, M, L]: the shards'
    lazy sums added and reduced once, the coefficients interpolated and
    replicated in Montgomery form, and absorbed LE on every replica of the
    sponge (the primary's writes the plain ``coeffs`` [k+1, L], ``digest``
    and ``challenge``), and each shard's fold at its device's challenge
    (K2)."""
    lazy = cross_shard_sum(mesh, mesh.map(lambda k, dev: fused._round_lazy_sums(ctx, stacked[k])))
    coeffs_m = replicated(mesh, fused._interpolate_mont(ctx, vinv, arith.lazy_to_mont(ctx, lazy)))
    r = {}
    for dev, sponge in sponges.items():
        if dev == mesh.primary:
            slot, d, r[dev] = coeffs, digest, challenge
        else:
            slot = torch.empty_like(coeffs_m[dev])
            d = torch.empty(32, dtype=torch.uint8, device=dev)
            r[dev] = torch.empty(ctx.L, dtype=torch.int32, device=dev)
        sponge_round(sponge.state, sponge.buf, sponge.pos, coeffs_m[dev], slot, d, r[dev], ctx, big_endian=False)
    return mesh.map(lambda k, dev: fold(ctx, stacked[k], 0, r[dev]))


def _run_phase_rounds(ctx: FieldCtx, mesh: Mesh, stacked: list, transcript: Transcript,
                      claimed_sum: int) -> tuple[SumcheckProverProof, torch.Tensor]:
    """All s = log2(S) rounds of one phase: sharded while each shard holds
    two rows or more, then the D rows on the primary.  Returns the phase's
    proof and the working set folded at every challenge ([p, k, 1, L])."""
    D, (_, k, M, _) = mesh.size, stacked[mesh.local[0]].shape
    n_sharded = M.bit_length() - 1
    n = n_sharded + D.bit_length() - 1
    width = k + 1
    vinv = fused._vandermonde_on(ctx.name, width, mesh.primary)
    hasher = transcript._hasher
    sponges = {dev: DeviceSponge.from_host(hasher, dev) for dev in mesh.distinct}
    coeffs, digests, challenges = fused._round_outputs(ctx, n_sharded, width, mesh.primary)
    for rnd in range(n_sharded):
        stacked = _round_sharded(ctx, mesh, stacked, vinv, sponges, coeffs[rnd], digests[rnd], challenges[rnd])
    primary = sponges[mesh.primary]
    tail_coeffs, tail_digests, state, buf, folded = fused.fused_gkr_sumcheck_prove(
        ctx, gather(mesh, stacked, dim=2), primary.state, primary.buf, primary.pos)
    flat = ctx.to_ints(torch.cat([coeffs, tail_coeffs]).reshape(-1, ctx.L), mont=False)
    transcript._hasher = DeviceSponge.to_host(state, buf, fused.final_pos(len(hasher._buf), n, width * ctx.nbytes))
    proof = SumcheckProverProof(
        claimed_sum=claimed_sum,
        round_univariate_polynomials=[DenseUnivariatePolynomial(ctx, flat[i * width : (i + 1) * width])
                                      for i in range(n)],
        random_challenges=[ctx.from_le_bytes_mod_order(bytes(d))
                           for d in torch.cat([digests, tail_digests]).cpu().numpy()],
    )
    return proof, folded


class ShardedLayerProver(sparse.LayerProver):
    """:class:`~tpu_zk_torch.gkr.sparse.LayerProver` with each layer of 2D
    rows or more proved over the mesh."""

    def __init__(self, circuit: Circuit, ev, mesh: Mesh):
        super().__init__(circuit, ev)
        self.mesh = mesh

    def _layer_sumcheck(self, layer_index: int):
        ctx, mesh = self.ctx, self.mesh
        w_table = self.ev.layer_tables[layer_index + 1]
        S = w_table.shape[0]
        if S & (S - 1):
            raise ValueError(f"layer table of {S} entries: GKR needs a power of two")
        if S < 2 * mesh.size or S % mesh.size:
            return super()._layer_sumcheck(layer_index)  # too narrow to shard, as in tpu_zk
        layer = self.circuit.layers[layer_index]
        gates = _pad_gates(mesh, layer)
        weights = {dev: sparse._out_weight_table(ctx, layer_index, self.random_challenge_a, self.alpha, self.beta,
                                                 self.rb_values, self.rc_values, dev) for dev in mesh.distinct}
        w_out = mesh.map(lambda k, dev: _mask_rows(weights[dev][gates[k][2]], gates[k][4]))
        w_int = _interleave(mesh, w_table)

        self.transcript.append(ctx.to_bytes_be(self.claimed_sum))
        stacked = _phase1_sharded(ctx, mesh, gates, replicated(mesh, w_table), w_int, w_out, S)
        ph1, done1 = _run_phase_rounds(ctx, mesh, stacked, self.transcript, self.claimed_sum)
        wb_m = done1[0, 0, 0]
        stacked = _phase2_sharded(ctx, mesh, gates, w_int, w_out, ph1.random_challenges, wb_m, S)
        ph2, done2 = _run_phase_rounds(ctx, mesh, stacked, self.transcript, self.claimed_sum)
        proof = SumcheckProverProof(
            claimed_sum=self.claimed_sum,
            round_univariate_polynomials=ph1.round_univariate_polynomials + ph2.round_univariate_polynomials,
            random_challenges=ph1.random_challenges + ph2.random_challenges,
        )
        return proof, wb_m, done2[1, 1, 0]


def prove(circuit: Circuit, inputs, mesh: Mesh) -> Proof:
    """Sharded linear-time GKR prove; the same Proof and bytes as
    :func:`tpu_zk_torch.gkr.sparse.prove`.  ``inputs``: a Montgomery
    [N, L] tensor or host ints; the circuit is evaluated on the primary."""
    if isinstance(inputs, torch.Tensor):
        inputs = copy_to(inputs, mesh.primary)
    ev = circuit.evaluate(inputs, materialize=False, device=mesh.primary)
    prover = ShardedLayerProver(circuit, ev, mesh)
    while not prover.done:
        prover.step()
    return prover.proof()
