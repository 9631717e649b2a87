"""Fused sumcheck provers: every round, fold and Fiat-Shamir challenge on the
device, with no copy to the host between the first round and the last.

Counterpart of :mod:`tpu_zk.sumcheck.fused`.  ``tpu_zk`` compiles a whole
prove into one program; torch runs eagerly, so here each prover is a Python
loop that only *enqueues* work on the table's device.  A round is the fold
and the next round's sums (K2, then a small reduction) and one K7 launch
(:func:`tpu_zk_torch.transcript.kernels.sponge_round`: the round's elements
out of Montgomery form into their output slot, their bytes packed, absorbed
and squeezed), which writes the next challenge in Montgomery form where the
next fold reads it.  Nothing reads a device value on the
host inside the loop (no ``.item()``, no copy), so the host only launches
and the card never waits for it; the callers copy the results once, after
the loop.  Transcript bytes equal the host loop's (``tests/test_torch_fused.py``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields import arith
from ..fields.arith import FieldCtx, _limbs_of_int, field_ctx
from ..poly.composed import product_of_factors
from ..poly.multilinear import fold, fold_and_half_sums, sum_halves
from ..transcript.keccak import RATE
from ..transcript.kernels import sponge_round


def final_pos(pos: int, n_rounds: int, absorb_bytes: int) -> int:
    """The sponge's fill level after n rounds of (absorb k bytes, squeeze),
    known on the host without a copy."""
    for _ in range(n_rounds):
        pos = (pos + absorb_bytes) % RATE
        pos = (pos + 32) % RATE
    return pos


def _round_outputs(ctx: FieldCtx, n: int, width: int, device):
    """Per-round outputs: plain coefficients or evaluations [n, width, L],
    digests [n, 32] and Montgomery challenges [n, L]."""
    return (torch.empty((n, width, ctx.L), dtype=torch.int32, device=device),
            torch.empty((n, 32), dtype=torch.uint8, device=device),
            torch.empty((n, ctx.L), dtype=torch.int32, device=device))


def fused_basic_prove(ctx: FieldCtx, table: torch.Tensor, state: torch.Tensor, buf: torch.Tensor,
                      pos: torch.Tensor):
    """All n = log2(N) rounds of the basic sumcheck prover.

    table: [N, L] Montgomery.  (state, buf, pos): the device sponge, seeded
    with the initial polynomial's and the claimed sum's absorbs (done on the
    host through the native Keccak, cheaper than bringing the table's bytes
    back from the device); updated in place.

    Returns (univs_plain [n, 2, L], univs_mont [n, 2, L], digests [n, 32],
    state, buf).  Like the host loop, the last round folds nothing.
    """
    n = table.shape[0].bit_length() - 1
    univs_plain, digests, challenges = _round_outputs(ctx, n, 2, table.device)
    univs_mont = torch.empty_like(univs_plain)
    univ_m = sum_halves(ctx, table)
    for rnd in range(n):
        univs_mont[rnd] = univ_m
        sponge_round(state, buf, pos, univs_mont[rnd], univs_plain[rnd], digests[rnd], challenges[rnd], ctx,
                     big_endian=True)
        if rnd < n - 1:
            table, univ_m = fold_and_half_sums(ctx, table, challenges[rnd])
    return univs_plain, univs_mont, digests, state, buf


# ---------------------------------------------------------------------------
# the GKR-variant sumcheck (composed SumPolynomial working set)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _vandermonde_inv_mont(field_name: str, npoints: int) -> np.ndarray:
    """Inverse Vandermonde over x = 0..npoints-1 as Montgomery limbs
    [npoints, npoints, L] (uint32 16-bit limbs, ``tpu_zk``'s array):
    coefficients = Vinv @ evaluations, in place of the host Lagrange
    interpolation (``dense_univariate.rs:74-98``)."""
    ctx = field_ctx(field_name)
    p, n = ctx.p, npoints
    out = np.zeros((n, n, ctx.L), np.uint32)
    for k in range(n):
        # column k: the coefficients of the Lagrange basis polynomial l_k
        num = [1]
        for x in range(n):
            if x != k:
                nxt = [0] * (len(num) + 1)
                for i, c in enumerate(num):
                    nxt[i] = (nxt[i] - c * x) % p
                    nxt[i + 1] = (nxt[i + 1] + c) % p
                num = nxt
        denom = 1
        for x in range(n):
            if x != k:
                denom = denom * (k - x) % p
        dinv = pow(denom, p - 2, p)
        for j in range(n):
            out[j, k] = _limbs_of_int(num[j] * dinv % p * ctx.R % p, ctx.L)
    return out


@functools.lru_cache(maxsize=None)
def _vandermonde_on(field_name: str, npoints: int, device: torch.device) -> torch.Tensor:
    """:func:`_vandermonde_inv_mont` as an int32 tensor on ``device``, made
    once, so a warm prove copies nothing to the device."""
    return torch.from_numpy(_vandermonde_inv_mont(field_name, npoints).view(np.int32)).to(device)


def _round_lazy_sums(ctx: FieldCtx, stacked: torch.Tensor) -> torch.Tensor:
    """[p, k, N, L] working set -> int64 limb sums [k+1, L] of the round
    univariate's Montgomery evaluations at t = 0..k
    (``sumcheck_gkr_protocol.rs:113-143``: fold variable 0 at t, product
    over k, sum over p and the table).

    The sample points need no generic product (``tpu_zk/gkr/fused_sparse.py
    _round_lm`` :183-193): with d = hi - lo the factor tables at t are lo,
    hi, hi + d, hi + 2d, ... (K3), so each point costs the k - 1 collapse
    products (K1) and one exact int64 limb sum."""
    k, N = stacked.shape[1], stacked.shape[2]
    if N < 2:
        raise ValueError("round univariate: no variable left to sum over")
    lo, hi = stacked[:, :, : N // 2], stacked[:, :, N // 2 :]
    step = arith.sub(ctx, hi, lo)
    lazy = []
    point = lo
    for t in range(k + 1):
        if t == 1:
            point = hi
        elif t > 1:
            point = arith.add(ctx, point, step)
        prod = product_of_factors(ctx, point.unbind(1))
        lazy.append(prod.reshape(-1, ctx.L).sum(dim=0, dtype=torch.int64))
    return torch.stack(lazy)


def _round_evals_mont(ctx: FieldCtx, stacked: torch.Tensor) -> torch.Tensor:
    """[p, k, N, L] -> [k+1, L] Montgomery round-univariate evaluations at
    t = 0..k, on the working set's device (each lazy limb sums p N / 2
    16-bit limbs: below 2^48 up to 2^32 terms)."""
    return arith.lazy_to_mont(ctx, _round_lazy_sums(ctx, stacked))


def _interpolate_mont(ctx: FieldCtx, vinv: torch.Tensor, evals_m: torch.Tensor) -> torch.Tensor:
    """coeffs[j] = sum_k vinv[j, k] evals[k], all Montgomery [*, L]: one K1
    launch over the [n, n, L] products, then n - 1 K3 additions."""
    prods = arith.mont_mul(ctx, vinv, evals_m[None, :, :])
    acc = prods[:, 0]
    for k in range(1, prods.shape[1]):
        acc = arith.add(ctx, acc, prods[:, k])
    return acc


def fused_gkr_sumcheck_prove(ctx: FieldCtx, stacked: torch.Tensor, state: torch.Tensor, buf: torch.Tensor,
                             pos: torch.Tensor):
    """All rounds of the composed (degree-aware) sumcheck prover: per round
    evaluate at t = 0..degree, interpolate to coefficient form, absorb the
    little-endian coefficient bytes, squeeze the challenge, fold.

    Returns (coeffs_plain [n, d+1, L], digests [n, 32], state, buf, folded):
    ``tpu_zk``'s four outputs and the working set folded at every challenge,
    the last included (``tpu_zk`` skips that fold; the port's callers read
    each factor's value at the challenge point from it).  Transcript bytes
    equal the host loop's (``sumcheck_gkr_protocol.rs:24-67``).
    """
    n = stacked.shape[2].bit_length() - 1
    d = stacked.shape[1]
    vinv = _vandermonde_on(ctx.name, d + 1, stacked.device)
    coeffs, digests, challenges = _round_outputs(ctx, n, d + 1, stacked.device)
    for rnd in range(n):
        coeffs_m = _interpolate_mont(ctx, vinv, _round_evals_mont(ctx, stacked))
        sponge_round(state, buf, pos, coeffs_m, coeffs[rnd], digests[rnd], challenges[rnd], ctx, big_endian=False)
        stacked = fold(ctx, stacked, 0, challenges[rnd])
    return coeffs, digests, state, buf, stacked
