"""tpu_zk_torch's field layer held against tpu_zk's on the CPU.

Inputs come from ``numpy.random.default_rng`` and reach both packages as the
same numpy limb arrays (``tpu_zk_torch.utils.convert``).  All of this is
integer arithmetic, so every comparison is exact (tolerance zero).  On the
CPU the kernel wrappers run their plain versions; the CUDA kernels are held
against those plain versions on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_zk.fields import arith as jarith
from tpu_zk.fields import primes as jprimes
from tpu_zk_torch.fields import arith, kernels, primes
from tpu_zk_torch.poly import multilinear
from tpu_zk_torch.utils.convert import limbs_from_numpy, limbs_to_numpy

FIELDS = ["bn254_fq", "bn254_fr", "bls12_381_fr", "bls12_381_fq"]


def limbs_np(vals, width):
    """Python ints -> uint32 [n, width] 16-bit limbs."""
    return np.array([[(v >> (16 * i)) & 0xFFFF for i in range(width)] for v in vals], dtype=np.uint32)


def rand_vals(ctx, n, rng):
    return [int.from_bytes(rng.bytes(2 * ctx.L), "little") % ctx.p for _ in range(n)]


def edges(ctx):
    return [0, 1, ctx.p - 1, ctx.R % ctx.p]


def pair(arr):
    """The same numpy limbs as a JAX array and as a port tensor."""
    return jnp.asarray(arr), limbs_from_numpy(arr)


def same(jax_out, port_out):
    return np.array_equal(np.asarray(jax_out), limbs_to_numpy(port_out))


def operands(name, seed):
    """Random canonical pairs plus every pair of edge values."""
    ctx = arith.field_ctx(name)
    rng = np.random.default_rng(seed)
    e = edges(ctx)
    xs = rand_vals(ctx, 48, rng) + [x for x in e for _ in e]
    ys = rand_vals(ctx, 48, rng) + [y for _ in e for y in e]
    return ctx, jarith.field_ctx(name), limbs_np(xs, ctx.L), limbs_np(ys, ctx.L)


def test_constants_match_tpu_zk():
    assert primes.PRIMES == jprimes.PRIMES
    assert primes.SERIALIZED_BYTES == jprimes.SERIALIZED_BYTES
    for name in FIELDS:
        ctx, jctx = arith.field_ctx(name), jarith.field_ctx(name)
        assert (ctx.p, ctx.L, ctx.nbytes, ctx.n0inv, ctx.R, ctx.R2, ctx.Rinv) == (
            jctx.p, jctx.L, jctx.nbytes, jctx.n0inv, jctx.R, jctx.R2, jctx.Rinv,
        )
        assert (ctx.p * ctx.n0inv32 + 1) % (1 << 32) == 0


@pytest.mark.parametrize("name", FIELDS)
def test_mont_mul_matches_tpu_zk(name):
    ctx, jctx, a, b = operands(name, 1)
    (ja, ta), (jb, tb) = pair(a), pair(b)
    assert same(jarith.mont_mul(jctx, ja, jb), arith.mont_mul(ctx, ta, tb))
    # broadcast scalar, on either side
    s = limbs_np([ctx.to_mont_int(987654321987654321)], ctx.L)[0]
    assert same(jarith.mont_mul(jctx, ja, jnp.asarray(s)), arith.mont_mul(ctx, ta, limbs_from_numpy(s)))
    assert same(jarith.mont_mul(jctx, ja, jnp.asarray(s)), arith.mont_mul(ctx, limbs_from_numpy(s), ta))


@pytest.mark.parametrize("name", FIELDS)
def test_add_sub_match_tpu_zk(name):
    ctx, jctx, a, b = operands(name, 2)
    (ja, ta), (jb, tb) = pair(a), pair(b)
    assert same(jarith.add(jctx, ja, jb), arith.add(ctx, ta, tb))
    assert same(jarith.sub(jctx, ja, jb), arith.sub(ctx, ta, tb))


@pytest.mark.parametrize("name", FIELDS)
def test_to_from_mont_match_tpu_zk(name):
    ctx, jctx, a, _ = operands(name, 3)
    ja, ta = pair(a)
    assert same(jarith.to_mont(jctx, ja), arith.to_mont(ctx, ta))
    assert same(jarith.from_mont(jctx, ja), arith.from_mont(ctx, ta))
    assert arith.from_mont(ctx, arith.to_mont(ctx, ta)).equal(ta)


@pytest.mark.parametrize("name", FIELDS)
def test_sum_mod_matches_tpu_zk(name):
    ctx, jctx, a, b = operands(name, 4)
    both = np.concatenate([a, b])
    jt, tt = pair(both)
    assert same(jarith.sum_mod(jctx, jt), arith.sum_mod(ctx, tt))
    halves = both.reshape(2, -1, ctx.L)
    jh, th = pair(halves)
    assert same(jarith.sum_mod(jctx, jh, 1), arith.sum_mod(ctx, th, axis=1))


@pytest.mark.parametrize("name", FIELDS)
def test_carry_propagate_matches_tpu_zk(name):
    ctx = arith.field_ctx(name)
    rng = np.random.default_rng(5)
    W = ctx.L + 2
    lazy = rng.integers(0, 1 << 31, size=(40, W), dtype=np.uint32)
    lazy[0] = 0xFFFF  # a carry that ripples through every limb
    lazy[1] = 0
    got = arith.carry_propagate(torch.from_numpy(lazy.astype(np.int64)), W + 2)
    assert same(jarith.carry_propagate(jnp.asarray(lazy), W + 2), got)


@pytest.mark.parametrize("name", FIELDS)
def test_reduce_wide_to_mont_matches_tpu_zk(name):
    ctx, jctx = arith.field_ctx(name), jarith.field_ctx(name)
    rng = np.random.default_rng(6)
    bound = 1 << (16 * (ctx.L + 4))  # L+4 limbs, below the contract's R*p
    vals = [int.from_bytes(rng.bytes(2 * ctx.L + 8), "little") for _ in range(30)]
    vals += [0, 1, ctx.p, bound - 1]
    wide = limbs_np(vals, ctx.L + 4)
    jw, tw = pair(wide)
    got = arith.reduce_wide_to_mont(ctx, tw)
    assert same(jarith.reduce_wide_to_mont(jctx, jw), got)
    assert ctx.to_ints(got, mont=False) == [v % ctx.p for v in vals]


def test_mont_mul_plain_matches_pallas_kernel():
    """K1's plain version against mont_mul_pallas in interpret mode."""
    from tpu_zk.fields.pallas_kernels import mont_mul_pallas

    ctx, jctx = arith.field_ctx("bn254_fr"), jarith.field_ctx("bn254_fr")
    rng = np.random.default_rng(7)
    vals = rand_vals(ctx, 2048 - 16, rng)
    e = edges(ctx)
    a = limbs_np(vals + [x for x in e for _ in e], ctx.L)
    b = limbs_np(vals[::-1] + [y for _ in e for y in e], ctx.L)
    (ja, ta), (jb, tb) = pair(a), pair(b)
    assert same(mont_mul_pallas(jctx, ja, jb, 1024), kernels.mont_mul_plain(ctx, ta, tb))


def _fold_inputs(name, n, seed):
    ctx, jctx = arith.field_ctx(name), jarith.field_ctx(name)
    rng = np.random.default_rng(seed)
    table = limbs_np([ctx.to_mont_int(v) for v in rand_vals(ctx, n, rng)], ctx.L)
    r = limbs_np([ctx.to_mont_int(123456789123456789)], ctx.L)[0]
    return ctx, jctx, table, r


@pytest.mark.parametrize("name", ["bn254_fr", "bls12_381_fq"])
def test_fold_and_half_sums_match_tpu_zk(name):
    """K2's plain version, and the round built on it, against tpu_zk's round."""
    from tpu_zk.poly.multilinear import fold_and_half_sums as j_fold_and_half_sums

    ctx, jctx, table, r = _fold_inputs(name, 256, 8)
    (jt, tt), (jr, tr) = pair(table), pair(r)
    ref_folded, ref_univ = j_fold_and_half_sums(jctx, jt, jr)
    folded, univ = multilinear.fold_and_half_sums(ctx, tt, tr)
    assert same(ref_folded, folded)
    assert same(ref_univ, univ)
    plain_folded, _ = kernels.fold_plain(ctx, tt[None], tr, 32)
    assert same(ref_folded, plain_folded[0])


def test_fold_plain_matches_fold_pallas():
    """K2's plain version against fold_pallas (interpret mode), block sums included."""
    from tpu_zk.fields.pallas_kernels import fold_pallas

    ctx, jctx, table, r = _fold_inputs("bn254_fr", 2048, 9)
    (jt, tt), (jr, tr) = pair(table), pair(r)
    ref_folded, ref_sums = fold_pallas(jctx, jt[None], jr, 256)
    folded, sums = kernels.fold_plain(ctx, tt[None], tr, 256)
    assert sums.shape == (1, 4, ctx.L + 2)
    assert same(ref_folded, folded)
    assert same(ref_sums, sums)


def test_fold_plain_matches_fold_mxu_lm():
    """K2's plain version against the limb-major digit-matmul fold (interpret mode)."""
    from tpu_zk.fields.mxu_mul import fold_mxu_lm

    ctx, jctx, table, r = _fold_inputs("bn254_fr", 1 << 10, 10)
    (jt, tt), (jr, tr) = pair(table), pair(r)
    ref_folded, ref_sums = fold_mxu_lm(jctx, jt.T[None], jr, 128)
    folded, sums = kernels.fold_plain(ctx, tt[None], tr, 128)
    assert same(ref_folded[0].T, folded[0])
    assert same(ref_sums, sums)


@pytest.mark.parametrize("T,block", [(1, 1), (3, 2), (37, 8), (64, 64)])
def test_fold_plain_ragged_blocks(T, block):
    """Per-block sums with a ragged tail, batched rows, against Python ints."""
    ctx = arith.field_ctx("bn254_fq")
    rng = np.random.default_rng(T)
    B = 3
    vals = [[ctx.to_mont_int(v) for v in rand_vals(ctx, 2 * T, rng)] for _ in range(B)]
    flat = limbs_from_numpy(np.stack([limbs_np(v, ctx.L) for v in vals]))
    rv = rand_vals(ctx, 1, rng)[0]
    folded, sums = kernels.fold(ctx, flat, ctx.scalar(rv), block)
    G = -(-T // block)
    assert sums.shape == (B, G, ctx.L + 2)
    for b in range(B):
        # Montgomery residues fold like plain ones: lo_m + r*(hi_m - lo_m)
        want = [(lo + rv * (hi - lo)) % ctx.p for lo, hi in zip(vals[b][:T], vals[b][T:])]
        got = ctx.to_ints(folded[b], mont=False)
        assert got == want
        for g in range(G):
            block_sum = sum(want[g * block : (g + 1) * block])
            assert sum(int(v) << (16 * k) for k, v in enumerate(sums[b, g].tolist())) == block_sum


def test_wrappers_check_inputs():
    ctx = arith.field_ctx("bn254_fr")
    a = ctx.array([1, 2, 3])
    with pytest.raises(TypeError):
        kernels.mont_mul(ctx, a.to(torch.int64), a)
    with pytest.raises(ValueError):
        kernels.mont_mul(ctx, a, a[:2])
    with pytest.raises(ValueError):
        kernels.fold(ctx, a[None], ctx.scalar(1), kernels.MAX_FOLD_BLOCK + 1)
    # a tensor that is not on the CPU never takes the plain path
    meta = torch.empty((4, ctx.L), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        kernels.mont_mul(ctx, meta, meta)
    with pytest.raises(ValueError):
        kernels.fold(ctx, meta[None], torch.empty(ctx.L, dtype=torch.int32, device="meta"), 2)
