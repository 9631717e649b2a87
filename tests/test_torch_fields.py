"""tpu_zk_torch's field layer held against tpu_zk's on the CPU.

Inputs come from ``numpy.random.default_rng`` and reach both packages as the
same numpy limb arrays (``tpu_zk_torch.utils.convert``).  All of this is
integer arithmetic, so every comparison is exact (tolerance zero).  On the
CPU the kernel wrappers run their plain versions; the CUDA kernels are held
against those plain versions on the card by ``chip_smoke.py``.

Every compiled tpu_zk computation runs once, in :func:`reference`, which the
module fixture calls in a fresh process (``tests/jax_reference.py``); the
tests here compare the port against its results.
"""

import numpy as np
import pytest
import torch

from tests import jax_reference
from tpu_zk.fields import arith as jarith
from tpu_zk.fields import primes as jprimes
from tpu_zk_torch import device as tdevice
from tpu_zk_torch.fields import arith, kernels, primes
from tpu_zk_torch.poly import multilinear
from tpu_zk_torch.utils.convert import limbs_from_numpy, limbs_to_numpy

tdevice.set_default_device("cpu")  # these tests run the plain versions, on the CPU
torch.set_num_threads(1)  # small tensors: more threads only take cores from the other test workers

FIELDS = ["bn254_fq", "bn254_fr", "bls12_381_fr", "bls12_381_fq"]
FOLD_FIELDS = ["bn254_fr", "bls12_381_fq"]
MXU_FIELDS = ["bn254_fr", "bls12_381_fr"]
MXU_SCALARS = [987654321987654321, 0, 1, -1]


def limbs_np(vals, width):
    """Python ints -> uint32 [n, width] 16-bit limbs."""
    return np.array([[(v >> (16 * i)) & 0xFFFF for i in range(width)] for v in vals], dtype=np.uint32)


def rand_vals(ctx, n, rng):
    return [int.from_bytes(rng.bytes(2 * ctx.L), "little") % ctx.p for _ in range(n)]


def edges(ctx):
    return [0, 1, ctx.p - 1, ctx.R % ctx.p]


def same(want, port_out):
    return np.array_equal(np.asarray(want), limbs_to_numpy(port_out))


def operands(name, seed):
    """Random canonical pairs plus every pair of edge values."""
    ctx = arith.field_ctx(name)
    rng = np.random.default_rng(seed)
    e = edges(ctx)
    xs = rand_vals(ctx, 48, rng) + [x for x in e for _ in e]
    ys = rand_vals(ctx, 48, rng) + [y for _ in e for y in e]
    return ctx, limbs_np(xs, ctx.L), limbs_np(ys, ctx.L)


def _mont_scalar(ctx, c):
    return limbs_np([ctx.to_mont_int(c)], ctx.L)[0]


def _carry_input(name):
    ctx = arith.field_ctx(name)
    rng = np.random.default_rng(5)
    W = ctx.L + 2
    lazy = rng.integers(0, 1 << 31, size=(40, W), dtype=np.uint32)
    lazy[0] = 0xFFFF  # a carry that ripples through every limb
    lazy[1] = 0
    return lazy


def _wide_input(name):
    """(wide limbs [n, L+4], their values): L+4 limbs, below the contract's R*p."""
    ctx = arith.field_ctx(name)
    rng = np.random.default_rng(6)
    bound = 1 << (16 * (ctx.L + 4))
    vals = [int.from_bytes(rng.bytes(2 * ctx.L + 8), "little") for _ in range(30)]
    vals += [0, 1, ctx.p, bound - 1]
    return limbs_np(vals, ctx.L + 4), vals


def _pallas_operands():
    ctx = arith.field_ctx("bn254_fr")
    rng = np.random.default_rng(7)
    vals = rand_vals(ctx, 2048 - 16, rng)
    e = edges(ctx)
    return limbs_np(vals + [x for x in e for _ in e], ctx.L), limbs_np(vals[::-1] + [y for _ in e for y in e], ctx.L)


def _fold_inputs(name, n, seed):
    ctx = arith.field_ctx(name)
    rng = np.random.default_rng(seed)
    table = limbs_np([ctx.to_mont_int(v) for v in rand_vals(ctx, n, rng)], ctx.L)
    return ctx, table, _mont_scalar(ctx, 123456789123456789)


def _mxu_operands(name):
    """Random elements plus the edge values, and the broadcast Montgomery scalars."""
    ctx = arith.field_ctx(name)
    a = limbs_np(rand_vals(ctx, 240, np.random.default_rng(13)) + edges(ctx) * 4, ctx.L)
    return a, [_mont_scalar(ctx, c) for c in MXU_SCALARS]


def reference() -> dict:
    """Everything the tests compare against, computed by tpu_zk (in the
    child process): the field operations per field, and the Pallas kernels
    in interpret mode -- mont_mul_pallas, fold_pallas, fold_mxu_lm, and the
    caller-less digit-matmul kernels fold_mxu_pallas (on a [2, 512, L]
    table) and mul_const_mxu_pallas (each scalar of MXU_SCALARS)."""
    import jax.numpy as jnp

    from tpu_zk.fields.mxu_mul import fold_mxu_lm, fold_mxu_pallas, mul_const_mxu_pallas
    from tpu_zk.fields.pallas_kernels import fold_pallas, mont_mul_pallas
    from tpu_zk.poly.multilinear import fold_and_half_sums

    def host(*xs):
        return tuple(np.asarray(x) for x in xs)

    out = {}
    for name in FIELDS:
        jctx = jarith.field_ctx(name)
        ctx, a, b = operands(name, 1)
        ja, jb, js = jnp.asarray(a), jnp.asarray(b), jnp.asarray(_mont_scalar(ctx, 987654321987654321))
        out["mont_mul", name] = host(jarith.mont_mul(jctx, ja, jb), jarith.mont_mul(jctx, ja, js))
        _, a, b = operands(name, 2)
        out["add_sub", name] = host(jarith.add(jctx, jnp.asarray(a), jnp.asarray(b)),
                                    jarith.sub(jctx, jnp.asarray(a), jnp.asarray(b)))
        _, a, _ = operands(name, 3)
        out["to_from_mont", name] = host(jarith.to_mont(jctx, jnp.asarray(a)), jarith.from_mont(jctx, jnp.asarray(a)))
        _, a, b = operands(name, 4)
        both = np.concatenate([a, b])
        out["sum_mod", name] = host(jarith.sum_mod(jctx, jnp.asarray(both)),
                                    jarith.sum_mod(jctx, jnp.asarray(both.reshape(2, -1, ctx.L)), 1))
        lazy = _carry_input(name)
        out["carry", name] = np.asarray(jarith.carry_propagate(jnp.asarray(lazy), lazy.shape[1] + 2))
        out["reduce_wide", name] = np.asarray(jarith.reduce_wide_to_mont(jctx, jnp.asarray(_wide_input(name)[0])))

    jctx = jarith.field_ctx("bn254_fr")
    a, b = _pallas_operands()
    out["mont_mul_pallas"] = np.asarray(mont_mul_pallas(jctx, jnp.asarray(a), jnp.asarray(b), 1024))
    for name in FOLD_FIELDS:
        _, table, r = _fold_inputs(name, 256, 8)
        out["fold_and_half_sums", name] = host(*fold_and_half_sums(jarith.field_ctx(name), jnp.asarray(table),
                                                                   jnp.asarray(r)))
    _, table, r = _fold_inputs("bn254_fr", 2048, 9)
    out["fold_pallas"] = host(*fold_pallas(jctx, jnp.asarray(table)[None], jnp.asarray(r), 256))
    _, table, r = _fold_inputs("bn254_fr", 1 << 10, 10)
    folded, sums = fold_mxu_lm(jctx, jnp.asarray(table).T[None], jnp.asarray(r), 128)
    out["fold_mxu_lm"] = host(folded[0].T, sums)
    _, table, r = _fold_inputs("bn254_fr", 1 << 10, 12)
    out["fold_mxu_pallas"] = host(*fold_mxu_pallas(jctx, jnp.asarray(table.reshape(2, 512, -1)), jnp.asarray(r), 128))
    for name in MXU_FIELDS:
        a, scalars = _mxu_operands(name)
        out["mul_const_mxu_pallas", name] = [
            np.asarray(mul_const_mxu_pallas(jarith.field_ctx(name), jnp.asarray(a), jnp.asarray(s), 128))
            for s in scalars
        ]
    return out


@pytest.fixture(scope="module")
def ref():
    return jax_reference.call("tests.test_torch_fields", "reference")


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
def test_mont_mul_matches_tpu_zk(name, ref):
    ctx, a, b = operands(name, 1)
    ta, tb = limbs_from_numpy(a), limbs_from_numpy(b)
    want_ab, want_as = ref["mont_mul", name]
    assert same(want_ab, arith.mont_mul(ctx, ta, tb))
    # broadcast scalar, on either side
    s = limbs_from_numpy(_mont_scalar(ctx, 987654321987654321))
    assert same(want_as, arith.mont_mul(ctx, ta, s))
    assert same(want_as, arith.mont_mul(ctx, s, ta))


@pytest.mark.parametrize("name", FIELDS)
def test_add_sub_match_tpu_zk(name, ref):
    ctx, a, b = operands(name, 2)
    ta, tb = limbs_from_numpy(a), limbs_from_numpy(b)
    want_add, want_sub = ref["add_sub", name]
    assert same(want_add, arith.add(ctx, ta, tb))
    assert same(want_sub, arith.sub(ctx, ta, tb))


@pytest.mark.parametrize("name", FIELDS)
def test_to_from_mont_match_tpu_zk(name, ref):
    ctx, a, _ = operands(name, 3)
    ta = limbs_from_numpy(a)
    want_to, want_from = ref["to_from_mont", name]
    assert same(want_to, arith.to_mont(ctx, ta))
    assert same(want_from, arith.from_mont(ctx, ta))
    assert arith.from_mont(ctx, arith.to_mont(ctx, ta)).equal(ta)


@pytest.mark.parametrize("name", FIELDS)
def test_sum_mod_matches_tpu_zk(name, ref):
    ctx, a, b = operands(name, 4)
    both = np.concatenate([a, b])
    want_all, want_halves = ref["sum_mod", name]
    assert same(want_all, arith.sum_mod(ctx, limbs_from_numpy(both)))
    assert same(want_halves, arith.sum_mod(ctx, limbs_from_numpy(both.reshape(2, -1, ctx.L)), axis=1))


@pytest.mark.parametrize("name", FIELDS)
def test_carry_propagate_matches_tpu_zk(name, ref):
    lazy = _carry_input(name)
    got = arith.carry_propagate(torch.from_numpy(lazy.astype(np.int64)), lazy.shape[1] + 2)
    assert same(ref["carry", name], got)


@pytest.mark.parametrize("name", FIELDS)
def test_reduce_wide_to_mont_matches_tpu_zk(name, ref):
    ctx = arith.field_ctx(name)
    wide, vals = _wide_input(name)
    got = arith.reduce_wide_to_mont(ctx, limbs_from_numpy(wide))
    assert same(ref["reduce_wide", name], got)
    assert ctx.to_ints(got, mont=False) == [v % ctx.p for v in vals]


def test_mont_mul_plain_matches_pallas_kernel(ref):
    """K1's plain version against mont_mul_pallas in interpret mode."""
    ctx = arith.field_ctx("bn254_fr")
    a, b = _pallas_operands()
    assert same(ref["mont_mul_pallas"], kernels.mont_mul_plain(ctx, limbs_from_numpy(a), limbs_from_numpy(b)))


@pytest.mark.parametrize("name", FOLD_FIELDS)
def test_fold_and_half_sums_match_tpu_zk(name, ref):
    """K2's plain version, and the round built on it, against tpu_zk's round."""
    ctx, table, r = _fold_inputs(name, 256, 8)
    tt, tr = limbs_from_numpy(table), limbs_from_numpy(r)
    ref_folded, ref_univ = ref["fold_and_half_sums", name]
    folded, univ = multilinear.fold_and_half_sums(ctx, tt, tr)
    assert same(ref_folded, folded)
    assert same(ref_univ, univ)
    plain_folded, _ = kernels.fold_plain(ctx, tt[None], tr, 32)
    assert same(ref_folded, plain_folded[0])


def test_fold_plain_matches_fold_pallas(ref):
    """K2's plain version against fold_pallas (interpret mode), block sums included."""
    ctx, table, r = _fold_inputs("bn254_fr", 2048, 9)
    folded, sums = kernels.fold_plain(ctx, limbs_from_numpy(table)[None], limbs_from_numpy(r), 256)
    assert sums.shape == (1, 4, ctx.L + 2)
    ref_folded, ref_sums = ref["fold_pallas"]
    assert same(ref_folded, folded)
    assert same(ref_sums, sums)


def test_fold_plain_matches_fold_mxu_lm(ref):
    """K2's plain version against the limb-major digit-matmul fold (interpret mode)."""
    ctx, table, r = _fold_inputs("bn254_fr", 1 << 10, 10)
    folded, sums = kernels.fold_plain(ctx, limbs_from_numpy(table)[None], limbs_from_numpy(r), 128)
    ref_folded, ref_sums = ref["fold_mxu_lm"]
    assert same(ref_folded, folded[0])
    assert same(ref_sums, sums)


def test_fold_plain_matches_fold_mxu_pallas(ref):
    """K2's plain version against the caller-less [B, 2T, L] digit-matmul
    fold (interpret mode), batch rows and block sums included."""
    ctx, table, r = _fold_inputs("bn254_fr", 1 << 10, 12)
    folded, sums = kernels.fold_plain(ctx, limbs_from_numpy(table.reshape(2, 512, ctx.L)), limbs_from_numpy(r), 128)
    assert sums.shape == (2, 2, ctx.L + 2)
    ref_folded, ref_sums = ref["fold_mxu_pallas"]
    assert same(ref_folded, folded)
    assert same(ref_sums, sums)


@pytest.mark.parametrize("name", MXU_FIELDS)
def test_mont_mul_plain_broadcast_matches_mul_const_mxu_pallas(name, ref):
    """K1's plain version with a broadcast [L] Montgomery scalar against the
    caller-less digit-matmul constant multiply (interpret mode)."""
    ctx = arith.field_ctx(name)
    a, scalars = _mxu_operands(name)
    for s, want in zip(scalars, ref["mul_const_mxu_pallas", name]):
        assert same(want, kernels.mont_mul_plain(ctx, limbs_from_numpy(a), limbs_from_numpy(s)))


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
    with pytest.raises(ValueError):
        kernels.addsub(ctx, meta, meta, "add")
    with pytest.raises(TypeError):
        kernels.addsub(ctx, a.to(torch.int64), a, "sub")
    with pytest.raises(ValueError):
        kernels.addsub(ctx, a, a[:2], "add")
