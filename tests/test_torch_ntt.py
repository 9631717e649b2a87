"""tpu_zk_torch's NTT, its multi-pass plan and the NTT-pass kernel's plain
version (K6) held against tpu_zk.

The same numpy-made field elements go through ``tpu_zk.ntt.ntt.NTT`` (on the
CPU its stage-at-a-time transform) and the port's ``NTT``, whose
``forward``/``inverse`` run the multi-pass plan at every size: at k in
{0, 1, 3, 9} over BN254 Fr and k = 9 over BLS12-381 Fr, and at k = 9 with
the plan cut to one, two and three passes.  K6's plain version is held
against both TPU kernels it replaces, ``_batched_dif`` and ``dft_mxu``, run
in Pallas interpret mode as ``tests/test_sixstep.py`` runs them, on the same
[L, m, B] blocks, with and without pre-twiddle and scale, and on views whose
columns span several a (C = 1, as on the plans' last pass) or a ragged C.
Its contract reads only ``tws[0, 1:]``: random values in ``tws[:, 0]`` and
``tws[1:]`` change nothing, and the products it counts are the ones it
makes.  Everything is integer arithmetic, so every comparison is exact
(tolerance zero).

Every compiled tpu_zk computation runs once, in :func:`reference`, which
the module fixture calls in a fresh process (``tests/jax_reference.py``).
"""

import numpy as np
import pytest
import torch

from tests import jax_reference
from tpu_zk.fields import arith as jarith
from tpu_zk.ntt import ntt as jntt
from tpu_zk_torch import device as tdevice
from tpu_zk_torch.fields import arith
from tpu_zk_torch.ntt import kernels, ntt, sixstep
from tpu_zk_torch.ntt.ntt import NTT, polynomial_multiply
from tpu_zk_torch.utils.convert import limbs_from_numpy, limbs_to_numpy

tdevice.set_default_device("cpu")  # these tests run the plain versions, on the CPU
torch.set_num_threads(1)  # small tensors: more threads only take cores from the other test workers

CASES = [("bn254_fr", 0), ("bn254_fr", 1), ("bn254_fr", 3), ("bn254_fr", 9), ("bls12_381_fr", 9)]
CASE_IDS = [f"{f} 2^{k}" for f, k in CASES]
PASSES = {1: 9, 2: 5, 3: 3}  # passes of the port's plan at k = 9 -> its max_log
# operand lengths of polynomial_multiply: products of 8 and 499 coefficients take the 2^3 and 2^9
# transforms of CASES, so tpu_zk compiles no transform for them
PRODUCTS = {"bn254_fr": (5, 4), "bls12_381_fr": (300, 200)}
# one K6 block: radix m over B columns, as [L, m, B] for the JAX kernels
BLOCK_M, BLOCK_B = 8, 8
DIF_VARIANTS = ["plain", "pre", "pre and scale"]
MXU_VARIANTS = ["pre", "scale"]
# K6 views [A, m, C] that are not one [L, m, B] block with A = 1: the plans' last pass (C = 1, A > 1),
# ragged column counts, both; with the variant of _batched_dif each runs
COLUMN_CASES = {"C=1 A=3 pre and scale": ((3, 8, 1), "pre and scale"), "C=5 A=1 pre": ((1, 8, 5), "pre"),
                "C=3 A=2 plain": ((2, 8, 3), "plain")}


def _values(field: str, n: int, seed: int) -> list[int]:
    p = jarith.field_ctx(field).p
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % p for _ in range(n)]


def _case_values(field: str, k: int) -> list[int]:
    return _values(field, 1 << k, 10 * k + len(field))


def _block(seed: int) -> np.ndarray:
    """Random Montgomery BN254 Fr elements as a uint32 [L, m, B] block."""
    ctx = arith.field_ctx("bn254_fr")
    vals = _values("bn254_fr", BLOCK_M * BLOCK_B, seed)
    return limbs_to_numpy(ctx.array(vals)).reshape(BLOCK_M, BLOCK_B, ctx.L).transpose(2, 0, 1).copy()


def _block_twiddles():
    """(w_m, the port's stage twiddles [S, m/2, L]) of the radix-m pass of a 2^9 transform."""
    p = arith.field_ctx("bn254_fr").p
    root = ntt.find_root_of_unity("bn254_fr", 9)
    plan = sixstep.SixStepPlan("bn254_fr", 9, root, max_log=3)
    return pow(root, (1 << 9) // BLOCK_M, p), plan.tws[0]


def _scale() -> int:
    p = jarith.field_ctx("bn254_fr").p
    return pow(1 << 9, p - 2, p)


def _column_inputs(case: str):
    """(x, pre, scale) of a COLUMN_CASES view in the port's [A, m, C, L] layout."""
    ctx = arith.field_ctx("bn254_fr")
    (A, m, C), variant = COLUMN_CASES[case]
    seed = 20 + list(COLUMN_CASES).index(case)
    x = ctx.array(_values("bn254_fr", A * m * C, seed)).reshape(A, m, C, ctx.L)
    pre = ctx.array(_values("bn254_fr", A * m * C, seed + 10)).reshape(A, m, C, ctx.L) if "pre" in variant else None
    scale = ctx.scalar(_scale()) if "scale" in variant else None
    return x, pre, scale


def _as_block(t: torch.Tensor) -> np.ndarray:
    """[A, m, C, L] -> the [L, m, A*C] block of _batched_dif (column a*C + c)."""
    A, m, C, L = t.shape
    return limbs_to_numpy(t).transpose(3, 1, 0, 2).reshape(L, m, A * C).copy()


def reference() -> dict:
    """Everything the tests compare against, computed by tpu_zk (in the child
    process): per case the forward and inverse transforms of the same table,
    ``forward_ints`` and the stage twiddle table; the products; and the two
    TPU kernels on one block."""
    import jax.numpy as jnp

    from tpu_zk.fields.mxu_mul import dft_matrix, dft_mxu
    from tpu_zk.ntt.sixstep import _batched_dif

    out = {"cases": {}, "products": {}}
    for field, k in CASES:
        ctx = jarith.field_ctx(field)
        vals = _case_values(field, k)
        t = jntt.NTT(field, k)
        table = ctx.array(vals)
        out["cases"][(field, k)] = {
            "forward": np.asarray(t.forward(table)), "inverse": np.asarray(t.inverse(table)),
            "forward_ints": t.forward_ints(vals), "inverse_ints": t.inverse_ints(vals),
            "twiddles": np.asarray(t._tw_fwd), "root": t.root,
        }
    for field, (na, nb) in PRODUCTS.items():
        a, b = _values(field, na, 1), _values(field, nb, 2)
        out["products"][field] = jntt.polynomial_multiply(field, a, b)

    ctx = jarith.field_ctx("bn254_fr")
    w_m, tws = _block_twiddles()
    tws_lm = jnp.asarray(limbs_to_numpy(tws).transpose(0, 2, 1))  # [S, L, m/2]
    x, pre = jnp.asarray(_block(1)), jnp.asarray(_block(2))
    scale = tuple(int(v) for v in np.asarray(ctx.scalar(_scale())))
    out["batched_dif"] = {
        "plain": np.asarray(_batched_dif(ctx, x, tws_lm, BLOCK_B)),
        "pre": np.asarray(_batched_dif(ctx, x, tws_lm, BLOCK_B, pre)),
        "pre and scale": np.asarray(_batched_dif(ctx, x, tws_lm, BLOCK_B, pre, scale)),
    }
    out["batched_dif_columns"] = {}
    for case in COLUMN_CASES:
        xc, prec, scalec = _column_inputs(case)
        B = xc.shape[0] * xc.shape[2]
        out["batched_dif_columns"][case] = np.asarray(_batched_dif(
            ctx, jnp.asarray(_as_block(xc)), tws_lm, B, None if prec is None else jnp.asarray(_as_block(prec)),
            None if scalec is None else scale))
    out["dft_mxu"] = {
        "pre": np.asarray(dft_mxu(ctx, x, jnp.asarray(dft_matrix(ctx, w_m, BLOCK_M)), BLOCK_M, BLOCK_B, pre)),
        "scale": np.asarray(dft_mxu(ctx, x, jnp.asarray(dft_matrix(ctx, w_m, BLOCK_M, scale=_scale())), BLOCK_M,
                                    BLOCK_B)),
    }
    return out


@pytest.fixture(scope="module")
def ref():
    return jax_reference.call("tests.test_torch_ntt", "reference")


def _table(field: str, k: int) -> torch.Tensor:
    return arith.field_ctx(field).array(_case_values(field, k))


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_forward_matches_tpu_zk(case, ref):
    got = NTT(*case).forward(_table(*case))
    np.testing.assert_array_equal(limbs_to_numpy(got), ref["cases"][case]["forward"])


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_inverse_matches_tpu_zk(case, ref):
    got = NTT(*case).inverse(_table(*case))
    np.testing.assert_array_equal(limbs_to_numpy(got), ref["cases"][case]["inverse"])


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_ints_match_tpu_zk(case, ref):
    t = NTT(*case)
    vals = _case_values(*case)
    assert t.root == ref["cases"][case]["root"]
    assert t.forward_ints(vals) == ref["cases"][case]["forward_ints"]
    assert t.inverse_ints(vals) == ref["cases"][case]["inverse_ints"]
    assert t.inverse_ints(t.forward_ints(vals)) == vals


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_stagewise_oracle_matches_tpu_zk(case, ref):
    """The stage-at-a-time transform (the oracle of chip_smoke.py) and its
    K1-doubled twiddle table."""
    t = NTT(*case)
    table = _table(*case)
    np.testing.assert_array_equal(limbs_to_numpy(t.forward_stagewise(table)), ref["cases"][case]["forward"])
    np.testing.assert_array_equal(limbs_to_numpy(t.inverse_stagewise(table)), ref["cases"][case]["inverse"])
    np.testing.assert_array_equal(limbs_to_numpy(t._stage_tables(False, "cpu")[1]), ref["cases"][case]["twiddles"])


@pytest.mark.parametrize("passes", list(PASSES))
def test_plan_passes_match_tpu_zk(passes, ref):
    """The port's plan cut to one, two and three passes gives tpu_zk's integers."""
    case = ("bn254_fr", 9)
    t = NTT(*case, max_log=PASSES[passes])
    assert len(t.plan(False, "cpu").ms) == passes
    table = _table(*case)
    fwd = t.forward(table)
    np.testing.assert_array_equal(limbs_to_numpy(fwd), ref["cases"][case]["forward"])
    np.testing.assert_array_equal(limbs_to_numpy(t.inverse(table)), ref["cases"][case]["inverse"])
    assert torch.equal(t.inverse(fwd), table)


@pytest.mark.parametrize("field", list(PRODUCTS))
def test_polynomial_multiply_matches_tpu_zk(field, ref):
    na, nb = PRODUCTS[field]
    a, b = _values(field, na, 1), _values(field, nb, 2)
    got = polynomial_multiply(field, a, b)
    assert got == ref["products"][field]
    p = arith.field_ctx(field).p
    want = [0] * (na + nb - 1)
    for i, x in enumerate(a):
        for j, y in enumerate(b):
            want[i + j] = (want[i + j] + x * y) % p
    assert got == want


def _block_inputs(variant: str):
    """(x, tws, pre, scale) of one block in the port's [A, m, C, L] layout (A = 1)."""
    ctx = arith.field_ctx("bn254_fr")
    _, tws = _block_twiddles()
    x = limbs_from_numpy(_block(1).transpose(1, 2, 0))[None]
    pre = limbs_from_numpy(_block(2).transpose(1, 2, 0))[None] if "pre" in variant else None
    scale = ctx.scalar(_scale()) if "scale" in variant else None
    return ctx, x, tws, pre, scale


@pytest.mark.parametrize("variant", DIF_VARIANTS)
def test_dif_pass_plain_matches_batched_dif(variant, ref):
    ctx, x, tws, pre, scale = _block_inputs(variant)
    got = kernels.dif_pass_plain(ctx, x, tws, pre, scale)
    np.testing.assert_array_equal(limbs_to_numpy(got[0]).transpose(2, 0, 1), ref["batched_dif"][variant])
    assert torch.equal(kernels.dif_pass(ctx, x, tws, pre, scale), got)  # the wrapper on CPU tensors


@pytest.mark.parametrize("case", list(COLUMN_CASES))
def test_dif_pass_plain_matches_batched_dif_columns(case, ref):
    """K6's columns over the flattened (a, c) pairs: C = 1 with A > 1 (the
    plans' last pass) and ragged C, against _batched_dif on the same columns
    as one [L, m, A*C] block."""
    ctx = arith.field_ctx("bn254_fr")
    _, tws = _block_twiddles()
    x, pre, scale = _column_inputs(case)
    got = kernels.dif_pass_plain(ctx, x, tws, pre, scale)
    np.testing.assert_array_equal(_as_block(got), ref["batched_dif_columns"][case])
    assert torch.equal(kernels.dif_pass(ctx, x, tws, pre, scale), got)  # the wrapper on CPU tensors


@pytest.mark.parametrize("variant", ["plain", "pre scale dst"])
def test_dif_pass_reads_no_twiddle_of_one(variant):
    """tws[:, 0] (w^0) and tws[1:] are not read: random values there give the
    same output, from the plain version and from the wrapper on CPU tensors."""
    ctx = arith.field_ctx("bn254_fr")
    A, m, C = 2, 16, 3
    rng = np.random.default_rng(5)
    plan = sixstep.SixStepPlan(ctx.name, 4, ntt.find_root_of_unity(ctx.name, 4))
    tws = plan.tws[0]
    noise = tws.clone()
    noise[:, 0] = ctx.array(_values(ctx.name, tws.shape[0], 6))
    noise[1:] = ctx.array(_values(ctx.name, (tws.shape[0] - 1) * tws.shape[1], 7)).reshape(noise[1:].shape)
    x = ctx.array(_values(ctx.name, A * m * C, 8)).reshape(A, m, C, ctx.L)
    args = ()
    if variant != "plain":
        pre = ctx.array(_values(ctx.name, A * m * C, 9)).reshape(A, m, C, ctx.L)
        args = (pre, ctx.scalar(_scale()), torch.from_numpy(rng.permutation(A * m * C)))
    want = kernels.dif_pass_plain(ctx, x, tws, *args)
    assert torch.equal(kernels.dif_pass_plain(ctx, x, noise, *args), want)
    assert torch.equal(kernels.dif_pass(ctx, x, noise, *args), want)


@pytest.mark.parametrize("shape", [(1, 16, 3), (4, 8, 1), (2, 1, 2), (1, 2, 5)])
def test_dif_pass_products_counts_the_plain_versions_products(shape, monkeypatch):
    """dif_pass_products on CPU tensors: the count is the elements that the
    plain version multiplies, none by a twiddle of one."""
    ctx = arith.field_ctx("bn254_fr")
    A, m, C = shape
    log_m = m.bit_length() - 1
    plan = sixstep.SixStepPlan(ctx.name, log_m, ntt.find_root_of_unity(ctx.name, log_m))
    n = A * m * C
    x = ctx.array(_values(ctx.name, n, 10)).reshape(A, m, C, ctx.L)
    pre = ctx.array(_values(ctx.name, n, 11)).reshape(A, m, C, ctx.L)
    made = []
    plain = kernels.mont_mul_plain

    def counting(c, a, b):
        out = plain(c, a, b)
        made.append(out.numel() // c.L)
        return out

    monkeypatch.setattr(kernels, "mont_mul_plain", counting)
    out, count = kernels.dif_pass_products(ctx, x, plan.tws[0], pre, ctx.scalar(_scale()))
    assert count == sum(made) == A * C * (m // 2 * log_m - (m - 1)) + 2 * n
    monkeypatch.undo()
    assert torch.equal(out, kernels.dif_pass_plain(ctx, x, plan.tws[0], pre, ctx.scalar(_scale())))


@pytest.mark.parametrize("variant", MXU_VARIANTS)
def test_dif_pass_plain_matches_dft_mxu(variant, ref):
    ctx, x, tws, pre, scale = _block_inputs(variant)
    got = kernels.dif_pass_plain(ctx, x, tws, pre, scale)
    np.testing.assert_array_equal(limbs_to_numpy(got[0]).transpose(2, 0, 1), ref["dft_mxu"][variant])


@pytest.mark.parametrize("shape", [(3, 8, 5), (1, 4, 1), (2, 1, 3), (5, 2, 7)])
def test_dif_pass_is_the_bit_reversed_dft_of_every_column(shape):
    """Any A and C, ragged or not: position j of each column holds
    sum_n x_n w_m^(n rev(j)), here against host ints, with a pre-twiddle."""
    ctx = arith.field_ctx("bls12_381_fr")
    A, m, C = shape
    p = ctx.p
    w_m = ntt.find_root_of_unity(ctx.name, m.bit_length() - 1)
    x_vals = _values(ctx.name, A * m * C, 3)
    pre_vals = _values(ctx.name, A * m * C, 4)
    plan = sixstep.SixStepPlan(ctx.name, m.bit_length() - 1, w_m)
    x = ctx.array(x_vals).reshape(A, m, C, ctx.L)
    pre = ctx.array(pre_vals).reshape(A, m, C, ctx.L)
    got = ctx.to_ints(kernels.dif_pass(ctx, x, plan.tws[0], pre))
    rev = sixstep._bit_reverse(m.bit_length() - 1)
    idx = np.arange(A * m * C).reshape(A, m, C)
    for a in range(A):
        for c in range(C):
            col = [x_vals[i] * pre_vals[i] % p for i in idx[a, :, c]]
            for j in range(m):
                want = sum(v * pow(w_m, n * int(rev[j]), p) for n, v in enumerate(col)) % p
                assert got[idx[a, j, c]] == want


def test_dif_pass_rejects_bad_operands():
    ctx = arith.field_ctx("bn254_fr")
    _, x, tws, pre, scale = _block_inputs("pre and scale")
    with pytest.raises(ValueError):
        kernels.dif_pass(ctx, x[0], tws)  # not [A, m, C, L]
    with pytest.raises(ValueError):
        kernels.dif_pass(ctx, x[:, :6].contiguous(), tws)  # radix 6
    with pytest.raises(ValueError):
        kernels.dif_pass(ctx, x, tws[:2])  # twiddles of another radix
    with pytest.raises(ValueError):
        kernels.dif_pass(ctx, x, tws, pre[:, :, :4].contiguous())  # pre of another shape
    with pytest.raises(TypeError):
        kernels.dif_pass(ctx, x.to(torch.int64), tws)


def test_split_logs():
    assert sixstep._split_logs(0) == [0]
    assert sixstep._split_logs(10) == [10]
    assert sixstep._split_logs(20) == [10, 10]
    assert sixstep._split_logs(24) == [8, 8, 8]
    assert sixstep._split_logs(18) == [9, 9]
    assert sixstep._split_logs(9, max_log=3) == [3, 3, 3]
    for k in range(1, 29):
        logs = sixstep._split_logs(k)
        assert sum(logs) == k and max(logs) <= kernels.MAX_LOG_M and max(logs) - min(logs) <= 1


def test_roots_of_unity_match_tpu_zk():
    for field in ("bn254_fr", "bls12_381_fr"):
        for k in range(0, 29):
            assert ntt.find_root_of_unity(field, k) == jntt.find_root_of_unity(field, k)
