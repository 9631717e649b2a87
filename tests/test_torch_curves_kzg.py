"""tpu_zk_torch's curves, MSM and multilinear KZG held against tpu_zk on the CPU.

Inputs come from ``numpy.random.default_rng`` (or are the reference's own
test vectors) and reach both packages as the same ints or numpy limb arrays.
Everything is integer arithmetic, so every comparison is exact (tolerance
zero): limbs where both packages run the same operation order
(``ec_add``), affine points where they add in different orders (MSMs, bucket
sums).  On the CPU the port's K4 wrappers run their plain versions; the CUDA
kernels are held against those plain versions on the card by
``chip_smoke.py``.  On the CPU ``tpu_zk``'s ``msm_pippenger`` takes its
double-and-add branch, which gives the same group element as its kernel;
each MSM shape costs it about half a minute of processor time to compile, so
the MSM that both packages compute has the KZG commitment's shape (8 points
over BLS12-381), and the 64-point BN254 one is held against host ints.

Every compiled tpu_zk computation runs once, in :func:`reference`, which the
module fixture calls in a fresh process (``tests/jax_reference.py``);
tpu_zk's host-int code (``host_ec``, ``pairing``) runs here.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from tests import jax_reference
from tpu_zk.curves import host_ec as jhost_ec
from tpu_zk.curves import pairing as jpairing
from tpu_zk.curves import params as jparams
from tpu_zk_torch import device as tdevice
from tpu_zk_torch.curves import ec_device, fixed_base, host_ec, kernels, pairing, pairing_native, params
from tpu_zk_torch.curves import msm_pippenger as mp
from tpu_zk_torch.curves.ec_device import DeviceCurve
from tpu_zk_torch.fields import arith
from tpu_zk_torch.kzg import multilinear_kzg as kzg
from tpu_zk_torch.kzg import trusted_setup as ts
from tpu_zk_torch.poly.multilinear import MultilinearPolynomial
from tpu_zk_torch.utils import serialize
from tpu_zk_torch.utils.convert import (limbs_from_numpy, limbs_to_numpy, points_from_numpy, points_to_numpy,
                                        trusted_setup_from_arrays)

tdevice.set_default_device("cpu")  # these tests run the plain versions, on the CPU
torch.set_num_threads(1)  # small tensors: more threads only take cores from the other test workers

CURVE_NAMES = ["bn254", "bls12_381"]
# multilinear_kzg.rs:216-239 and :242-266: (taus, evaluations, opening point)
VECTORS = {
    "kzg1": ([5, 2, 3], [0, 4, 0, 4, 0, 4, 3, 7], [6, 4, 0]),
    "kzg2": ([2, 3, 4], [0, 7, 0, 5, 0, 7, 4, 9], [5, 9, 6]),
}
MSM_POINTS = 64


def _curve(name):
    return DeviceCurve(name)


def _multiples(name, ks):
    """Affine k*G for each k (None for k = 0)."""
    hc = host_ec.HostCurve(name)
    g = hc.g1_generator()
    return [hc.g1_affine(hc.g1_mul(g, k)) if k % hc.r else None for k in ks]


def _ec_add_operands(name):
    """Two point arrays as numpy limb coordinates: random pairs, a doubling,
    P + (-P), identity on either side and on both."""
    dc = _curve(name)
    r = dc.fr.p
    ps = [1, 2, 5, 0, 9, 0, 7, 1234567]
    qs = [3, 2, r - 5, 11, 0, 0, 7, 7654321]
    return tuple(points_to_numpy(dc.points_to_device(_multiples(name, ks))) for ks in (ps, qs))


def _msm_inputs(name="bn254", n=MSM_POINTS):
    """(multipliers k_i of G, scalars, their limbs [n, 16] as numpy): points
    with a duplicate, P and -P, identity points; scalars 0, 1, r - 1,
    2^256 - 1 (not reduced: every window but the last carries) and random
    ones, the special cases first so that 8 points hold most of them."""
    rng = np.random.default_rng(21)
    r = params.CURVES[name]["r"]
    ks = [int(k) for k in rng.integers(1, 1 << 30, n)]
    ks[1] = ks[0]  # a point added to itself
    ks[3] = r - ks[2]  # P and -P
    ks[4] = 0  # an identity point
    scalars = [int.from_bytes(rng.bytes(32), "little") % r for _ in range(n)]
    scalars[0] = scalars[1] = 7  # equal digits for the duplicate point
    scalars[3] = scalars[2]
    scalars[5:8] = [r - 1, (1 << 256) - 1, 0]
    if n > 8:
        ks[8] = 0
        scalars[8] = 1
    limbs = np.array([[(s >> (16 * i)) & 0xFFFF for i in range(16)] for s in scalars], dtype=np.uint32)
    return ks, scalars, limbs


def _digit(code: int) -> int:
    return 0 if code & 64 else ((code & 31) + 1) * (-1 if code & 32 else 1)


def _tpu_zk_codes(scalars, digits: torch.Tensor, n_codes: int) -> list[list[int]]:
    """tpu_zk's packed base-32 codes, ``(|d|-1) | carry << 5 | skip << 6``,
    built from the port's signed digits [W, N] at c = 5: the carry out of
    window w is (raw_w + carry_w - d_w) / 32, raw_w the scalar's 5 bits
    there; windows past W skip."""
    rows = []
    for s, column in zip(scalars, digits.T.tolist()):
        carry, row = 0, []
        for w, d in enumerate(column):
            carry, rest = divmod(((s >> (5 * w)) & 31) + carry - d, 32)
            assert rest == 0 and carry in (0, 1)
            row.append(max(abs(d) - 1, 0) | carry << 5 | (d == 0) << 6)
        rows.append(row + [64] * (n_codes - len(row)))
    return rows


def _signed(name, ks):
    """Multipliers of G as the signed ints of least magnitude (r - k is -k)."""
    r = params.CURVES[name]["r"]
    return [k - r if k > r // 2 else k for k in ks]


def _signed_multiples(name, ks):
    """Affine k*G for small signed k: |k|*G, negated for k < 0 (cheaper on
    host ints than a multiple by r - |k|)."""
    hc = host_ec.HostCurve(name)
    out = []
    for k in ks:
        a = hc.g1_affine(hc.g1_mul(hc.g1_generator(), abs(k))) if k else None
        out.append((a[0], -a[1] % hc.p) if a is not None and k < 0 else a)
    return out


def _same(proof):
    return proof


def _tamper_evaluation(proof):
    proof.evaluation += 1
    return proof


def _tamper_point(proof):
    proof.proofs[1] = params.CURVES["bls12_381"]["g1"]  # a point of the group, not the quotient's commitment
    return proof


def reference(port_kzg: dict) -> dict:
    """Everything the tests compare against, computed by tpu_zk (in the child
    process): ``ec_add`` limbs on both curves; the digit arrays; a 64-point
    ``msm_pippenger``; the golden Lagrange bases; per KZG vector the setup,
    commitment and opening, and tpu_zk's verdicts on the port's proof (as
    is, wrong evaluation, wrong opening point, tampered quotient point)."""
    import jax.numpy as jnp

    from tpu_zk.curves import ec_device as jec
    from tpu_zk.curves import fixed_base as jfixed
    from tpu_zk.curves import msm_pippenger as jmp
    from tpu_zk.fields.arith import field_ctx as j_field_ctx
    from tpu_zk.kzg import multilinear_kzg as jkzg
    from tpu_zk.kzg import trusted_setup as jts
    from tpu_zk.poly.multilinear import MultilinearPolynomial as JMLE
    from tpu_zk.utils import serialize as jser

    out = {"ec_add": {}, "kzg": {}}
    for name in CURVE_NAMES:
        jdc = jec.DeviceCurve(name)
        P, Q = (tuple(jnp.asarray(c) for c in pt) for pt in _ec_add_operands(name))
        R = jec.ec_add(jdc.ctx, jdc.b3, P, Q)
        R2 = jec.ec_add(jdc.ctx, jdc.b3, R, P)  # operands with Z != 1
        out["ec_add"][name] = [[np.asarray(c) for c in pt] for pt in (R, R2)]

    ks, _, limbs = _msm_inputs()
    jl = jnp.asarray(limbs)
    out["codes"] = np.asarray(jmp.signed_digit_codes(jl))
    out["digits4"] = np.asarray(jfixed.digits4(jl))
    out["digits8"] = np.asarray(jmp._digits(jl, 8))
    out["scalar_bits"] = np.asarray(jec.scalar_bits(j_field_ctx("bn254_fr"), jl))
    jdc = jec.DeviceCurve("bls12_381")
    ks8, _, limbs8 = _msm_inputs("bls12_381", 8)
    points = jdc.points_to_device(_multiples("bls12_381", ks8))
    out["msm"] = jdc.point_to_host(jmp.msm_pippenger(jdc.ctx, jdc.b3, (points, jnp.asarray(limbs8))))

    fr = j_field_ctx("bls12_381_fr")
    out["basis"] = [fr.to_ints(jts.compute_lagrange_basis_device(fr, taus)) for taus in ([5, 2, 3], [5, 2])]

    for vec, (taus, values, opening) in VECTORS.items():
        setup = jts.TrustedSetup.initialize_setup("bls12_381", taus)
        poly = JMLE.from_ints(fr, values)
        commitment = jkzg.commit_to_polynomial(poly, setup)
        proof = jkzg.open_and_prove(poly, setup, opening)
        port_commitment, port_json = port_kzg[vec]
        wrong_opening = opening[:-1] + [opening[-1] + 1]
        out["kzg"][vec] = {
            "g1_affine": setup.lagrange_basis_ints(),
            "g1_arrays": [np.asarray(c) for c in setup.g1_powers_of_tau],
            "g2": [tuple((c.c0, c.c1) for c in pt) for pt in setup.g2_powers_of_tau],
            "commitment": commitment,
            "json": jser.kzg_proof_to_json(proof),
            "verifies_own": jkzg.verify(setup, commitment, opening, proof),
            "port_verdicts": [
                jkzg.verify(setup, port_commitment, opening, jser.kzg_proof_from_json(port_json)),
                jkzg.verify(setup, port_commitment, opening, _tamper_evaluation(jser.kzg_proof_from_json(port_json))),
                jkzg.verify(setup, port_commitment, wrong_opening, jser.kzg_proof_from_json(port_json)),
                jkzg.verify(setup, port_commitment, opening, _tamper_point(jser.kzg_proof_from_json(port_json))),
            ],
        }
    return out


@pytest.fixture(scope="module")
def port_kzg():
    """vector -> (setup, polynomial, commitment, proof) made by the port."""
    out = {}
    fr = arith.field_ctx("bls12_381_fr")
    for vec, (taus, values, opening) in VECTORS.items():
        setup = ts.TrustedSetup.initialize_setup("bls12_381", taus)
        poly = MultilinearPolynomial.from_ints(fr, values)
        out[vec] = setup, poly, kzg.commit_to_polynomial(poly, setup), kzg.open_and_prove(poly, setup, opening)
    return out


@pytest.fixture(scope="module")
def ref(port_kzg):
    sent = {vec: (c, serialize.kzg_proof_to_json(proof)) for vec, (_, _, c, proof) in port_kzg.items()}
    return jax_reference.call("tests.test_torch_curves_kzg", "reference", sent, timeout=900)


# -- host curves and pairings --------------------------------------------------


def test_params_match_tpu_zk():
    assert params.CURVES == jparams.CURVES


@pytest.mark.parametrize("name", CURVE_NAMES)
def test_host_ec_matches_tpu_zk(name):
    """Generators on the curve, of order r, and multiples equal to tpu_zk's."""
    hc, jhc = host_ec.HostCurve(name), jhost_ec.HostCurve(name)
    g1, g2 = hc.g1_generator(), hc.g2_generator()
    assert hc.g1_is_on_curve(g1) and hc.g2_is_on_curve(g2)
    assert hc.g1_affine(host_ec.ec_scalar_mul(g1, hc.r, hc.b3_g1, hc.zero, hc.one)) is None
    assert hc.g2_affine(host_ec.ec_scalar_mul(g2, hc.r, hc.b3_g2, hc.zero2, hc.one2)) is None
    for k in (1, 2, 12345678901234567890, hc.r - 1):
        assert hc.g1_affine(hc.g1_mul(g1, k)) == jhc.g1_affine(jhc.g1_mul(jhc.g1_generator(), k))
        assert hc.g2_affine(hc.g2_mul(g2, k)) == jhc.g2_affine(jhc.g2_mul(jhc.g2_generator(), k))
    five = hc.g1_mul(g1, 5)
    assert host_ec.ec_eq(hc.g1_add(hc.g1_mul(g1, 2), hc.g1_mul(g1, 3)), five)
    for P in (five, g1, host_ec.ec_identity(hc.zero, hc.one)):  # the doubling formula, against the complete add
        assert host_ec.ec_eq(host_ec.ec_double(P, hc.b3_g1), hc.g1_add(P, P))
    assert hc.g1_affine(hc.g1_add(five, host_ec.ec_neg(five))) is None
    assert hc.g2_affine(hc.g2_sub(hc.g2_mul(g2, 5), hc.g2_mul(g2, 3))) == hc.g2_affine(hc.g2_mul(g2, 2))


@pytest.mark.parametrize("name", CURVE_NAMES)
def test_pairing_matches_tpu_zk_and_is_bilinear(name):
    hc = host_ec.HostCurve(name)
    g1, g2 = hc.g1_generator(), hc.g2_generator()
    a1, a2 = hc.g1_affine(g1), hc.g2_affine(g2)
    e0 = pairing.pairing(name, a1, a2)
    j0 = jpairing.pairing(name, a1, a2)
    assert e0 != pairing.tower(name).one12()
    assert e0.pow(hc.r) == pairing.tower(name).one12()
    flat = lambda f: [(c.c0, c.c1) for half in (f.c0, f.c1) for c in (half.c0, half.c1, half.c2)]
    assert flat(e0) == flat(j0)
    assert pairing.pairing(name, hc.g1_affine(hc.g1_mul(g1, 3)), a2) == pairing.pairing(name, a1, hc.g2_affine(hc.g2_mul(g2, 3)))
    assert pairing.pairing(name, None, a2) == pairing.tower(name).one12()


@pytest.mark.parametrize("name", CURVE_NAMES)
def test_pairing_native_matches_python(name):
    hc = host_ec.HostCurve(name)
    g1, g2 = hc.g1_generator(), hc.g2_generator()
    a1, a2 = hc.g1_affine(g1), hc.g2_affine(g2)
    two_g1 = hc.g1_affine(hc.g1_mul(g1, 2))
    minus_two_g2 = hc.g2_affine(host_ec.ec_neg(hc.g2_mul(g2, 2)))
    cases = [
        [(two_g1, a2), (a1, minus_two_g2)],  # e(2P, Q) e(P, -2Q) = 1
        [(two_g1, a2), (a1, a2)],  # not one
        [(two_g1, a2), (a1, minus_two_g2), (None, a2), (a1, None)],  # infinity entries contribute 1
        [(None, a2)],
        [(a1, a2)],
    ]
    for pairs in cases:
        assert pairing_native.pairing_product_is_one(name, pairs) == pairing.pairing_product_is_one(name, pairs)
    assert pairing_native.pairing_product_is_one(name, cases[0]) and not pairing_native.pairing_product_is_one(name, cases[1])


# -- ec_add, digits ------------------------------------------------------------


@pytest.mark.parametrize("name", CURVE_NAMES)
def test_ec_add_limbs_match_tpu_zk(name, ref):
    """The same operation order gives the same limbs, not only the same
    point: random pairs, a doubling, P + (-P), identities; then operands
    with Z != 1."""
    dc = _curve(name)
    P, Q = (points_from_numpy(pt) for pt in _ec_add_operands(name))
    R = ec_device.ec_add(dc.ctx, dc.b3, P, Q)
    R2 = ec_device.ec_add(dc.ctx, dc.b3, R, P)
    for got, want in zip((R, R2), ref["ec_add"][name]):
        for g, w in zip(points_to_numpy(got), want):
            assert np.array_equal(g, w)
    r = dc.fr.p
    assert dc.points_to_host(R) == _multiples(name, [4, 4, 0, 11, 9, 0, 14, 1234567 + 7654321])
    assert dc.points_to_host(R2) == _multiples(name, [5, 6, 5, 11, 18, 0, 21, (2 * 1234567 + 7654321) % r])


def test_ec_equal_select_neg():
    dc = _curve("bn254")
    ctx = dc.ctx
    P = dc.points_to_device(_multiples("bn254", [3, 5, 0, 7]))
    Q = dc.points_to_device(_multiples("bn254", [1, 5, 0, 0]))
    two = dc.points_to_device(_multiples("bn254", [2, 0, 0, 7]))
    S = ec_device.ec_add(ctx, dc.b3, Q, two)  # 3G, 5G, O, 7G with other (X : Y : Z)
    assert ec_device.ec_equal(ctx, P, S).tolist() == [True, True, True, True]
    assert ec_device.ec_equal(ctx, P, Q).tolist() == [False, True, True, False]
    neg = (P[0], arith.neg(ctx, P[1]), P[2])
    assert dc.points_to_host(ec_device.ec_add(ctx, dc.b3, P, neg)) == [None] * 4
    mask = torch.tensor([True, False, True, False])
    assert dc.points_to_host(ec_device.ec_select(mask, P, Q)) == _multiples("bn254", [3, 5, 0, 0])
    assert arith.is_zero(ctx, P[2]).tolist() == [False, False, True, False]
    assert dc.point_to_host(ec_device.tree_reduce(ctx, dc.b3, P)) == _multiples("bn254", [15])[0]


@pytest.mark.parametrize("what", ["codes", "digits4", "digits8", "scalar_bits"])
def test_digit_arrays_match_tpu_zk(what, ref):
    _, scalars, limbs = _msm_inputs()
    t = limbs_from_numpy(limbs)
    got = {
        "codes": lambda: torch.tensor(_tpu_zk_codes(scalars, mp.signed_digits(t, 5), 53), dtype=torch.int32),
        "digits4": lambda: fixed_base.digits4(t),
        "digits8": lambda: mp._digits(t, 8),
        "scalar_bits": lambda: ec_device.scalar_bits(arith.field_ctx("bn254_fr"), t),
    }[what]()
    assert got.dtype == torch.int32
    assert np.array_equal(limbs_to_numpy(got), ref[what])


@pytest.mark.parametrize("c", [5, 2, 3, 13, 16])
def test_signed_digits_sum_to_the_scalar(c):
    """Signed c-bit digits in (-2^(c-1), 2^(c-1)] that sum to the scalar, in
    ceil(257 / c) windows; at c = 5 they pack as tpu_zk's codes (53 windows)."""
    _, scalars, limbs = _msm_inputs()
    digits = mp.signed_digits(limbs_from_numpy(limbs), c)
    assert digits.dtype == torch.int32 and digits.shape == (mp.window_count(256, c), MSM_POINTS)
    half = 1 << (c - 1)
    for s, column in zip(scalars, digits.T.tolist()):
        assert all(-half < d <= half for d in column)
        assert sum(d * 2 ** (c * i) for i, d in enumerate(column)) == s
    assert set(digits[:, 7].tolist()) == {0}  # the zero scalar
    if c == 5:
        codes = _tpu_zk_codes(scalars, digits, 53)
        assert [[_digit(x) for x in row] for row in codes] == [col + [0] for col in digits.T.tolist()]
        assert set(codes[7]) == {64}  # the zero scalar skips every window
        # 80 bits fill window 15, and 2^80 - 1 = 32^16 - 1 carries into the window after it
        short = mp.signed_digits(torch.full((1, 5), 0xFFFF, dtype=torch.int32), 5)
        assert [_digit(x) for x in _tpu_zk_codes([2**80 - 1], short, 17)[0]] == [-1] + [0] * 15 + [1]


# -- fixed base, MSM, K4 -------------------------------------------------------


@pytest.mark.parametrize("name", CURVE_NAMES)
def test_fixed_base_and_msm_match_host(name):
    dc = _curve(name)
    fr = dc.fr
    scalars = [0, 1, 15, 16, fr.p - 1, 0xDEADBEEF << 200]
    table = fixed_base.host_window_table(dc, fr.L * 16)
    plain = fr.array(scalars, mont=False)
    got = dc.points_to_host(fixed_base.fixed_base_msm(dc.ctx, dc.b3, table, fixed_base.digits4(plain)))
    assert got == _multiples(name, scalars)
    points = _multiples(name, [1, 2, 3, 4])
    if name == "bn254":  # tests/test_curves.py test_msm_all_zero_scalars
        assert dc.msm_ints(points[:2], [0, 0]) is None
    else:
        assert dc.msm_ints(points, [5, 0, 7, 11]) == _multiples(name, [1 * 5 + 3 * 7 + 4 * 11])[0]


def _k4a_case(case):
    """(curve, signed multipliers of G, scalar limbs as numpy, c, unit) of a
    named K4a case."""
    if case == "edge points and scalars, c 3, units of 2":
        ks, _, limbs = _msm_inputs()
        return "bn254", _signed("bn254", ks), limbs, 3, 2
    if case == "bls12_381, c 5, units of 2":
        ks, _, limbs = _msm_inputs("bls12_381", 12)
        return "bls12_381", _signed("bls12_381", ks), limbs, 5, 2
    rng = np.random.default_rng(22)
    ks = [int(k) for k in rng.integers(-(1 << 20), 1 << 20, 16)]
    if case == "all scalars equal, c 4, units of 3":
        scalars = [int.from_bytes(rng.bytes(32), "little") % params.CURVES["bn254"]["r"]] * 16
        return "bn254", ks, np.array([[(s >> (16 * i)) & 0xFFFF for i in range(16)] for s in scalars], np.uint32), 4, 3
    if case == "scalars 0 and 1, c 2, units of 4":
        limbs = np.zeros((16, 16), dtype=np.uint32)
        limbs[::3, 0] = 1
        return "bn254", ks, limbs, 2, 4
    raise KeyError(case)


K4A_CASES = ["edge points and scalars, c 3, units of 2", "all scalars equal, c 4, units of 3",
             "scalars 0 and 1, c 2, units of 4", "bls12_381, c 5, units of 2"]


@pytest.mark.parametrize("case", K4A_CASES)
def test_k4_plain_versions_match_host(case):
    """K4a's bucket sums (through the sort, the unit tables and every pass
    of the wrapper, which on the CPU runs the plain version) against host
    ints, bucket by bucket: buckets split over several units and passes,
    one bucket a window, empty buckets, duplicates, P and -P, identity
    points, scalars 0, 1, r - 1 and 2^256 - 1."""
    name, ks, limbs, c, unit = _k4a_case(case)
    dc = _curve(name)
    points = dc.points_to_device(_signed_multiples(name, ks))
    digits = mp.signed_digits(limbs_from_numpy(limbs), c)
    W, B = digits.shape[0], 1 << (c - 1)
    entries, counts = mp._bucket_entries(digits, c)
    assert entries.dtype == torch.int32 and counts.shape == (W * B,) and int(counts.sum()) == int((digits != 0).sum())
    units, per_bucket = mp._unit_table(counts, unit)
    assert int(units[:, 1].max()) <= unit and int(per_bucket.max()) > 1  # a bucket split: a second pass
    sums = mp._sum_groups(dc.ctx, dc.b3, points, entries, counts, unit)
    assert sums.shape == (W * B, 3, dc.ctx.L) and sums.dtype == torch.int32
    want = np.zeros((W, B), dtype=object)
    for w, row in enumerate(digits.tolist()):
        for k, d in zip(ks, row):
            if d:
                want[w, abs(d) - 1] += k if d > 0 else -k
    assert dc.points_to_host(kernels.rows_to_points(sums)) == _signed_multiples(name, want.reshape(-1).tolist())


@pytest.mark.parametrize("B,m", [(8, 4), (8, 3), (5, 2), (4, 16)])
def test_k4b_plain_version_matches_host(B, m):
    """K4b's segment totals sum_b (b+1) S_b against host ints, with
    segments that divide the bucket count and segments that do not."""
    name = "bn254"
    dc = _curve(name)
    rng = np.random.default_rng(B * 100 + m)
    a = [[int(x) for x in rng.integers(-(1 << 16), 1 << 16, B)] for _ in range(2)]
    a[0][1] = 0  # an empty bucket
    buckets = kernels.points_to_rows(dc.points_to_device(_signed_multiples(name, sum(a, [])))).view(2, B, 3, dc.ctx.L)
    got = kernels.msm_bucket_reduce(dc.ctx, dc.b3, buckets.contiguous(), m)
    S = -(-B // m)
    assert got.shape == (2, S, 3, dc.ctx.L)
    want = [sum((b + 1) * a[w][b] for b in range(j * m, min(j * m + m, B))) for w in range(2) for j in range(S)]
    assert dc.points_to_host(kernels.rows_to_points(got)) == _signed_multiples(name, want)


def test_msm_pippenger_matches_tpu_zk(ref):
    """The bucket method against host ints and against tpu_zk's
    msm_pippenger, as affine points: 8 points over BLS12-381 (duplicate,
    P and -P, identity, scalars r - 1, 2^256 - 1, 0)."""
    dc = _curve("bls12_381")
    ks, scalars, limbs = _msm_inputs("bls12_381", 8)
    points = dc.points_to_device(_multiples("bls12_381", ks))
    got = dc.point_to_host(mp.msm_pippenger(dc.ctx, dc.b3, (points, limbs_from_numpy(limbs))))
    assert got == _multiples("bls12_381", [sum(k * s for k, s in zip(ks, scalars))])[0]
    assert got == ref["msm"]


@pytest.mark.parametrize("c", [None, 3, 7])
def test_msm_pippenger_at_64_points_matches_host(c):
    """The bucket method at 64 BN254 points, at the window the size rule
    picks and at others, against host ints; a CPU tensor launches no
    kernel."""
    dc = _curve("bn254")
    ks, scalars, limbs = _msm_inputs()
    points = dc.points_to_device(_multiples("bn254", ks))
    before = kernels.msm_buckets.launches, kernels.msm_bucket_reduce.launches
    got = dc.point_to_host(mp.msm_pippenger(dc.ctx, dc.b3, (points, limbs_from_numpy(limbs)), c=c))
    assert got == _multiples("bn254", [sum(k * s for k, s in zip(ks, scalars))])[0]
    assert (kernels.msm_buckets.launches, kernels.msm_bucket_reduce.launches) == before


@pytest.mark.parametrize("n", [0, 1, 2, 3])
def test_msm_pippenger_size_rule(n):
    """The window grows with N (2 bits for a point or two, 16 from ~2^17
    points), and the bucket method serves every N: 0 points give the
    identity, and 1 to 3 points (random and all-zero scalars) equal host
    ints."""
    assert [mp.window_bits(1 << k) for k in (0, 1, 3, 6, 10, 16, 20, 24)] == [2, 2, 3, 5, 8, 13, 16, 16]
    assert all(mp.window_bits(1 << k) <= mp.window_bits(1 << (k + 1)) for k in range(30))
    dc = _curve("bn254")
    ks, scalars, limbs = _msm_inputs()
    points = tuple(c[:n] for c in dc.points_to_device(_multiples("bn254", ks[:max(n, 1)])))
    s = limbs_from_numpy(limbs[:n]) if n else torch.zeros((0, 16), dtype=torch.int32)
    want = _multiples("bn254", [sum(k * x for k, x in zip(ks[:n], scalars[:n]))])[0]
    assert dc.point_to_host(mp.msm_pippenger(dc.ctx, dc.b3, (points, s))) == want
    assert dc.point_to_host(mp.msm_pippenger(dc.ctx, dc.b3, (points, torch.zeros_like(s)))) is None


def test_k4_wrappers_check_inputs():
    dc = _curve("bn254")
    ctx = dc.ctx
    points = dc.points_to_device(_multiples("bn254", [1, 2, 3, 4]))
    entries = torch.tensor([0, 1, 2 | kernels.SIGN, 3], dtype=torch.int32)
    units = torch.tensor([[0, 2], [2, 2]], dtype=torch.int32)
    assert dc.points_to_host(kernels.rows_to_points(kernels.msm_buckets(ctx, dc.b3, points, entries, units))) == \
        _multiples("bn254", [3, 4 - 3])
    with pytest.raises(ValueError):
        kernels.msm_buckets(ctx, dc.b3, points, entries.to(torch.int64), units)
    with pytest.raises(ValueError):
        kernels.msm_buckets(ctx, dc.b3, points, entries, units.to(torch.int64))
    with pytest.raises(ValueError):
        kernels.msm_buckets(ctx, dc.b3, points, entries, units[:, :1].contiguous())
    with pytest.raises(ValueError):
        kernels.msm_buckets(ctx, dc.b3, (points[0], torch.cat([points[1]] * 2, dim=1)[:, :ctx.L], points[2]),
                            entries, units)  # rows of X and Y strided differently
    with pytest.raises(ValueError):
        kernels.msm_buckets(ctx, dc.b3, tuple(c.to(torch.int64) for c in points), entries, units)
    with pytest.raises(ValueError):
        kernels.msm_bucket_reduce(ctx, dc.b3, torch.zeros((2, 4, 3, 24), dtype=torch.int32), 2)
    with pytest.raises(ValueError):
        kernels.msm_bucket_reduce(ctx, dc.b3, torch.zeros((2, 0, 3, 16), dtype=torch.int32), 2)
    with pytest.raises(ValueError):
        kernels.msm_bucket_reduce(ctx, dc.b3, torch.zeros((2, 4, 3, 16), dtype=torch.int32), 0)
    meta = tuple(torch.empty((4, ctx.L), dtype=torch.int32, device="meta") for _ in range(3))
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no plain version, no launch
        kernels.msm_buckets(ctx, dc.b3.to("meta"), meta, entries.to("meta"), units.to("meta"))
    with pytest.raises(ValueError):  # the kernels know 3b of the curves' base fields only
        kernels._b3_int(arith.field_ctx("bn254_fr"))


# -- KZG -----------------------------------------------------------------------


def test_lagrange_basis_golden(ref):
    # trusted_setup.rs:94-110 and :113-118 (tests/test_kzg.py:13-21)
    fr = arith.field_ctx("bls12_381_fr")
    got3 = fr.to_ints(ts.compute_lagrange_basis_device(fr, [5, 2, 3]))
    got2 = fr.to_ints(ts.compute_lagrange_basis_device(fr, [5, 2]))
    assert got3 == [v % fr.p for v in [-8, 12, 16, -24, 10, -15, -20, 30]]
    assert got2 == [v % fr.p for v in [4, -8, -5, 10]]
    assert [got3, got2] == ref["basis"]


@pytest.mark.parametrize("vec", list(VECTORS))
def test_setup_matches_tpu_zk(vec, port_kzg, ref):
    setup = port_kzg[vec][0]
    want = ref["kzg"][vec]
    assert setup.lagrange_basis_ints() == want["g1_affine"]
    assert [tuple((c.c0, c.c1) for c in pt) for pt in setup.g2_powers_of_tau] == want["g2"]
    assert setup.num_vars == 3 and len(setup.folded_g1_bases()) == 3
    assert [b[0].shape[0] for b in setup.folded_g1_bases()] == [4, 2, 1]


@pytest.mark.parametrize("vec", list(VECTORS))
def test_kzg_matches_tpu_zk(vec, port_kzg, ref):
    """Commitment, evaluation and every quotient point equal tpu_zk's."""
    _, _, commitment, proof = port_kzg[vec]
    want = ref["kzg"][vec]
    assert want["verifies_own"]
    assert commitment == want["commitment"]
    assert serialize.kzg_proof_to_json(proof) == want["json"]


@pytest.mark.parametrize("vec", list(VECTORS))
def test_port_kzg_proof_verifies_in_tpu_zk(vec, ref):
    """tpu_zk accepts the port's opening and rejects a wrong evaluation, a
    wrong opening point and a tampered quotient point."""
    assert ref["kzg"][vec]["port_verdicts"] == [True, False, False, False]


@pytest.mark.parametrize("vec", list(VECTORS))
def test_tpu_zk_kzg_proof_verifies_in_port(vec, port_kzg, ref):
    """The port accepts tpu_zk's opening against tpu_zk's setup (handed over
    as arrays) and against its own, and rejects it tampered."""
    taus, _, opening = VECTORS[vec]
    want = ref["kzg"][vec]
    theirs = trusted_setup_from_arrays("bls12_381", want["g1_arrays"], want["g2"], len(taus))
    for setup in (theirs, port_kzg[vec][0]):
        assert kzg.verify(setup, want["commitment"], opening, serialize.kzg_proof_from_json(want["json"]))
    setup = theirs
    assert not kzg.verify(setup, want["commitment"], opening, _tamper_evaluation(serialize.kzg_proof_from_json(want["json"])))
    assert not kzg.verify(setup, want["commitment"], opening[:-1] + [opening[-1] + 1], serialize.kzg_proof_from_json(want["json"]))
    assert not kzg.verify(setup, want["commitment"], opening, _tamper_point(serialize.kzg_proof_from_json(want["json"])))
    # the port commits against tpu_zk's points to the same commitment
    assert kzg.commit_to_polynomial(port_kzg[vec][1], theirs) == want["commitment"]


def test_kzg_json_round_trip_and_shape_checks(port_kzg):
    setup, poly, commitment, proof = port_kzg["kzg1"]
    opening = VECTORS["kzg1"][2]
    again = serialize.kzg_proof_from_json(serialize.kzg_proof_to_json(proof))
    assert again == proof and kzg.verify(setup, commitment, opening, again)
    with pytest.raises(ValueError):
        serialize.kzg_proof_from_json(serialize.kzg_proof_to_json(proof).replace('"kzg"', '"gkr"'))
    short = kzg.MultilinearKZGProof(proof.evaluation, proof.proofs[:2])
    assert not kzg.verify(setup, commitment, opening[:2], short)
    with pytest.raises(ValueError):
        kzg.verify(setup, commitment, opening, short)
    with pytest.raises(ValueError):
        kzg.open_and_prove(poly, setup, opening[:2])
    with pytest.raises(ValueError):
        kzg.commit_to_polynomial(MultilinearPolynomial.from_ints(poly.ctx, [1, 2]), setup)
    with pytest.raises(ValueError):
        ts.TrustedSetup.initialize_setup("bls12_381", [])
    with pytest.raises(ValueError):
        trusted_setup_from_arrays("bls12_381", points_to_numpy(setup.g1_powers_of_tau), [], 3)


def test_taus_from_a_seed():
    r = params.CURVES["bn254"]["r"]
    a = ts.generate_values_for_tau("bn254", 5, seed=3)
    assert a == ts.generate_values_for_tau("bn254", 5, seed=3) != ts.generate_values_for_tau("bn254", 5, seed=4)
    assert len(a) == 5 and all(0 <= t < r for t in a)
    assert len(set(ts.generate_values_for_tau("bn254", 4))) == 4  # from the system's entropy


# -- the default device --------------------------------------------------------


def test_default_device_is_the_card():
    """With the default left alone, tensors made from host ints ask for
    ``cuda``: on a machine without a card that raises; ``device="cpu"`` and
    a scope or process default of the CPU work."""
    code = (
        "import torch\n"
        "from tpu_zk_torch import device\n"
        "from tpu_zk_torch.circuit.layered import tree_sum_circuit\n"
        "from tpu_zk_torch.fields.arith import field_ctx\n"
        "from tpu_zk_torch.gkr import sparse\n"
        "from tpu_zk_torch.kzg.trusted_setup import TrustedSetup\n"
        "from tpu_zk_torch.poly.multilinear import MultilinearPolynomial\n"
        "from tpu_zk_torch.sumcheck.basic import Prover\n"
        "ctx = field_ctx('bn254_fr')\n"
        "assert device.default_device() == torch.device('cuda') == device.resolve()\n"
        "circuit = tree_sum_circuit(ctx, 1)\n"
        "calls = [lambda: ctx.array([1]), lambda: ctx.scalar(1), lambda: MultilinearPolynomial.from_ints(ctx, [1, 2]),\n"
        "         lambda: Prover.init(ctx, [1, 2]), lambda: circuit.evaluate([1, 2]), lambda: sparse.prove(circuit, [1, 2]),\n"
        "         lambda: TrustedSetup.initialize_setup('bn254', [5])]\n"
        "if not torch.cuda.is_available():\n"
        "    for call in calls:\n"
        "        try:\n"
        "            call()\n"
        "        except (RuntimeError, AssertionError) as e:\n"
        "            assert 'cuda' in str(e).lower() or 'nvidia' in str(e).lower(), e\n"
        "        else:\n"
        "            raise SystemExit('a tensor was made with no card and no request for the CPU')\n"
        "else:\n"
        "    assert all(getattr(call(), 'device', torch.device('cuda', 0)).type == 'cuda' for call in calls[:2])\n"
        "assert ctx.array([1], device='cpu').device.type == 'cpu'\n"
        "assert Prover.init(ctx, [1, 2], device='cpu').prove().initial_claimed_sum == 3\n"
        "assert sparse.prove(circuit, [1, 2], device='cpu').circuit_output == [3]\n"
        "with device.using('cpu'):\n"
        "    assert ctx.scalar(1).device.type == 'cpu' and device.resolve('cuda:1') == torch.device('cuda', 1)\n"
        "assert device.default_device().type == 'cuda'\n"
        "assert device.set_default_device('cpu') == torch.device('cuda')\n"
        "assert ctx.array([1]).device.type == 'cpu'\n"
    )
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                          cwd=str(jax_reference.ROOT))
    assert done.returncode == 0, done.stderr + done.stdout
    assert tdevice.default_device() == torch.device("cpu")  # this file's own setting
    with tdevice.using("meta"):
        assert arith.field_ctx("bn254_fr").array([1]).device.type == "meta"
    assert tdevice.default_device() == torch.device("cpu")
