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


@pytest.fixture(scope="module", autouse=True)
def low_bucket_threshold():
    """Every MSM of 2 points or more takes the bucket method (K4's plain
    versions); a one-point MSM still takes double-and-add."""
    saved, mp.BUCKET_THRESHOLD = mp.BUCKET_THRESHOLD, 2
    yield
    mp.BUCKET_THRESHOLD = saved


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
    _, _, limbs = _msm_inputs()
    t = limbs_from_numpy(limbs)
    got = {
        "codes": lambda: mp.signed_digit_codes(t),
        "digits4": lambda: fixed_base.digits4(t),
        "digits8": lambda: mp._digits(t, 8),
        "scalar_bits": lambda: ec_device.scalar_bits(arith.field_ctx("bn254_fr"), t),
    }[what]()
    assert got.dtype == torch.int32
    assert np.array_equal(limbs_to_numpy(got), ref[what])


def test_signed_digits_sum_to_the_scalar():
    _, scalars, limbs = _msm_inputs()
    codes = mp.signed_digit_codes(limbs_from_numpy(limbs))
    assert codes.shape == (MSM_POINTS, 53)
    for s, row in zip(scalars, codes.tolist()):
        digits = [_digit(c) for c in row]
        assert all(-16 <= d <= 16 for d in digits)
        assert sum(d * 32**i for i, d in enumerate(digits)) == s
    # 256 bits leave window 51 one bit, so window 52 never gets a carry; 80 bits fill window 15
    # and 2^80 - 1 = 32^16 - 1 carries into the final window
    short = mp.signed_digit_codes(torch.full((1, 5), 0xFFFF, dtype=torch.int32))[0].tolist()
    assert [_digit(c) for c in short] == [-1] + [0] * 15 + [1]
    assert set(codes[7].tolist()) == {64}  # the zero scalar skips every window
    by_window = mp._codes_by_window(limbs_from_numpy(limbs))
    assert by_window.dtype == torch.uint8 and torch.equal(by_window.T.to(torch.int32), codes)


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


def _host_buckets(name, ks, codes, lanes):
    """The multiplier of G that each (window, lane, bucket) must hold."""
    r = params.CURVES[name]["r"]
    W, n = codes.shape
    want = np.zeros((W, lanes, kernels.BUCKETS), dtype=object)
    for w in range(W):
        for i in range(n):
            c = int(codes[w, i])
            if not c & 64:
                want[w, i % lanes, c & 15] += -ks[i] if c & 32 else ks[i]
    return want % r


@pytest.mark.parametrize("name,n,lanes", [("bn254", MSM_POINTS, 3), ("bn254", 5, 8), ("bls12_381", 12, 2)])
def test_k4_plain_versions_match_host(name, n, lanes):
    """K4a's buckets and K4b's weighted totals (through the wrappers, which
    on the CPU run the plain versions and the word packing) against host
    ints, bucket by bucket: duplicates, P and -P, identity points, scalars
    0, 1, r - 1 and 2^256 - 1, a ragged tail (64 = 21*3 + 1), n < lanes."""
    dc = _curve(name)
    ks, _, limbs = _msm_inputs()
    ks, limbs = ks[:n], limbs[:n]
    points = dc.points_to_device(_multiples(name, ks))
    codes = mp._codes_by_window(limbs_from_numpy(limbs))
    words = kernels.msm_buckets(dc.ctx, dc.b3, points, codes, lanes)
    assert words.shape == (53, lanes, kernels.BUCKETS, 3, dc.ctx.L // 2) and words.dtype == torch.int32
    want = _host_buckets(name, ks, codes.numpy(), lanes)
    got = dc.points_to_host(kernels.unpack_buckets(words))
    assert got == _multiples(name, want.reshape(-1).tolist())
    assert torch.equal(kernels.pack_buckets(kernels.unpack_buckets(words)), words)

    totals = kernels.msm_bucket_reduce(dc.ctx, dc.b3, words)
    weights = np.arange(1, kernels.BUCKETS + 1, dtype=object)
    want_totals = (want * weights).sum(axis=2) % dc.fr.p
    assert dc.points_to_host(totals) == _multiples(name, want_totals.reshape(-1).tolist())


def test_msm_pippenger_matches_tpu_zk(ref):
    """The bucket method against host ints and against tpu_zk's
    msm_pippenger, as affine points: 8 points over BLS12-381 (duplicate,
    P and -P, identity, scalars r - 1, 2^256 - 1, 0)."""
    dc = _curve("bls12_381")
    ks, scalars, limbs = _msm_inputs("bls12_381", 8)
    points = dc.points_to_device(_multiples("bls12_381", ks))
    got = dc.point_to_host(mp.msm_pippenger(dc.ctx, dc.b3, (points, limbs_from_numpy(limbs)), lanes=3))
    assert got == _multiples("bls12_381", [sum(k * s for k, s in zip(ks, scalars))])[0]
    assert got == ref["msm"]


def test_msm_pippenger_at_64_points_matches_host():
    """The bucket method forced at 64 BN254 points (ragged lanes) against
    host ints; a CPU tensor launches no kernel."""
    dc = _curve("bn254")
    ks, scalars, limbs = _msm_inputs()
    points = dc.points_to_device(_multiples("bn254", ks))
    before = kernels.msm_buckets.launches
    got = dc.point_to_host(mp.msm_pippenger(dc.ctx, dc.b3, (points, limbs_from_numpy(limbs)), lanes=5, threshold=64))
    assert got == _multiples("bn254", [sum(k * s for k, s in zip(ks, scalars))])[0]
    assert kernels.msm_buckets.launches == before


def test_msm_pippenger_size_rule():
    """Below the threshold the double-and-add MSM runs; at it, the bucket
    method; both give the same point.  All-zero scalars give the identity."""
    dc = _curve("bn254")
    ks, scalars, limbs = _msm_inputs()
    points = tuple(c[:3] for c in dc.points_to_device(_multiples("bn254", ks[:3])))
    s = limbs_from_numpy(limbs[:3])
    want = _multiples("bn254", [sum(k * x for k, x in zip(ks[:3], scalars[:3]))])[0]
    assert mp.BUCKET_THRESHOLD == 2
    assert dc.point_to_host(mp.msm_pippenger(dc.ctx, dc.b3, (points, s), threshold=4)) == want  # double-and-add
    assert dc.point_to_host(mp.msm_pippenger(dc.ctx, dc.b3, (points, s))) == want  # buckets
    assert dc.point_to_host(mp.msm_pippenger(dc.ctx, dc.b3, (points, torch.zeros_like(s)))) is None


def test_k4_wrappers_check_inputs():
    dc = _curve("bn254")
    ctx = dc.ctx
    points = dc.points_to_device(_multiples("bn254", [1, 2, 3, 4]))
    codes = torch.zeros((53, 4), dtype=torch.uint8)
    with pytest.raises(ValueError):
        kernels.msm_buckets(ctx, dc.b3, points, codes.to(torch.int32), 2)
    with pytest.raises(ValueError):
        kernels.msm_buckets(ctx, dc.b3, points, codes[:, :3].contiguous(), 2)
    with pytest.raises(ValueError):
        kernels.msm_buckets(ctx, dc.b3, points, codes, 0)
    with pytest.raises(TypeError):
        kernels.msm_buckets(ctx, dc.b3, tuple(c.to(torch.int64) for c in points), codes, 2)
    with pytest.raises(ValueError):
        kernels.msm_bucket_reduce(ctx, dc.b3, torch.zeros((53, 2, 16, 3, 12), dtype=torch.int32))
    meta = tuple(torch.empty((4, ctx.L), dtype=torch.int32, device="meta") for _ in range(3))
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no plain version, no launch
        kernels.msm_buckets(ctx, dc.b3.to("meta"), meta, codes.to("meta"), 2)
    assert kernels.default_lanes(ctx, 1 << 20, 53, "cpu") == kernels.CPU_LANES


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
