"""tpu_zk_torch's transcript, polynomials and basic sumcheck held against tpu_zk.

On the CPU the port runs its kernels' plain versions; proofs, transcript
bytes and field elements must equal tpu_zk's exactly (integer arithmetic,
tolerance zero).  Inputs come from ``numpy.random.default_rng``.

Every compiled tpu_zk computation runs once, in :func:`reference`, which the
module fixture calls in a fresh process (``tests/jax_reference.py``); the
host-only tpu_zk transcript and Keccak run here.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from tests import jax_reference
from tpu_zk.fields.arith import field_ctx as j_field_ctx
from tpu_zk.transcript import fiat_shamir as jfs
from tpu_zk.transcript.keccak import keccak256 as j_keccak256
from tpu_zk_torch import device as tdevice
from tpu_zk_torch.fields.arith import field_ctx
from tpu_zk_torch.gkr import sparse
from tpu_zk_torch.poly import multilinear
from tpu_zk_torch.poly.multilinear import MultilinearPolynomial
from tpu_zk_torch.sumcheck import basic
from tpu_zk_torch.transcript import fiat_shamir
from tpu_zk_torch.transcript.keccak import Keccak256, keccak256, keccak256_plain
from tpu_zk_torch.utils import serialize

tdevice.set_default_device("cpu")  # these tests run the plain versions, on the CPU
torch.set_num_threads(1)  # small tensors: more threads only take cores from the other test workers

SLICE_LOG_N = 10
SLICE_FIELDS = ["bn254_fq", "bn254_fr"]
PARTIAL_VARS = (0, 2, 5)
ROUND_LOG_N = 8


def rand_vals(p, n, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % p for _ in range(n)]


# -- transcript ----------------------------------------------------------------


def test_keccak_golden_vectors():
    assert keccak256(b"").hex() == "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"
    assert keccak256(b"abc").hex() == "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45"
    assert keccak256_plain(b"abc") == keccak256(b"abc")


@pytest.mark.parametrize("n", [0, 1, 135, 136, 137, 272, 1000])
def test_keccak_native_matches_numpy(n):
    data = np.random.default_rng(n).bytes(n)
    want = keccak256_plain(data)
    assert keccak256(data) == want == j_keccak256(data)
    # the same bytes absorbed in uneven pieces, digesting midway
    h = Keccak256()
    for i in range(0, n, 50):
        h.update(data[i : i + 50])
        h.digest()
    assert h.digest() == want


def test_transcript_matches_tpu_zk():
    ctx = field_ctx("bn254_fr")
    port, ref = fiat_shamir.Transcript(), jfs.Transcript()
    for i, chunk in enumerate([b"", b"x" * 135, np.random.default_rng(1).bytes(700), b"abc"]):
        port.append(chunk)
        ref.append(chunk)
        assert port.sample_random_challenge() == ref.sample_random_challenge()
        assert port.random_challenge_as_field_element(ctx) == ref.random_challenge_as_field_element(j_field_ctx(ctx.name))


def test_basic_transcript_first_challenge_golden():
    """Round-0 challenge by hand: keccak(poly_be || sum_be || univ_be), LE mod p.
    The round-1 univariate is the half-sums of [3*r0, 8*r0]."""
    ctx = field_ctx("bn254_fq")
    vals = [0, 0, 3, 8]
    proof = basic.Prover.init(ctx, vals).prove()
    assert proof.initial_claimed_sum == 11
    assert proof.round_univariate_polynomials[0].to_ints() == [0, 11]
    absorbed = b"".join(v.to_bytes(32, "big") for v in vals + [11, 0, 11])
    r0 = int.from_bytes(keccak256_plain(absorbed), "little") % ctx.p
    assert proof.round_univariate_polynomials[1].to_ints() == [3 * r0 % ctx.p, 8 * r0 % ctx.p]


# -- polynomials ---------------------------------------------------------------


def _mle_inputs():
    """(values of a 6-variable MLE, a point) over BN254 Fr."""
    p = field_ctx("bn254_fr").p
    return rand_vals(p, 64, 3), rand_vals(p, 6, 4)


def _round_inputs():
    """(a 2^8 table, a challenge) over BN254 Fr."""
    p = field_ctx("bn254_fr").p
    return rand_vals(p, 1 << ROUND_LOG_N, 6), rand_vals(p, 1, 7)[0]


def _segment_inputs():
    """(values, bucket indices, buckets) of a small segment sum over BN254 Fr."""
    rng = np.random.default_rng(8)
    return rand_vals(field_ctx("bn254_fr").p, 64, 9), rng.integers(0, 16, 64).tolist(), 16


def _slice_values(name):
    return rand_vals(field_ctx(name).p, 1 << SLICE_LOG_N, 5)


def _tamper(proof):
    proof.initial_claimed_sum += 1
    return proof


def reference(port_jsons: dict) -> dict:
    """Everything the tests compare against, computed by tpu_zk (in the
    child process): a first round's univariate, a fused round and a
    segment sum; an MLE's sum, bytes, evaluation and partial
    evaluations; per field the proof JSON of the slice's table, and
    tpu_zk's verdicts on the port's proof (as is, tampered)."""
    from tpu_zk.poly.multilinear import MultilinearPolynomial as JMLE
    from tpu_zk.sumcheck import basic as jbasic
    from tpu_zk.utils import serialize as jser

    from tpu_zk.gkr.sparse import mont_segment_sum as j_mont_segment_sum
    from tpu_zk.poly.multilinear import fused_round as j_fused_round, round0_univariate as j_round0_univariate

    fr = j_field_ctx("bn254_fr")
    table, r = _round_inputs()
    univariate, folded = j_fused_round(fr, fr.array(table), fr.scalar(r))
    vals, idx, size = _segment_inputs()
    names = {"round0_univariate": np.asarray(j_round0_univariate(fr, fr.array(table))),
             "fused_round": (np.asarray(univariate), np.asarray(folded)),
             "mont_segment_sum": np.asarray(j_mont_segment_sum(fr, fr.array(vals), np.asarray(idx, np.int32), size))}
    vals, point = _mle_inputs()
    mle = JMLE.from_ints(fr, vals)
    out = {"names": names, "mle": {
        "sum": mle.sum(), "bytes": mle.convert_to_bytes(), "evaluate": mle.evaluate(point),
        "partial": [mle.partial_evaluate(var, point[var]).to_ints() for var in PARTIAL_VARS],
    }}
    for name in SLICE_FIELDS:
        port = port_jsons[name]
        out[name] = {
            "json": jser.sumcheck_proof_to_json(jbasic.Prover.init(j_field_ctx(name), _slice_values(name)).prove()),
            "port_verdicts": [jbasic.Verifier.init().verify(change(jser.sumcheck_proof_from_json(port)))
                              for change in (lambda q: q, _tamper)],
        }
    return out


@pytest.fixture(scope="module")
def port_jsons():
    """The port's proof JSON of the slice's 2^10 table, per field."""
    return {name: serialize.sumcheck_proof_to_json(basic.Prover.init(field_ctx(name), _slice_values(name)).prove())
            for name in SLICE_FIELDS}


@pytest.fixture(scope="module")
def ref(port_jsons):
    return jax_reference.call("tests.test_torch_sumcheck", "reference", port_jsons)


def test_multilinear_matches_tpu_zk(ref):
    ctx = field_ctx("bn254_fr")
    vals, point = _mle_inputs()
    port, want = MultilinearPolynomial.from_ints(ctx, vals), ref["mle"]
    assert port.sum() == want["sum"]
    assert port.convert_to_bytes() == want["bytes"]
    assert port.evaluate(point) == want["evaluate"]
    for var, partial in zip(PARTIAL_VARS, want["partial"]):
        assert port.partial_evaluate(var, point[var]).to_ints() == partial


def test_round0_univariate_matches_tpu_zk(ref):
    ctx = field_ctx("bn254_fr")
    table, _ = _round_inputs()
    got = multilinear.round0_univariate(ctx, ctx.array(table))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), ref["names"]["round0_univariate"])


def test_fused_round_matches_tpu_zk(ref):
    ctx = field_ctx("bn254_fr")
    table, r = _round_inputs()
    univariate, folded = multilinear.fused_round(ctx, ctx.array(table), ctx.scalar(r))
    want_univariate, want_folded = ref["names"]["fused_round"]
    np.testing.assert_array_equal(univariate.numpy().view(np.uint32), want_univariate)
    np.testing.assert_array_equal(folded.numpy().view(np.uint32), want_folded)
    # the next round's univariate of the folded table: the plain half sums
    assert ctx.to_ints(univariate, mont=False) == ctx.to_ints(multilinear.round0_univariate(ctx, folded), mont=False)


def test_mont_segment_sum_matches_tpu_zk(ref):
    ctx = field_ctx("bn254_fr")
    vals, idx, size = _segment_inputs()
    got = sparse.mont_segment_sum(ctx, ctx.array(vals), torch.tensor(idx), size)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), ref["names"]["mont_segment_sum"])
    assert ctx.to_ints(got) == [sum(v for v, i in zip(vals, idx) if i == b) % ctx.p for b in range(size)]


def test_package_names_match_tpu_zk():
    import tpu_zk

    import tpu_zk_torch
    from tpu_zk_torch.fields import arith

    assert tpu_zk_torch.field_ctx is arith.field_ctx
    assert tpu_zk_torch.__all__ == tpu_zk.__all__ == ["field_ctx"]
    assert tpu_zk_torch.__version__ == tpu_zk.__version__


# -- the whole slice -----------------------------------------------------------


@pytest.fixture(params=SLICE_FIELDS)
def slice_proofs(request, port_jsons, ref):
    """One proof of the same 2^10 table from each package, and tpu_zk's
    verdicts on the port's."""
    name = request.param
    return port_jsons[name], ref[name]["json"], ref[name]["port_verdicts"]


def test_proof_json_equals_tpu_zk(slice_proofs):
    port, ref, _ = slice_proofs
    assert port == ref


def test_port_proof_verifies_in_tpu_zk(slice_proofs):
    """tpu_zk accepts the port's proof and rejects it tampered."""
    _, _, verdicts = slice_proofs
    assert verdicts == [True, False]


def test_tpu_zk_proof_verifies_in_port(slice_proofs):
    _, ref, _ = slice_proofs
    assert basic.Verifier.init().verify(serialize.sumcheck_proof_from_json(ref))
    assert not basic.Verifier.init().verify(_tamper(serialize.sumcheck_proof_from_json(ref)))


def test_tampered_round_univariate_fails():
    ctx = field_ctx("bls12_381_fr")
    proof = basic.Prover.init(ctx, rand_vals(ctx.p, 16, 6)).prove()
    assert basic.Verifier.init().verify(proof)
    u0, u1 = proof.round_univariate_polynomials[2].to_ints()
    proof.round_univariate_polynomials[2] = MultilinearPolynomial.from_ints(ctx, [u0 + 1, u1 - 1])
    assert not basic.Verifier.init().verify(proof)


def test_import_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import tpu_zk_torch.sumcheck.basic, tpu_zk_torch.utils.serialize, tpu_zk_torch.utils.convert\n"
        "import tpu_zk_torch.gkr.sparse, tpu_zk_torch.sumcheck.gkr_sumcheck, tpu_zk_torch.circuit.layered\n"
        "import tpu_zk_torch.poly.composed, tpu_zk_torch.poly.univariate, tpu_zk_torch.gkr.breakdown\n"
        "import tpu_zk_torch.device, tpu_zk_torch.gkr.succinct, tpu_zk_torch.kzg.multilinear_kzg\n"
        "import tpu_zk_torch.kzg.trusted_setup, tpu_zk_torch.curves.params, tpu_zk_torch.curves.pairing\n"
        "import tpu_zk_torch.curves.host_ec, tpu_zk_torch.curves.pairing_native, tpu_zk_torch.curves.ec_device\n"
        "import tpu_zk_torch.curves.fixed_base, tpu_zk_torch.curves.kernels, tpu_zk_torch.curves.msm_pippenger\n"
        "import tpu_zk_torch.ntt.ntt, tpu_zk_torch.ntt.sixstep, tpu_zk_torch.ntt.kernels, tpu_zk_torch.fri.fri\n"
        "import tpu_zk_torch.merkle.merkle, tpu_zk_torch.merkle.device_merkle, tpu_zk_torch.merkle.kernels\n"
        "import tpu_zk_torch.gkr.protocol, tpu_zk_torch.gkr.wiring, tpu_zk_torch.gkr.fused_sparse\n"
        "import tpu_zk_torch.sumcheck.interactive, tpu_zk_torch.shamir.shamir, tpu_zk_torch.apps.fib\n"
        "import tpu_zk_torch.transcript.device_fs, tpu_zk_torch.transcript.kernels, tpu_zk_torch.sumcheck.fused\n"
        "import tpu_zk_torch.utils.counters, tpu_zk_torch.utils.roofline, tpu_zk_torch.utils.checkpoint\n"
        "import tpu_zk_torch.parallel.mesh, tpu_zk_torch.parallel.sharded_sumcheck, tpu_zk_torch.parallel.sharded_msm\n"
        "import tpu_zk_torch.parallel.sharded_merkle, tpu_zk_torch.parallel.sharded_ntt, tpu_zk_torch.parallel.sharded_fri\n"
        "import tpu_zk_torch.parallel.sharded_gkr, tpu_zk_torch.parallel.dryrun\n"
        "import chip_smoke\n"
        "assert not [m for m in sys.modules if m == 'tpu_zk' or m.startswith('tpu_zk.')], 'imported tpu_zk'\n"
    )
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                          cwd=str(jax_reference.ROOT))
    assert done.returncode == 0, done.stderr
