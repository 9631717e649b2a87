"""tpu_zk_torch's transcript, polynomials and basic sumcheck held against tpu_zk.

On the CPU the port runs its kernels' plain versions; proofs, transcript
bytes and field elements must equal tpu_zk's exactly (integer arithmetic,
tolerance zero).  Inputs come from ``numpy.random.default_rng``.
"""

import subprocess
import sys

import numpy as np
import pytest

from tpu_zk.fields.arith import field_ctx as j_field_ctx
from tpu_zk.poly.multilinear import MultilinearPolynomial as JMLE
from tpu_zk.sumcheck import basic as jbasic
from tpu_zk.transcript import fiat_shamir as jfs
from tpu_zk.transcript.keccak import keccak256 as j_keccak256
from tpu_zk.utils import serialize as jser
from tpu_zk_torch.fields.arith import field_ctx
from tpu_zk_torch.poly.multilinear import MultilinearPolynomial
from tpu_zk_torch.sumcheck import basic
from tpu_zk_torch.transcript import fiat_shamir
from tpu_zk_torch.transcript.keccak import Keccak256, keccak256, keccak256_plain
from tpu_zk_torch.utils import serialize

SLICE_LOG_N = 10


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


def test_multilinear_matches_tpu_zk():
    ctx, jctx = field_ctx("bn254_fr"), j_field_ctx("bn254_fr")
    vals = rand_vals(ctx.p, 64, 3)
    port, ref = MultilinearPolynomial.from_ints(ctx, vals), JMLE.from_ints(jctx, vals)
    assert port.sum() == ref.sum()
    assert port.convert_to_bytes() == ref.convert_to_bytes()
    point = rand_vals(ctx.p, 6, 4)
    assert port.evaluate(point) == ref.evaluate(point)
    for var in (0, 2, 5):
        assert port.partial_evaluate(var, point[var]).to_ints() == ref.partial_evaluate(var, point[var]).to_ints()


# -- the whole slice -----------------------------------------------------------


@pytest.fixture(scope="module", params=["bn254_fq", "bn254_fr"])
def slice_proofs(request):
    """One proof of the same 2^10 table from each package (tpu_zk runs once per field)."""
    name = request.param
    ctx = field_ctx(name)
    vals = rand_vals(ctx.p, 1 << SLICE_LOG_N, 5)
    port = serialize.sumcheck_proof_to_json(basic.Prover.init(ctx, vals).prove())
    ref = jser.sumcheck_proof_to_json(jbasic.Prover.init(j_field_ctx(name), vals).prove())
    return port, ref


def _tamper(proof):
    proof.initial_claimed_sum += 1
    return proof


def test_proof_json_equals_tpu_zk(slice_proofs):
    port, ref = slice_proofs
    assert port == ref


def test_port_proof_verifies_in_tpu_zk(slice_proofs):
    port, _ = slice_proofs
    assert jbasic.Verifier.init().verify(jser.sumcheck_proof_from_json(port))
    assert not jbasic.Verifier.init().verify(_tamper(jser.sumcheck_proof_from_json(port)))


def test_tpu_zk_proof_verifies_in_port(slice_proofs):
    _, ref = slice_proofs
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
        "assert not [m for m in sys.modules if m == 'tpu_zk' or m.startswith('tpu_zk.')], 'imported tpu_zk'\n"
    )
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr
