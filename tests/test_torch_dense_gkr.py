"""tpu_zk_torch's dense GKR pipeline, interactive sumcheck, transcript
snapshots and apps held against tpu_zk.

The same circuits and inputs (random inputs from ``numpy.random.default_rng``)
go through ``tpu_zk.gkr.protocol.prove`` / ``succinct.prove_succinct`` and
through the port's; the proof JSON must be equal byte for byte, equal to the
port's own linear-time (``sparse``, ``fused_sparse``) provers' too, and each
package must accept the other's proof and reject a tampered one.  Beside the
protocols: the dense wiring tables, the alpha/beta folds and the verifier's
layer claims, ``evaluate(materialize=)``, the multilinear, composed and
field-arithmetic additions, the interactive prover under fixed challenges,
Keccak and Transcript snapshot blobs, Shamir shares and the Fibonacci
interpolation.  On the CPU the port runs its kernels' plain versions;
everything is integer arithmetic, so every comparison is exact (tolerance
zero).

Every compiled tpu_zk computation runs once, in :func:`reference`, which the
module fixture calls in a fresh process (``tests/jax_reference.py``).
"""

import concurrent.futures

import numpy as np
import pytest
import torch

from tests import jax_reference
from tpu_zk.circuit import layered as jlayered
from tpu_zk.fields import arith as jarith
from tpu_zk_torch import device as tdevice
from tpu_zk_torch.apps import fib
from tpu_zk_torch.circuit.layered import convert_to_binary_and_to_decimal
from tpu_zk_torch.fields import arith
from tpu_zk_torch.gkr import breakdown, fused_sparse, protocol, sparse, succinct, wiring
from tpu_zk_torch.kzg.trusted_setup import TrustedSetup
from tpu_zk_torch.poly.composed import ProductPolynomial
from tpu_zk_torch.poly.multilinear import MultilinearPolynomial, tensor_add, tensor_mul
from tpu_zk_torch.shamir import shamir
from tpu_zk_torch.sumcheck import interactive
from tpu_zk_torch.transcript.fiat_shamir import Transcript
from tpu_zk_torch.transcript.keccak import Keccak256
from tpu_zk_torch.utils import serialize
from tpu_zk_torch.utils.convert import circuit_from_arrays, limbs_to_numpy

tdevice.set_default_device("cpu")  # these tests run the plain versions, on the CPU
torch.set_num_threads(1)  # small tensors: more threads only take cores from the other test workers

JG = jlayered.Gate
DENSE_CASES = ["bn254_fq two layers", "bn254_fr mixed tree depth 3", "bn254_fr add tree depth 4"]
SUCCINCT_CASE = "bls12_381 two layers"
WIRING_CASE = "bn254_fr add tree depth 4"  # its layers 0-3 give tables of 2^3, 2^5, 2^8, 2^11
FOLD_CASE = "bn254_fr mixed tree depth 3"  # the alpha/beta fold of its layer 2 (2 + 3 + 3 variables)
SNAPSHOT_LENGTHS = (0, 100, 136, 300)  # bytes absorbed: empty, a tail, one full block, blocks and a tail
POW_EXPONENTS = (0, 1, 5, 2**64 + 3)


def _rand(p, n, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % p for _ in range(n)]


def mixed_tree(ctx, depth):
    """tree_sum_circuit's shape with gate g of each layer ADD for even g and
    MUL for odd g (a tpu_zk circuit)."""
    layers = []
    for i in range(depth):
        g = np.arange(1 << i, dtype=np.int32)
        layers.append(jlayered.Layer.from_arrays(2 * g, 2 * g + 1, g, g % 2))
    return jlayered.Circuit(ctx, layers)


def _case(name):
    """(tpu_zk circuit, inputs) of one named circuit."""
    if name == "bn254_fq two layers":  # tests/test_gkr.py:10 (gkr_protocol.rs:247-262)
        ctx = jarith.field_ctx("bn254_fq")
        return jlayered.Circuit(ctx, [jlayered.Layer([JG.mul(0, 1, 0)]),
                                      jlayered.Layer([JG.add(0, 1, 0), JG.mul(2, 3, 1)])]), [2, 3, 4, 5]
    if name == SUCCINCT_CASE:  # tests/test_succinct_gkr.py:14 (succinct_gkr_protocol.rs:302-324)
        ctx = jarith.field_ctx("bls12_381_fr")
        return jlayered.Circuit(ctx, [jlayered.Layer([JG.mul(0, 1, 0)]),
                                      jlayered.Layer([JG.add(0, 1, 0), JG.mul(2, 3, 1)])]), [2, 3, 4, 5]
    ctx = jarith.field_ctx("bn254_fr")
    if name == "bn254_fr mixed tree depth 3":
        return mixed_tree(ctx, 3), _rand(ctx.p, 8, 21)
    if name == "bn254_fr add tree depth 4":
        return jlayered.tree_sum_circuit(ctx, 4, op=jlayered.ADD), _rand(ctx.p, 16, 22)
    raise KeyError(name)


SUCCINCT_TAUS = [5, 2]


def _same(proof):
    return proof


def _tamper_claim(proof):
    proof.sumcheck_proofs[0].claimed_sum += 1
    return proof


def _tamper_wb(proof):
    proof.wb_evaluations[0] += 1
    return proof


def _tamper_round(proof):
    u = proof.sumcheck_proofs[-1].round_univariate_polynomials[0]
    u.coefficients[1] = (u.coefficients[1] + 1) % u.ctx.p
    return proof


def _tamper_kzg_evaluation(proof):
    proof.input_rb_proof.evaluation += 1
    return proof


DENSE_TAMPERS = (_tamper_claim, _tamper_wb, _tamper_round)
SUCCINCT_TAMPERS = (_tamper_claim, _tamper_wb, _tamper_kzg_evaluation)


def _fold_inputs():
    """(alpha, beta, rb, rc, the layer's sumcheck point, wb, wc, ra) for the
    alpha/beta fold and the layer claims, random BN254 Fr ints."""
    p = jarith.field_ctx("bn254_fr").p
    v = _rand(p, 15, 23)
    return v[0], v[1], v[2:4], v[4:6], v[6:12], v[12], v[13], v[14]


def _ml_inputs():
    """Two random 8-entry BN254 Fr tables, a scalar and an exponent base."""
    p = jarith.field_ctx("bn254_fr").p
    v = _rand(p, 19, 24)
    return v[:8], v[8:16], v[16], v[17:19]


def _interactive_inputs():
    """A random 16-entry BLS12-381 Fr table and four fixed challenges."""
    p = jarith.field_ctx("bls12_381_fr").p
    v = _rand(p, 20, 25)
    return v[:16], v[16:]


def _snapshot_data(n):
    return bytes(np.random.default_rng(n).integers(0, 256, size=n, dtype=np.uint8))


def _transcript_for_snapshot(transcript_cls, ctx):
    """A transcript that has absorbed, squeezed, and absorbed a tail."""
    t = transcript_cls()
    t.append(_snapshot_data(300))
    t.random_challenge_as_field_element(ctx)
    t.append(b"tail")
    return t


def _dense_reference(name, port: dict) -> dict:
    """tpu_zk's dense proof JSON of one case, its verdicts on the port's
    proof (as is, then each tampering) and its layer evaluations."""
    from tpu_zk.gkr import protocol as jprotocol
    from tpu_zk.utils import serialize as jser

    jc, inputs = _case(name)
    proof = jprotocol.prove(jc, inputs)
    return {
        "json": jser.gkr_proof_to_json(proof, jc.ctx.name),
        "port_verdicts": [jprotocol.verify(jc, change(jser.gkr_proof_from_json(port["dense"][name])), inputs)
                          for change in (_same,) + DENSE_TAMPERS],
        "layer_evaluations": jc.evaluate(inputs).layer_evaluations,
    }


def _succinct_reference(port: dict) -> dict:
    from tpu_zk.gkr import succinct as jsuccinct
    from tpu_zk.kzg.trusted_setup import TrustedSetup as JTrustedSetup
    from tpu_zk.utils import serialize as jser

    jc, inputs = _case(SUCCINCT_CASE)
    setup = JTrustedSetup.initialize_setup("bls12_381", SUCCINCT_TAUS)
    proof = jsuccinct.prove_succinct(jc, inputs, setup)
    return {
        "json": jser.succinct_proof_to_json(proof, jc.ctx.name),
        "port_verdicts": [jsuccinct.verify_succinct(jc, change(jser.succinct_proof_from_json(port["succinct"])), setup)
                          for change in (_same,) + SUCCINCT_TAMPERS],
    }


def reference(port: dict) -> dict:
    """Everything the tests compare against, computed by tpu_zk (in the
    child process).

    Each tpu_zk dense prove compiles one sumcheck program a layer (~2 s of
    compile a round), ~110 s for the four protocol cases one after another,
    so each case compiles in a thread of its own while this thread computes
    the rest.  Each dense proof is verified once, as the port's proof: the same
    bytes as tpu_zk's own when the JSON tests pass.
    """
    with concurrent.futures.ThreadPoolExecutor(max_workers=len(DENSE_CASES) + 1) as pool:
        dense = {name: pool.submit(_dense_reference, name, port) for name in DENSE_CASES}
        succinct_case = pool.submit(_succinct_reference, port)
        out = _rest_reference(port)
        out["dense"] = {name: future.result() for name, future in dense.items()}
        out["succinct"] = succinct_case.result()
    return out


def _rest_reference(port: dict) -> dict:
    """tpu_zk's wiring tables, folds and claims, polynomial and field
    results, interactive rounds, snapshots, shares and Fibonacci values."""
    from tpu_zk.apps import fib as jfib
    from tpu_zk.gkr import wiring as jwiring
    from tpu_zk.poly.composed import ProductPolynomial as JProduct
    from tpu_zk.poly.multilinear import MultilinearPolynomial as JMLE
    from tpu_zk.poly.multilinear import tensor_add as j_tensor_add
    from tpu_zk.poly.multilinear import tensor_mul as j_tensor_mul
    from tpu_zk.shamir import shamir as jshamir
    from tpu_zk.sumcheck import interactive as jinteractive
    from tpu_zk.transcript.fiat_shamir import Transcript as JTranscript
    from tpu_zk.transcript.keccak import Keccak256 as JKeccak

    out = {}
    jc, _ = _case(WIRING_CASE)
    out["wiring_tables"] = [[m.to_ints() for m in jc.add_i_and_mul_i_mle(i)] for i in range(4)]
    jc, _ = _case(FOLD_CASE)
    ctx = jc.ctx
    alpha, beta, rb, rc, point, wb, wc, ra = _fold_inputs()
    pair = jwiring.WiringPair.for_layer(jc, 2)
    out["alpha_beta_fold"] = ctx.to_ints(pair.alpha_beta_fold(alpha, beta, rb, rc).stacked.reshape(-1, ctx.L))
    out["pair_evaluate"] = pair.evaluate(rb + point)
    out["claim_layer0"] = jwiring.expected_layer_claim(jc, 0, point[:2], wb, wc, initial_random_challenge=ra)
    out["claim_layer2"] = jwiring.expected_layer_claim(jc, 2, point, wb, wc, previous_sumcheck_challenges=rb + rc,
                                                       alpha=alpha, beta=beta)

    a, b, s, (x, y) = _ml_inputs()
    pa, pb = JMLE.from_ints(ctx, a), JMLE.from_ints(ctx, b)
    xs = ctx.array([x, y])
    out["multilinear"] = {
        "scalar_mul": pa.scalar_mul(s).to_ints(), "add": pa.add(pb).to_ints(),
        "tensor_add": pa.tensor_add(pb).to_ints(), "tensor_mul": pa.tensor_mul(pb).to_ints(),
        "module tensor_add": ctx.to_ints(j_tensor_add(ctx, pa.table[:4], pb.table[:2])),
        "module tensor_mul": ctx.to_ints(j_tensor_mul(ctx, pa.table[:2], pb.table[:4])),
        "len": len(pa), "eq": [pa == JMLE.from_ints(ctx, a), pa == pb],
    }
    prod = JProduct.from_mles([pa, pb, pa])
    out["composed"] = {
        "partial": [prod.partial_evaluate(var, s).stacked.tolist() for var in (0, 2)],
        "elementwise": prod.multiply_polynomials_element_wise().to_ints(),
        "mles": [m.to_ints() for m in prod.mles()],
    }
    out["arith"] = {
        "mont_sqr": ctx.to_ints(jarith.mont_sqr(ctx, xs)),
        "scalar_mul": ctx.to_ints(jarith.scalar_mul(ctx, xs, ctx.scalar(s))),
        "pow": [ctx.to_ints(jarith.pow_mont(ctx, xs, e)) for e in POW_EXPONENTS],
        "inv_mont": ctx.to_ints(jarith.inv_mont(ctx, xs)), "inv_host": jarith.inv_host(ctx, x),
        "zero": np.asarray(ctx.zero).tolist(), "to_limbs": np.asarray(ctx.to_limbs(x)).tolist(),
        "from_limbs": ctx.from_limbs(ctx.to_limbs(x)), "from_mont_int": ctx.from_mont_int(x),
    }

    bls = jarith.field_ctx("bls12_381_fr")
    values, challenges = _interactive_inputs()
    prover = jinteractive.Prover(JMLE.from_ints(bls, values))
    out["interactive"] = [prover.prove(c) for c in [0] + challenges]

    out["keccak_snapshots"] = {n: JKeccak().update(_snapshot_data(n)).snapshot() for n in SNAPSHOT_LENGTHS}
    out["keccak_resumed"] = {n: JKeccak.from_snapshot(port["keccak_snapshots"][n]).update(b"more").digest()
                             for n in SNAPSHOT_LENGTHS}
    out["transcript_snapshot"] = _transcript_for_snapshot(JTranscript, ctx).snapshot()
    resumed = JTranscript.from_snapshot(port["transcript_snapshot"])
    out["transcript_resumed"] = resumed.random_challenge_as_field_element(ctx)

    fq = jarith.field_ctx("bn254_fq")
    out["shares"] = jshamir.shares(fq, 17, threshold=4, number_shares=10)
    out["s_shares"] = jshamir.s_shares(fq, 99, password=42, threshold=3, number_shares=8)
    out["port_recovered"] = [jshamir.recover_secret(fq, port["shares"]), jshamir.recover_secret(fq, port["shares"][:4]),
                             jshamir.s_recover_secret(fq, port["s_shares"], password=42)]
    out["fib"] = [jfib.evaluation(fq, x) for x in range(10)]
    return out


def _port_circuit(name):
    jc, inputs = _case(name)
    return circuit_from_arrays(arith.field_ctx(jc.ctx.name), jc.layers), inputs


@pytest.fixture(scope="module")
def port():
    """What the reference process needs from the port: its proofs, shares
    and snapshots."""
    out = {"dense": {}}
    for name in DENSE_CASES:
        c, inputs = _port_circuit(name)
        out["dense"][name] = serialize.gkr_proof_to_json(protocol.prove(c, inputs), c.ctx.name)
    c, inputs = _port_circuit(SUCCINCT_CASE)
    setup = TrustedSetup.initialize_setup("bls12_381", SUCCINCT_TAUS)
    out["succinct"] = serialize.succinct_proof_to_json(succinct.prove_succinct(c, inputs, setup), c.ctx.name)
    out["keccak_snapshots"] = {n: Keccak256().update(_snapshot_data(n)).snapshot() for n in SNAPSHOT_LENGTHS}
    out["transcript_snapshot"] = _transcript_for_snapshot(Transcript, arith.field_ctx("bn254_fr")).snapshot()
    fq = arith.field_ctx("bn254_fq")
    out["shares"] = shamir.shares(fq, 17, threshold=4, number_shares=10)
    out["s_shares"] = shamir.s_shares(fq, 99, password=42, threshold=3, number_shares=8)
    return out


@pytest.fixture(scope="module")
def ref(port):
    return jax_reference.call("tests.test_torch_dense_gkr", "reference", port, timeout=900)


# -- the dense protocols -------------------------------------------------------


@pytest.mark.parametrize("name", DENSE_CASES)
def test_dense_proof_json_equals_tpu_zk(name, port, ref):
    assert port["dense"][name] == ref["dense"][name]["json"]


@pytest.mark.parametrize("name", DENSE_CASES)
def test_dense_proof_json_equals_the_linear_time_provers(name, port):
    """The identity tpu_zk's tests/test_sparse_gkr.py holds: dense, sparse
    and fused_sparse proofs are the same bytes."""
    c, inputs = _port_circuit(name)
    assert serialize.gkr_proof_to_json(sparse.prove(c, inputs), c.ctx.name) == port["dense"][name]
    assert serialize.gkr_proof_to_json(fused_sparse.prove(c, inputs), c.ctx.name) == port["dense"][name]


@pytest.mark.parametrize("name", DENSE_CASES)
def test_port_dense_proof_verifies_in_tpu_zk(name, ref):
    """tpu_zk accepts the port's proof (the same bytes as its own) and
    rejects it with a tampered claim, wb evaluation or round coefficient."""
    assert ref["dense"][name]["port_verdicts"] == [True, False, False, False]


@pytest.mark.parametrize("name", DENSE_CASES)
def test_tpu_zk_dense_proof_verifies_in_port(name, ref):
    """The port's dense verifier and its sparse one accept tpu_zk's proof and
    reject it tampered or with other inputs."""
    c, inputs = _port_circuit(name)
    fresh = lambda: serialize.gkr_proof_from_json(ref["dense"][name]["json"])  # noqa: E731
    bad = list(inputs)
    bad[-1] += 1
    for verify in (protocol.verify, sparse.verify):
        assert verify(c, fresh(), inputs)
        assert not any(verify(c, change(fresh()), inputs) for change in DENSE_TAMPERS)
        assert not verify(c, fresh(), bad)


def test_dense_verify_rejects_proofs_of_the_wrong_shape(port):
    c, inputs = _port_circuit("bn254_fr add tree depth 4")
    fresh = lambda: serialize.gkr_proof_from_json(port["dense"]["bn254_fr add tree depth 4"])  # noqa: E731
    short = fresh()
    short.sumcheck_proofs[1].round_univariate_polynomials.pop()
    fewer = fresh()
    fewer.sumcheck_proofs.pop()
    no_wc = fresh()
    no_wc.wc_evaluations.pop()
    assert protocol.verify(c, fresh(), inputs)
    assert not any(protocol.verify(c, q, inputs) for q in (short, fewer, no_wc))


def test_dense_succinct_proof_json_equals_tpu_zk(port, ref):
    assert port["succinct"] == ref["succinct"]["json"]


def test_dense_succinct_proof_json_equals_the_linear_time_provers(port):
    c, inputs = _port_circuit(SUCCINCT_CASE)
    setup = TrustedSetup.initialize_setup("bls12_381", SUCCINCT_TAUS)
    for prove in (sparse.prove_succinct, fused_sparse.prove_succinct):
        assert serialize.succinct_proof_to_json(prove(c, inputs, setup), c.ctx.name) == port["succinct"]


def test_dense_succinct_proofs_cross_verify(port, ref):
    """Each package accepts the other's succinct proof and rejects it with a
    tampered claim, wb evaluation or KZG evaluation; so do the port's dense
    and sparse verifiers, on the reference's proof."""
    assert ref["succinct"]["port_verdicts"] == [True, False, False, False]
    c, _ = _port_circuit(SUCCINCT_CASE)
    setup = TrustedSetup.initialize_setup("bls12_381", SUCCINCT_TAUS)
    fresh = lambda: serialize.succinct_proof_from_json(ref["succinct"]["json"])  # noqa: E731
    for verify in (succinct.verify_succinct, sparse.verify_succinct):
        assert verify(c, fresh(), setup)
        assert not any(verify(c, change(fresh()), setup) for change in SUCCINCT_TAMPERS)


# -- wiring, circuit, polynomial and field pieces ------------------------------------


def test_wiring_tables_equal_tpu_zk(ref):
    """Layers 0-3 of the depth-4 tree (tables of 2^3 to 2^11 entries): both
    views of one [2, N, L] tensor, equal to tpu_zk's two tables."""
    c, _ = _port_circuit(WIRING_CASE)
    for i, want in enumerate(ref["wiring_tables"]):
        add_i, mul_i = c.add_i_and_mul_i_mle(i)
        assert [add_i.to_ints(), mul_i.to_ints()] == want
        assert add_i.table.data_ptr() + add_i.table.numel() * 4 == mul_i.table.data_ptr()
        assert torch.equal(c.wiring_table(i), torch.stack([add_i.table, mul_i.table]))


def test_wiring_indicator_positions():
    """tests/test_circuit.py's circuit: add at 17 ("10001") and mul at 11
    ("01011") on layer 1, add at 1 on layer 0 (arithmetic_circuit.rs:321-384)."""
    fq = arith.field_ctx("bn254_fq")
    jc = jlayered.Circuit(jarith.field_ctx("bn254_fq"),
                          [jlayered.Layer([JG.add(0, 1, 0)]), jlayered.Layer([JG.add(0, 1, 1), JG.mul(2, 3, 0)])])
    c = circuit_from_arrays(fq, jc.layers)
    add_0, mul_0 = c.add_i_and_mul_i_mle(0)
    assert add_0.to_ints() == [0, 1, 0, 0, 0, 0, 0, 0] and mul_0.to_ints() == [0] * 8
    add_1, mul_1 = c.add_i_and_mul_i_mle(1)
    assert add_1.to_ints() == [int(k == 17) for k in range(32)]
    assert mul_1.to_ints() == [int(k == 11) for k in range(32)]
    assert [convert_to_binary_and_to_decimal(1, *abc) for abc in ((0, 0, 1), (1, 0, 1), (0, 2, 3))] == [1, 17, 11]


def test_alpha_beta_fold_and_layer_claims_equal_tpu_zk(ref):
    c, _ = _port_circuit(FOLD_CASE)
    ctx = c.ctx
    alpha, beta, rb, rc, point, wb, wc, ra = _fold_inputs()
    pair = wiring.WiringPair.for_layer(c, 2)
    assert ctx.to_ints(pair.alpha_beta_fold(alpha, beta, rb, rc).stacked.reshape(-1, ctx.L)) == ref["alpha_beta_fold"]
    assert pair.evaluate(rb + point) == ref["pair_evaluate"]
    assert wiring.expected_layer_claim(c, 0, point[:2], wb, wc, initial_random_challenge=ra) == ref["claim_layer0"]
    assert wiring.expected_layer_claim(c, 2, point, wb, wc, previous_sumcheck_challenges=rb + rc,
                                       alpha=alpha, beta=beta) == ref["claim_layer2"]
    add_i, mul_i = pair.split()
    assert torch.equal(wiring.WiringPair.of(add_i, mul_i).stacked, pair.stacked)
    assert wiring.gate_claim(ctx, 2, 3, 5, 7) == 2 * 12 + 3 * 35


@pytest.mark.parametrize("name", DENSE_CASES)
def test_layer_evaluations_equal_tpu_zk(name, ref):
    c, inputs = _port_circuit(name)
    full = c.evaluate(inputs)
    assert full.layer_evaluations == ref["dense"][name]["layer_evaluations"]
    lean = c.evaluate(inputs, materialize=False)
    assert lean.layer_evaluations == [lean.output] == [full.output]
    for layer_index, table in enumerate(full.layer_tables):
        assert torch.equal(c.w_i_polynomial(full, layer_index).table, table)


def test_multilinear_additions_equal_tpu_zk(ref):
    ctx = arith.field_ctx("bn254_fr")
    a, b, s, _ = _ml_inputs()
    pa, pb = MultilinearPolynomial.from_ints(ctx, a), MultilinearPolynomial.from_ints(ctx, b)
    got = {
        "scalar_mul": pa.scalar_mul(s).to_ints(), "add": pa.add(pb).to_ints(),
        "tensor_add": pa.tensor_add(pb).to_ints(), "tensor_mul": pa.tensor_mul(pb).to_ints(),
        "module tensor_add": ctx.to_ints(tensor_add(ctx, pa.table[:4], pb.table[:2])),
        "module tensor_mul": ctx.to_ints(tensor_mul(ctx, pa.table[:2], pb.table[:4])),
        "len": len(pa), "eq": [pa == MultilinearPolynomial.from_ints(ctx, a), pa == pb],
    }
    assert got == ref["multilinear"]
    with pytest.raises(ValueError):
        pa.add(MultilinearPolynomial.from_ints(ctx, a[:4]))


def test_composed_additions_equal_tpu_zk(ref):
    ctx = arith.field_ctx("bn254_fr")
    a, b, s, _ = _ml_inputs()
    pa, pb = MultilinearPolynomial.from_ints(ctx, a), MultilinearPolynomial.from_ints(ctx, b)
    prod = ProductPolynomial.from_mles([pa, pb, pa])
    assert [limbs_to_numpy(prod.partial_evaluate(var, s).stacked).tolist() for var in (0, 2)] == ref["composed"]["partial"]
    assert prod.multiply_polynomials_element_wise().to_ints() == ref["composed"]["elementwise"]
    assert [m.to_ints() for m in prod.mles()] == ref["composed"]["mles"]
    with pytest.raises(ValueError):
        ProductPolynomial.from_mles([pa, MultilinearPolynomial.from_ints(ctx, a[:4])])


def test_arith_additions_equal_tpu_zk(ref):
    ctx = arith.field_ctx("bn254_fr")
    _, _, s, (x, y) = _ml_inputs()
    xs = ctx.array([x, y])
    got = {
        "mont_sqr": ctx.to_ints(arith.mont_sqr(ctx, xs)),
        "scalar_mul": ctx.to_ints(arith.scalar_mul(ctx, xs, ctx.scalar(s))),
        "pow": [ctx.to_ints(arith.pow_mont(ctx, xs, e)) for e in POW_EXPONENTS],
        "inv_mont": ctx.to_ints(arith.inv_mont(ctx, xs)), "inv_host": arith.inv_host(ctx, x),
        "zero": ctx.zero.tolist(), "to_limbs": ctx.to_limbs(x).tolist(),
        "from_limbs": ctx.from_limbs(ctx.to_limbs(x)), "from_mont_int": ctx.from_mont_int(x),
    }
    assert got == ref["arith"]
    assert [v * w % ctx.p for v, w in zip(got["inv_mont"], (x, y))] == [1, 1]


# -- interactive sumcheck, snapshots, apps --------------------------------------------


def test_interactive_prover_equals_tpu_zk(ref):
    """Claims and univariates under fixed challenges, the last round's
    split_at(0) [0, value] included; the port's verifier accepts each round."""
    bls = arith.field_ctx("bls12_381_fr")
    values, challenges = _interactive_inputs()
    prover = interactive.Prover(MultilinearPolynomial.from_ints(bls, values))
    verifier = interactive.Verifier(MultilinearPolynomial.from_ints(bls, values))
    rounds = [prover.prove(c) for c in [0] + challenges]
    assert rounds == [tuple(r) for r in ref["interactive"]]
    assert rounds[-1][1][0] == 0
    assert all(verifier.verify(claim, univ) for claim, univ in rounds)
    assert not verifier.verify(rounds[0][0] + 1, rounds[0][1])


def test_interactive_simulation_with_random_challenges():
    """tests/test_sumcheck.py's run (sumcheck_interactive_simulation.rs:118-169)."""
    bls = arith.field_ctx("bls12_381_fr")
    vals = [0, 0, 2, 7, 3, 3, 6, 11]
    prover = interactive.Prover(MultilinearPolynomial.from_ints(bls, vals))
    verifier = interactive.Verifier(MultilinearPolynomial.from_ints(bls, vals))
    claimed_sum, univ = prover.prove(0)
    assert claimed_sum == 32 and verifier.verify(claimed_sum, univ)
    for _ in range(3):
        claimed_sum, univ = prover.prove(verifier.generate_challenge())
        assert verifier.verify(claimed_sum, univ)
    assert verifier.oracle_check()
    verifier.current_claimed_sum += 1
    assert not verifier.oracle_check()


@pytest.mark.parametrize("n", SNAPSHOT_LENGTHS)
def test_keccak_snapshot_equals_tpu_zk(n, port, ref):
    """Byte-equal blobs (200 state bytes, then the tail), resumed in both
    directions to the same digest."""
    blob = port["keccak_snapshots"][n]
    assert blob == ref["keccak_snapshots"][n] and len(blob) == 200 + n % 136
    want = Keccak256().update(_snapshot_data(n) + b"more").digest()
    assert ref["keccak_resumed"][n] == want
    assert Keccak256.from_snapshot(ref["keccak_snapshots"][n]).update(b"more").digest() == want


def test_transcript_snapshot_equals_tpu_zk(port, ref):
    ctx = arith.field_ctx("bn254_fr")
    assert port["transcript_snapshot"] == ref["transcript_snapshot"]
    want = _transcript_for_snapshot(Transcript, ctx).random_challenge_as_field_element(ctx)
    assert ref["transcript_resumed"] == want
    assert Transcript.from_snapshot(ref["transcript_snapshot"]).random_challenge_as_field_element(ctx) == want


def test_shamir_shares_recover_across_packages(port, ref):
    """n - 1 shares from each package (the reference's loop 1..n), and each
    package recovers the other's secret."""
    fq = arith.field_ctx("bn254_fq")
    assert len(port["shares"]) == len(ref["shares"]) == 9
    assert len(port["s_shares"]) == len(ref["s_shares"]) == 7
    assert ref["port_recovered"] == [17, 17, 99]
    assert shamir.recover_secret(fq, ref["shares"]) == 17
    assert shamir.recover_secret(fq, ref["shares"][:4]) == 17
    assert shamir.s_recover_secret(fq, ref["s_shares"], password=42) == 99
    assert shamir.recover_secret(fq, ref["shares"][:3]) != 17  # below the threshold (w.h.p.)


def test_fib_evaluation_equals_tpu_zk(ref):
    fq = arith.field_ctx("bn254_fq")
    assert [fib.evaluation(fq, x) for x in range(10)] == ref["fib"]
    assert ref["fib"][7] == 21


def test_dense_breakdown_times_every_stage():
    """The dense stage timers reach every stage of prove and verify at depth
    3, and put the code back as it was."""
    before = [vars(owner)[name] for owner, name, _ in breakdown.DENSE_STAGES]
    out = breakdown.run_dense(3, device="cpu")
    assert [vars(owner)[name] for owner, name, _ in breakdown.DENSE_STAGES] == before
    prove_calls, verify_calls = out["prove_stage_calls"], out["verify_stage_calls"]
    assert prove_calls["wiring build (zeroed pair, scatter of ones)"] == verify_calls[
        "wiring build (zeroed pair, scatter of ones)"] == 3
    assert prove_calls["alpha/beta folds (K2 a point, K1, K3)"] == verify_calls["alpha/beta folds (K2 a point, K1, K3)"] == 2
    assert prove_calls["layer polynomial (tensor_add K3, tensor_mul K1, stacks)"] == 3
    assert prove_calls["round evaluations (K3, K1, int64 sums)"] == 2 + 4 + 6
    assert prove_calls["split-half evaluations (K2)"] == 2 and verify_calls["split-half evaluations (K2)"] == 1
    assert verify_calls["verify: expected layer claim, rest (wiring evaluation folds, K2)"] == 3
    for what in ("prove", "verify"):
        assert sum(out[f"{what}_stages_s"].values()) <= out[f"{what}_with_timers_s"]
    assert out["peak_mem_gib"] is None
