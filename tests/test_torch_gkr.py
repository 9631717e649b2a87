"""tpu_zk_torch's circuits, GKR sumcheck and linear-time GKR held against tpu_zk.

The same circuits and inputs (inputs from ``numpy.random.default_rng``) go
through ``tpu_zk.gkr.sparse.prove`` and the port's ``gkr.sparse.prove``;
the proof JSON must be equal byte for byte, and each package must accept
the other's proof and reject a tampered one.  On the CPU the port runs its
kernels' plain versions; everything is integer arithmetic, so every
comparison is exact (tolerance zero).

Every compiled tpu_zk computation runs once, in :func:`reference`, which
the module fixture calls in a fresh process (``tests/jax_reference.py``);
the tests here compare the port against its results.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import jax_reference
from tpu_zk.circuit import layered as jlayered
from tpu_zk.fields import arith as jarith
from tpu_zk.gkr import sparse as jsparse
from tpu_zk.poly import univariate as juni
from tpu_zk.poly.composed import SumPolynomial as JSumPolynomial
from tpu_zk.sumcheck import gkr_sumcheck as jgkr_sumcheck
from tpu_zk.transcript.fiat_shamir import Transcript as JTranscript
from tpu_zk.utils import serialize as jser
from tpu_zk_torch import device as tdevice
from tpu_zk_torch.circuit import layered
from tpu_zk_torch.circuit.layered import ADD, MUL, tree_sum_circuit
from tpu_zk_torch.fields import arith, kernels
from tpu_zk_torch.gkr import breakdown, sparse
from tpu_zk_torch.poly import univariate
from tpu_zk_torch.poly.composed import ProductPolynomial, SumPolynomial, collapse_sum_of_products
from tpu_zk_torch.poly.multilinear import MultilinearPolynomial
from tpu_zk_torch.sumcheck import gkr_sumcheck
from tpu_zk_torch.transcript.fiat_shamir import Transcript
from tpu_zk_torch.utils import serialize
from tpu_zk_torch.utils.convert import circuit_from_arrays, limbs_from_numpy, limbs_to_numpy

tdevice.set_default_device("cpu")  # these tests run the plain versions, on the CPU
torch.set_num_threads(1)  # small tensors: more threads only take cores from the other test workers

JG = jlayered.Gate
CASES = [
    "bls12_381_fr mixed 2 layers",
    "bn254_fr add tree depth 4",
    "bn254_fr mul tree depth 3",
]
K3_FIELDS = ["bn254_fr", "bls12_381_fq"]


def _rand(p, n, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % p for _ in range(n)]


def _case(name):
    """(field, tpu_zk circuit, inputs) of one named circuit."""
    if name == "bls12_381_fr mixed 2 layers":  # tests/test_fused_sparse.py's first circuit
        ctx = jarith.field_ctx("bls12_381_fr")
        layers = [jlayered.Layer([JG.mul(0, 1, 0)]), jlayered.Layer([JG.add(0, 1, 0), JG.mul(2, 3, 1)])]
        return ctx, jlayered.Circuit(ctx, layers), _rand(ctx.p, 4, 1)
    ctx = jarith.field_ctx("bn254_fr")
    if name == "bn254_fr add tree depth 4":
        return ctx, jlayered.tree_sum_circuit(ctx, 4, op=jlayered.ADD), _rand(ctx.p, 16, 3)
    if name == "bn254_fr mul tree depth 3":  # reuses the depth-4 tree's compiled table sizes
        return ctx, jlayered.tree_sum_circuit(ctx, 3, op=jlayered.MUL), _rand(ctx.p, 8, 4)
    raise KeyError(name)


def _same(proof):
    return proof


def _tamper_claim(proof):
    proof.sumcheck_proofs[0].claimed_sum += 1
    return proof


def _tamper_round(proof):
    u = proof.sumcheck_proofs[-1].round_univariate_polynomials[0]
    u.coefficients[1] = (u.coefficients[1] + 1) % u.ctx.p
    return proof


def _k3_operands(name):
    """Random canonical pairs plus every pair of edge values, as numpy limbs."""
    ctx = arith.field_ctx(name)
    e = [0, 1, ctx.p - 1, ctx.R % ctx.p]
    xs = _rand(ctx.p, 240, 7) + [x for x in e for _ in e]
    ys = _rand(ctx.p, 240, 8) + [y for _ in e for y in e]
    return limbs_to_numpy(ctx.array(xs, mont=False)), limbs_to_numpy(ctx.array(ys, mont=False))


def _working_set(n, seed):
    """A random BN254 Fr [2, 2, n, L] Montgomery working set, as numpy limbs."""
    ctx = arith.field_ctx("bn254_fr")
    return limbs_to_numpy(ctx.array(_rand(ctx.p, 4 * n, seed))).reshape(2, 2, n, ctx.L)


def reference(port_jsons: dict) -> dict:
    """Everything the tests compare against, computed by tpu_zk (in the
    child process): per circuit its proof JSON, its verdicts on the port's
    proof (as is, tampered claim, tampered round) and its layer tables; the
    add/sub/neg and addsub_pallas results; an unfused gkr_sumcheck run; a
    collapse_sum_of_products."""
    from tpu_zk.fields.pallas_kernels import addsub_pallas
    from tpu_zk.poly.composed import collapse_sum_of_products as j_collapse

    out = {"cases": {}, "k3": {}}
    for name in CASES:
        jctx, jc, inputs = _case(name)
        proof = jsparse.prove(jc, inputs, fused=False)
        port = port_jsons[name]
        out["cases"][name] = {
            "json": jser.gkr_proof_to_json(proof, jctx.name),
            "verifies_own": jsparse.verify(jc, proof, inputs),
            "port_verdicts": [
                jsparse.verify(jc, change(jser.gkr_proof_from_json(port)), inputs)
                for change in (_same, _tamper_claim, _tamper_round)
            ],
            "tables": [np.asarray(t) for t in jc.evaluate(inputs, materialize=False).layer_tables],
        }
    for name in K3_FIELDS:
        jctx = jarith.field_ctx(name)
        ja, jb = (jnp.asarray(x) for x in _k3_operands(name))
        res = {"neg": np.asarray(jarith.neg(jctx, ja))}
        for kind, fn in (("add", jarith.add), ("sub", jarith.sub)):
            res[kind] = np.asarray(fn(jctx, ja, jb))
            res[kind + " broadcast"] = np.asarray(fn(jctx, ja, jb[5]))
            if name == "bn254_fr":
                res[kind + " addsub_pallas"] = np.asarray(addsub_pallas(jctx, ja, jb, kind, 128))
        out["k3"][name] = res

    jctx = jarith.field_ctx("bn254_fr")
    poly = JSumPolynomial(jctx, jnp.asarray(_working_set(16, 10)))
    evals = jgkr_sumcheck.generate_round_univariate(poly)
    claim = (evals[0] + evals[1]) % jctx.p
    runs = {}
    for absorb in (True, False):
        transcript = JTranscript()
        proof = jgkr_sumcheck.prove(poly, claim, transcript, fused=False, absorb_claim=absorb)
        runs[absorb] = {
            "coefficients": [u.coefficients for u in proof.round_univariate_polynomials],
            "challenges": proof.random_challenges,
            "next_challenge": transcript.sample_random_challenge(),
            "last_claimed_sum": jgkr_sumcheck.verify(proof, JTranscript(), jctx).last_claimed_sum,
        }
    out["gkr_sumcheck"] = {"evals": evals, "runs": runs}
    out["collapse"] = np.asarray(j_collapse(jctx, jnp.asarray(_working_set(8, 11))))
    return out


@pytest.fixture(scope="module")
def port_cases():
    """name -> (port circuit, inputs, port proof JSON)."""
    out = {}
    for name in CASES:
        jctx, jcircuit, inputs = _case(name)
        circuit = circuit_from_arrays(arith.field_ctx(jctx.name), jcircuit.layers)
        out[name] = circuit, inputs, serialize.gkr_proof_to_json(sparse.prove(circuit, inputs), jctx.name)
    return out


@pytest.fixture(scope="module")
def ref(port_cases):
    return jax_reference.call("tests.test_torch_gkr", "reference", {n: c[2] for n, c in port_cases.items()})


@pytest.mark.parametrize("name", CASES)
def test_proof_json_equals_tpu_zk(name, port_cases, ref):
    assert ref["cases"][name]["verifies_own"]
    assert port_cases[name][2] == ref["cases"][name]["json"]


@pytest.mark.parametrize("name", CASES)
def test_port_proof_verifies_in_tpu_zk(name, ref):
    """tpu_zk accepts the port's proof and rejects it tampered."""
    assert ref["cases"][name]["port_verdicts"] == [True, False, False]


@pytest.mark.parametrize("name", CASES)
def test_tpu_zk_proof_verifies_in_port(name, port_cases, ref):
    c, inputs, _ = port_cases[name]
    ref_json = ref["cases"][name]["json"]
    assert sparse.verify(c, serialize.gkr_proof_from_json(ref_json), inputs)
    assert not sparse.verify(c, _tamper_claim(serialize.gkr_proof_from_json(ref_json)), inputs)
    assert not sparse.verify(c, _tamper_round(serialize.gkr_proof_from_json(ref_json)), inputs)
    bad = list(inputs)
    bad[-1] += 1
    assert not sparse.verify(c, serialize.gkr_proof_from_json(ref_json), bad)


@pytest.mark.parametrize("name", CASES)
def test_circuit_evaluate_matches_tpu_zk(name, port_cases, ref):
    c, inputs, _ = port_cases[name]
    got = c.evaluate(inputs)
    want = ref["cases"][name]["tables"]
    assert len(got.layer_tables) == len(want)
    for r, g in zip(want, got.layer_tables):
        assert np.array_equal(r, limbs_to_numpy(g))
    assert got.output == c.ctx.to_ints(limbs_from_numpy(want[0]))


def test_circuit_structure_matches_tpu_zk():
    """Gate-built layers, their arrays, the packed wiring positions and the
    layer variable counts, against tpu_zk's (host only)."""
    ctx, jctx = arith.field_ctx("bls12_381_fr"), jarith.field_ctx("bls12_381_fr")
    G = layered.Gate
    layers = [
        [G.add(0, 1, 0)],
        [G.mul(0, 1, 0), G.add(2, 3, 1)],
        [G.add(0, 1, 0), G.add(2, 3, 1), G.mul(4, 5, 2), G.add(6, 7, 3), G.mul(1, 6, 3)],
    ]
    port = layered.Circuit(ctx, [layered.Layer(gs) for gs in layers])
    ref = jlayered.Circuit(jctx, [jlayered.Layer([JG(g.left_index, g.right_index, g.output_index, g.operator)
                                                  for g in gs]) for gs in layers])
    for i, (pl_, rl) in enumerate(zip(port.layers, ref.layers)):
        for name in ("lefts", "rights", "outs", "ops"):
            assert np.array_equal(getattr(pl_, name), getattr(rl, name))
        assert pl_.width == rl.width
        for got, want in zip(port.gate_positions(i), ref.gate_positions(i)):
            assert np.array_equal(got, want)
        assert layered.num_of_layer_variables(i) == jlayered.num_of_layer_variables(i)
    # the last layer's shared output slot 3 accumulates two gates
    tables = port.evaluate([3, 5, 7, 11, 13, 17, 19, 23]).layer_tables
    assert [t.shape[0] for t in tables] == [1, 2, 4, 8]
    assert ctx.to_ints(tables[2]) == [8, 18, 13 * 17, 19 + 23 + 5 * 19]
    with pytest.raises(ValueError):
        layered.Layer.from_arrays([0, 1], [1], [0, 0], [ADD, ADD])


# -- port-only cases -----------------------------------------------------------


def test_one_gate_circuit_pads_w0():
    """A single gate: the output layer has one value, padded to a
    one-variable MLE before it is absorbed (protocol.py:40-44)."""
    ctx = arith.field_ctx("bn254_fr")
    circuit = tree_sum_circuit(ctx, 1, op=MUL)
    proof = sparse.prove(circuit, [6, 7])
    assert proof.circuit_output == [42]
    assert proof.wb_evaluations == [] and len(proof.sumcheck_proofs) == 1
    assert sparse.verify(circuit, proof, [6, 7])
    assert not sparse.verify(circuit, proof, [6, 8])


def test_verify_rejects_proofs_of_the_wrong_shape():
    ctx = arith.field_ctx("bn254_fr")
    circuit = tree_sum_circuit(ctx, 3, op=ADD)
    inputs = _rand(ctx.p, 8, 5)
    proof = sparse.prove(circuit, inputs)
    assert sparse.verify(circuit, proof, inputs)
    short = serialize.gkr_proof_from_json(serialize.gkr_proof_to_json(proof, ctx.name))
    short.sumcheck_proofs[1].round_univariate_polynomials.pop()
    assert not sparse.verify(circuit, short, inputs)
    fewer = serialize.gkr_proof_from_json(serialize.gkr_proof_to_json(proof, ctx.name))
    fewer.sumcheck_proofs.pop()
    assert not sparse.verify(circuit, fewer, inputs)
    tampered = serialize.gkr_proof_from_json(serialize.gkr_proof_to_json(proof, ctx.name))
    tampered.wb_evaluations[0] += 1
    assert not sparse.verify(circuit, tampered, inputs)


def test_device_inputs_give_the_same_proof():
    """Inputs as a Montgomery tensor (the form at scale) prove and verify
    exactly as host ints do."""
    ctx = arith.field_ctx("bn254_fr")
    circuit = tree_sum_circuit(ctx, 3, op=ADD)
    inputs = _rand(ctx.p, 8, 6)
    table = ctx.array(inputs)
    want = serialize.gkr_proof_to_json(sparse.prove(circuit, inputs), ctx.name)
    proof = sparse.prove(circuit, table)
    assert serialize.gkr_proof_to_json(proof, ctx.name) == want
    assert sparse.verify(circuit, proof, table)


@pytest.mark.parametrize("name", K3_FIELDS)
def test_k3_plain_matches_tpu_zk(name, ref):
    """K3's plain versions (the CPU route of arith.add/sub/neg) against
    tpu_zk's add/sub/neg, with a broadcast b, and against addsub_pallas."""
    ctx = arith.field_ctx(name)
    want = ref["k3"][name]
    ta, tb = (limbs_from_numpy(x) for x in _k3_operands(name))
    for kind, plain in (("add", kernels.add_plain), ("sub", kernels.sub_plain)):
        assert np.array_equal(want[kind], limbs_to_numpy(plain(ctx, ta, tb)))
        assert np.array_equal(want[kind], limbs_to_numpy(kernels.addsub(ctx, ta, tb, kind)))
        assert np.array_equal(want[kind + " broadcast"], limbs_to_numpy(kernels.addsub(ctx, ta, tb[5], kind)))
        if name == "bn254_fr":
            assert np.array_equal(want[kind + " addsub_pallas"], want[kind])
    assert np.array_equal(want["neg"], limbs_to_numpy(arith.neg(ctx, ta)))
    with pytest.raises(ValueError):
        kernels.addsub(ctx, ta, tb, "mul")


def test_univariate_matches_tpu_zk():
    ctx, jctx = arith.field_ctx("bls12_381_fq"), jarith.field_ctx("bls12_381_fq")
    ys = _rand(ctx.p, 4, 9)
    xs = [0, 1, 2, ctx.p - 1]
    port = univariate.DenseUnivariatePolynomial.lagrange_interpolate(ctx, xs, ys)
    ref = juni.DenseUnivariatePolynomial.lagrange_interpolate(jctx, xs, ys)
    assert port.coefficients == ref.coefficients
    assert [port.evaluate(x) for x in xs] == ys
    assert port.to_bytes_le() == ref.to_bytes_le() and len(port.to_bytes_le()) == 4 * 48
    assert port.to_bytes_be() == ref.to_bytes_be()
    assert ctx.to_bytes_le(ys[0]) == jctx.to_bytes_le(ys[0])


def test_gkr_sumcheck_matches_tpu_zk(ref):
    """The port's round evaluations, proof and transcript against tpu_zk's
    unfused gkr_sumcheck on the same working set (a continuation with
    absorb_claim=False included); each verifier's final claim agrees."""
    ctx = arith.field_ctx("bn254_fr")
    want = ref["gkr_sumcheck"]
    poly = SumPolynomial(ctx, limbs_from_numpy(_working_set(16, 10)))
    evals = gkr_sumcheck.generate_round_univariate(poly)
    assert evals == want["evals"]
    claim = (evals[0] + evals[1]) % ctx.p
    for absorb in (True, False):
        transcript = Transcript()
        proof = gkr_sumcheck.prove(poly, claim, transcript, absorb_claim=absorb)
        run = want["runs"][absorb]
        assert proof.random_challenges == run["challenges"]
        assert [u.coefficients for u in proof.round_univariate_polynomials] == run["coefficients"]
        assert transcript.sample_random_challenge() == run["next_challenge"]
        result = gkr_sumcheck.verify(proof, Transcript(), ctx)
        assert result.last_claimed_sum == run["last_claimed_sum"]
        if absorb:
            assert result.is_proof_valid
            assert result.last_claimed_sum == poly.evaluate(proof.random_challenges)
            proof.round_univariate_polynomials[1].coefficients[0] += 1
            assert not gkr_sumcheck.verify(proof, Transcript(), ctx).is_proof_valid


def test_composed_matches_tpu_zk(ref):
    ctx = arith.field_ctx("bn254_fr")
    t = limbs_from_numpy(_working_set(8, 11))
    collapsed = collapse_sum_of_products(ctx, t)
    assert np.array_equal(ref["collapse"], limbs_to_numpy(collapsed))
    poly = SumPolynomial.from_products([ProductPolynomial(ctx, t[0]), ProductPolynomial(ctx, t[1])])
    assert poly.add_polynomials_element_wise().table.equal(collapsed)
    # the sum of products at a point, by hand from the factors' own evaluations
    point = _rand(ctx.p, 3, 12)
    by_hand = sum(
        MultilinearPolynomial(ctx, t[i, 0]).evaluate(point) * MultilinearPolynomial(ctx, t[i, 1]).evaluate(point)
        for i in range(2)
    ) % ctx.p
    assert poly.evaluate(point) == by_hand
    assert poly.partial_evaluate(0, point[0]).evaluate(point[1:]) == by_hand
    assert poly.convert_to_bytes() == b"".join(
        MultilinearPolynomial(ctx, t[i, j]).convert_to_bytes() for i in range(2) for j in range(2)
    )


def test_breakdown_times_every_stage():
    """The stage timers reach every stage of a host-synced prove (2 rounds
    per variable pair, 3 segment sums per layer) and put the prover back as
    it was."""
    before = [vars(owner)[name] for owner, name, _ in breakdown.STAGES]
    depth = 3
    out = breakdown.run(depth, device="cpu", fused=False)
    assert [vars(owner)[name] for owner, name, _ in breakdown.STAGES] == before
    assert set(out["stage_calls"]) == {stage for _, _, stage in breakdown.STAGES}
    rounds = 2 * sum(range(1, depth + 1))
    for stage in ("round evaluations (K3, K1, int64 sums)", "host interpolation", "folds (K2)"):
        assert out["stage_calls"][stage] == rounds
    assert out["stage_calls"]["segment sums (int64 index_add_, carry, redc_wide, K1 R^2)"] == 3 * depth
    assert [size for size, _ in out["layer_s_by_table_size"]] == [2, 4, 8]
    assert sum(out["stages_s"].values()) <= out["prove_with_timers_s"]
    assert out["device_idle_share"] is None


def test_fused_breakdown_times_every_stage():
    """The same for the fused prover (the default): a K7 sponge step and a
    device interpolation a round, one fused phase a variable set."""
    before = [vars(owner)[name] for owner, name, _ in breakdown.FUSED_STAGES]
    depth = 2
    out = breakdown.run(depth, device="cpu")
    assert [vars(owner)[name] for owner, name, _ in breakdown.FUSED_STAGES] == before
    assert set(out["stage_calls"]) == {stage for _, _, stage in breakdown.FUSED_STAGES}
    rounds = 2 * sum(range(1, depth + 1))
    for stage in ("round evaluations (K3, K1, int64 sums)", "device interpolation (K1, K3)", "device sponge (K7)",
                  "folds (K2)"):
        assert out["stage_calls"][stage] == rounds
    assert out["stage_calls"][breakdown.FUSED_STAGES[-1][2]] == 2 * depth
    assert sum(out["stages_s"].values()) <= out["prove_with_timers_s"]
