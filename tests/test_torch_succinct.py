"""tpu_zk_torch's succinct GKR (GKR + multilinear-KZG inputs) held against tpu_zk.

The reference's own two-layer circuit, inputs and taus go through
``tpu_zk.gkr.sparse.prove_succinct`` and ``tpu_zk.gkr.fused_sparse.prove_succinct``
and through the port's ``gkr.sparse.prove_succinct``; the succinct proof JSON
must be equal byte for byte, and each package must accept the other's proof
and reject a tampered one.  So does a depth-3 ADD tree (three variables,
random inputs and taus), through ``sparse.prove_succinct`` only: every MSM
shape costs tpu_zk's CPU backend about half a minute of processor time to
compile, and the fused prover compiles its own.
BN254 goes through the same code in ``test_succinct_breakdown_times_every_stage``.  On the CPU
the port runs its kernels' plain versions; everything is integer arithmetic,
so every comparison is exact (tolerance zero).

Every compiled tpu_zk computation runs once, in :func:`reference`, which the
module fixture calls in a fresh process (``tests/jax_reference.py``).
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from tests import jax_reference
from tpu_zk.circuit import layered as jlayered
from tpu_zk.fields import arith as jarith
from tpu_zk_torch import device as tdevice
from tpu_zk_torch.circuit.layered import ADD, tree_sum_circuit
from tpu_zk_torch.curves import params
from tpu_zk_torch.fields import arith
from tpu_zk_torch.gkr import breakdown, sparse
from tpu_zk_torch.kzg.trusted_setup import TrustedSetup
from tpu_zk_torch.utils import serialize
from tpu_zk_torch.utils.convert import circuit_from_arrays

tdevice.set_default_device("cpu")  # these tests run the plain versions, on the CPU
torch.set_num_threads(1)  # small tensors: more threads only take cores from the other test workers

JG = jlayered.Gate
CASES = ["bls12_381 mixed 2 layers", "bls12_381 add tree depth 3"]
FUSED_CASES = CASES[:1]  # the cases that also go through tpu_zk's fused prover


def _case(name):
    """(curve, tpu_zk circuit, inputs, taus) of one named case."""
    if name == "bls12_381 mixed 2 layers":  # tests/test_succinct_gkr.py:16-21 (succinct_gkr_protocol.rs:302-324)
        ctx = jarith.field_ctx("bls12_381_fr")
        layers = [jlayered.Layer([JG.mul(0, 1, 0)]), jlayered.Layer([JG.add(0, 1, 0), JG.mul(2, 3, 1)])]
        return "bls12_381", jlayered.Circuit(ctx, layers), [2, 3, 4, 5], [5, 2]
    if name == "bls12_381 add tree depth 3":
        ctx = jarith.field_ctx("bls12_381_fr")
        rng = np.random.default_rng(31)
        inputs = [int.from_bytes(rng.bytes(32), "little") % ctx.p for _ in range(8)]
        taus = [int.from_bytes(rng.bytes(32), "little") % ctx.p for _ in range(3)]
        return "bls12_381", jlayered.tree_sum_circuit(ctx, 3, op=jlayered.ADD), inputs, taus
    raise KeyError(name)


def _same(proof):
    return proof


def _tamper_claim(proof):
    proof.sumcheck_proofs[0].claimed_sum += 1
    return proof


def _tamper_wb(proof):
    proof.wb_evaluations[0] += 1
    return proof


def _tamper_kzg_point(proof):
    proof.input_rc_proof.proofs[0] = params.CURVES["bls12_381"]["g1"]  # a point of the group, not the quotient's commitment
    return proof


def _tamper_kzg_evaluation(proof):
    proof.input_rb_proof.evaluation += 1
    return proof


TAMPERS = (_tamper_claim, _tamper_wb, _tamper_kzg_point, _tamper_kzg_evaluation)


def reference(port_jsons: dict) -> dict:
    """Per case, computed by tpu_zk (in the child process): the succinct
    proof JSON of ``sparse.prove_succinct`` and, for FUSED_CASES, of
    ``fused_sparse.prove_succinct``, whether tpu_zk verifies its own proof,
    and its verdicts on the port's proof (as is, then each tampering)."""
    from tpu_zk.gkr import fused_sparse as jfused
    from tpu_zk.gkr import sparse as jsparse
    from tpu_zk.kzg.trusted_setup import TrustedSetup as JTrustedSetup
    from tpu_zk.utils import serialize as jser

    out = {}
    for name in CASES:
        curve, jc, inputs, taus = _case(name)
        setup = JTrustedSetup.initialize_setup(curve, taus)
        proof = jsparse.prove_succinct(jc, inputs, setup, fused=False)
        field = jc.ctx.name
        out[name] = {
            "json": jser.succinct_proof_to_json(proof, field),
            "fused_json": (jser.succinct_proof_to_json(jfused.prove_succinct(jc, inputs, setup), field)
                           if name in FUSED_CASES else None),
            "verifies_own": jsparse.verify_succinct(jc, proof, setup),
            "port_verdicts": [
                jsparse.verify_succinct(jc, change(jser.succinct_proof_from_json(port_jsons[name])), setup)
                for change in (_same,) + TAMPERS
            ],
        }
    return out


@pytest.fixture(scope="module")
def port_cases():
    """name -> (port circuit, inputs, port setup, port proof JSON)."""
    out = {}
    for name in CASES:
        curve, jcircuit, inputs, taus = _case(name)
        field = jcircuit.ctx.name
        circuit = circuit_from_arrays(arith.field_ctx(field), jcircuit.layers)
        setup = TrustedSetup.initialize_setup(curve, taus)
        proof = sparse.prove_succinct(circuit, inputs, setup)
        out[name] = circuit, inputs, setup, serialize.succinct_proof_to_json(proof, field)
    return out


@pytest.fixture(scope="module")
def ref(port_cases):
    return jax_reference.call("tests.test_torch_succinct", "reference", {n: port_cases[n][3] for n in CASES},
                              timeout=900)


@pytest.mark.parametrize("name", CASES)
def test_succinct_proof_json_equals_tpu_zk(name, port_cases, ref):
    """Byte for byte: sumchecks, wb/wc, commitment, both openings."""
    assert ref[name]["verifies_own"]
    assert port_cases[name][3] == ref[name]["json"]


@pytest.mark.parametrize("name", FUSED_CASES)
def test_succinct_proof_json_equals_tpu_zk_fused(name, port_cases, ref):
    assert port_cases[name][3] == ref[name]["fused_json"]


@pytest.mark.parametrize("name", FUSED_CASES)
def test_succinct_host_synced_proof_json_equals_tpu_zk(name, port_cases, ref):
    """The port's fused=False prover: the same bytes as its default (fused)
    one, which the tests above hold to tpu_zk's."""
    circuit, inputs, setup, _ = port_cases[name]
    proof = sparse.prove_succinct(circuit, inputs, setup, fused=False)
    assert serialize.succinct_proof_to_json(proof, circuit.ctx.name) == ref[name]["json"]


@pytest.mark.parametrize("name", CASES)
def test_port_succinct_proof_verifies_in_tpu_zk(name, ref):
    """tpu_zk accepts the port's proof and rejects it with a tampered
    claimed sum, wb evaluation, KZG point or KZG evaluation."""
    assert ref[name]["port_verdicts"] == [True, False, False, False, False]


@pytest.mark.parametrize("name", CASES)
def test_tpu_zk_succinct_proof_verifies_in_port(name, port_cases, ref):
    circuit, _, setup, _ = port_cases[name]
    ref_json = ref[name]["json"]
    assert sparse.verify_succinct(circuit, serialize.succinct_proof_from_json(ref_json), setup)
    for change in TAMPERS:
        assert not sparse.verify_succinct(circuit, change(serialize.succinct_proof_from_json(ref_json)), setup)


@pytest.mark.parametrize("name", CASES)
def test_port_verifies_its_own_succinct_proof(name, port_cases):
    """Every case, the depth-3 tree included: the port's proof verifies from
    its JSON and is rejected with a tampered claimed sum, wb evaluation, KZG
    point or KZG evaluation."""
    circuit, _, setup, port_json = port_cases[name]
    assert sparse.verify_succinct(circuit, serialize.succinct_proof_from_json(port_json), setup)
    for change in TAMPERS:
        assert not sparse.verify_succinct(circuit, change(serialize.succinct_proof_from_json(port_json)), setup)


@pytest.mark.parametrize("name", CASES)
def test_succinct_json_round_trip(name, port_cases):
    circuit, _, setup, port_json = port_cases[name]
    field = circuit.ctx.name
    assert serialize.succinct_proof_to_json(serialize.succinct_proof_from_json(port_json), field) == port_json
    with pytest.raises(ValueError):
        serialize.succinct_proof_from_json(port_json.replace('"succinct_gkr"', '"gkr"'))
    with pytest.raises(ValueError):
        serialize.gkr_proof_from_json(port_json)


def test_succinct_verify_rejects_proofs_of_the_wrong_shape(port_cases):
    circuit, _, setup, port_json = port_cases["bls12_381 add tree depth 3"]
    fresh = lambda: serialize.succinct_proof_from_json(port_json)
    assert sparse.verify_succinct(circuit, fresh(), setup)
    short = fresh()
    short.sumcheck_proofs[1].round_univariate_polynomials.pop()
    assert not sparse.verify_succinct(circuit, short, setup)
    fewer = fresh()
    fewer.sumcheck_proofs.pop()
    assert not sparse.verify_succinct(circuit, fewer, setup)
    no_wc = fresh()
    no_wc.wc_evaluations.pop()
    assert not sparse.verify_succinct(circuit, no_wc, setup)
    few_points = fresh()
    few_points.input_rb_proof.proofs.pop()
    assert not sparse.verify_succinct(circuit, few_points, setup)
    # a setup for another number of variables does not fit the circuit's inputs
    other = TrustedSetup.initialize_setup("bls12_381", [3, 4])
    assert not sparse.verify_succinct(circuit, fresh(), other)


def test_succinct_last_layer_follows_the_reference(port_cases):
    """rb and rc of the last layer are the opening points; wb and wc are
    recorded for every layer but the last (succinct_gkr_protocol.rs:119-126),
    and the openings' evaluations are the inputs' MLE at those points."""
    circuit, inputs, setup, port_json = port_cases["bls12_381 add tree depth 3"]
    proof = serialize.succinct_proof_from_json(port_json)
    n_layers = len(circuit.layers)
    assert len(proof.wb_evaluations) == len(proof.wc_evaluations) == n_layers - 1
    challenges = proof.sumcheck_proofs[-1].random_challenges
    from tpu_zk_torch.poly.multilinear import MultilinearPolynomial

    poly = MultilinearPolynomial.from_ints(circuit.ctx, inputs)
    assert proof.input_rb_proof.evaluation == poly.evaluate(challenges[:3])
    assert proof.input_rc_proof.evaluation == poly.evaluate(challenges[3:])
    assert len(proof.input_rb_proof.proofs) == len(proof.input_rc_proof.proofs) == 3
    # the plain proof of the same circuit shares every layer's sumcheck
    plain = sparse.prove(circuit, inputs)
    assert serialize.gkr_proof_to_json(plain, circuit.ctx.name) == serialize.gkr_proof_to_json(proof, circuit.ctx.name)


def test_succinct_device_inputs_give_the_same_proof(port_cases):
    """Inputs as a Montgomery tensor (the form at scale) prove exactly as
    host ints do."""
    circuit, inputs, setup, port_json = port_cases["bls12_381 mixed 2 layers"]
    proof = sparse.prove_succinct(circuit, circuit.ctx.array(inputs), setup)
    assert serialize.succinct_proof_to_json(proof, circuit.ctx.name) == port_json


def test_succinct_breakdown_times_every_stage():
    """The succinct stage timers reach setup, commit, both opens, K4's plain
    versions and the verifier's stages over BN254, and put the code back as
    it was."""
    before = [vars(owner)[name] for owner, name, _ in breakdown.SUCCINCT_STAGES]
    depth = 2
    out = breakdown.run_succinct(depth, device="cpu")
    assert [vars(owner)[name] for owner, name, _ in breakdown.SUCCINCT_STAGES] == before
    assert set(out["setup_stage_calls"]) == {s for _, _, s in breakdown.SUCCINCT_STAGES if s.startswith("setup:")}
    calls = out["prove_stage_calls"]
    assert calls["commit, rest (from_mont)"] == 1 and calls["open, rest (evaluate, quotients, folds)"] == 2
    # the commit on 4 points and each open's 2-point and 1-point MSMs: every stage of the bucket method,
    # K4a at least once for the buckets and once for the window sums
    assert (calls["msm: signed digits"] == calls["msm: sort into buckets"] == calls["msm: K4b segment reduce"]
            == calls["msm: window sums, rest"] == calls["msm: window combine (host ints)"] == 5)
    assert calls["msm: K4a unit sums"] == calls["msm: unit tables"] >= 10
    assert calls["msm: result to affine host ints"] == 5
    assert out["verify_stage_calls"]["verify: native pairing product"] == 2
    assert out["verify_stage_calls"]["verify: layers"] == 1
    for what in ("setup", "prove", "verify"):
        assert sum(out[f"{what}_stages_s"].values()) <= out[f"{what}_with_timers_s"]
    # commit, the two opens, the layers and the evaluation are timed apart, each with what it calls
    whole = out["prove_whole_s"]
    assert set(whole) == {"commit", "open", "prove: layers", "circuit evaluation"}
    assert sum(whole.values()) <= out["prove_with_timers_s"]
    assert whole["commit"] > out["prove_stages_s"]["commit, rest (from_mont)"]
    assert out["peak_mem_gib"] is None


def test_port_imports_no_jax():
    """No module of the port, and not chip_smoke.py, imports jax or tpu_zk:
    by their import statements, and by importing every one of them with jax
    made unimportable."""
    import re

    root = jax_reference.ROOT
    files = sorted((root / "tpu_zk_torch").rglob("*.py")) + [root / "chip_smoke.py"]
    assert len(files) > 30
    pattern = re.compile(r"^\s*(?:from|import)\s+(?:jax|tpu_zk)\b", re.M)
    assert [str(f) for f in files if pattern.search(f.read_text())] == []
    modules = [".".join(f.relative_to(root).with_suffix("").parts) for f in files if f.name != "__init__.py"]
    code = (
        "import importlib, sys; sys.modules['jax'] = None\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not [m for m in sys.modules if m == 'tpu_zk' or m.startswith('tpu_zk.')], 'imported tpu_zk'\n"
    )
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, cwd=str(root))
    assert done.returncode == 0, done.stderr
