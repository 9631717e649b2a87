"""tpu_zk_torch's counters, roofline models and checkpoints held against tpu_zk.

Field-operation counts are checked against the reference's field-tracker
formula for the basic sumcheck (as ``tests/test_utils.py`` does for
``tpu_zk``), the roofline models against counts made by hand, and the
checkpoints of both provers by resuming: a proof paused, saved, loaded and
finished must be bit-identical to one made in a single call, and a blob
written by either package must load in the other and finish to the same
proof JSON (exact, tolerance zero).  Inputs come from
``numpy.random.default_rng``.

Every compiled tpu_zk computation runs once, in :func:`reference`, which
the module fixture calls in a fresh process (``tests/jax_reference.py``).
"""

import io
import json
import pickle

import numpy as np
import pytest
import torch

from tests import jax_reference
from tpu_zk.circuit import layered as jlayered
from tpu_zk.fields import arith as jarith
from tpu_zk_torch import device as tdevice
from tpu_zk_torch.fields import arith
from tpu_zk_torch.gkr import sparse
from tpu_zk_torch.poly.multilinear import MultilinearPolynomial
from tpu_zk_torch.sumcheck import basic
from tpu_zk_torch.utils import counters, roofline, serialize
from tpu_zk_torch.utils.checkpoint import CheckpointableSparseGkrProver, CheckpointableSumcheckProver
from tpu_zk_torch.utils.convert import circuit_from_arrays

tdevice.set_default_device("cpu")  # these tests run the plain versions, on the CPU
torch.set_num_threads(1)  # small tensors: more threads only take cores from the other test workers

SUMCHECK_FIELD, SUMCHECK_LOG_N = "bn254_fr", 6
SUMCHECK_PAUSES = [0, 3, 5]  # rounds run before the save
GKR_FIELD, GKR_DEPTH = "bls12_381_fr", 2  # tpu_zk's checkpoint prover compiles its fused programs: ~20 s a layer on the CPU
GKR_PAUSES = [1]  # layers proved before the save
PAUSE_ROUNDS, PAUSE_LAYERS = 3, 1  # where the blobs that cross between the packages are saved


def _values(name: str, n: int, seed: int) -> list[int]:
    p = jarith.field_ctx(name).p
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % p for _ in range(n)]


def _sumcheck_values():
    return _values(SUMCHECK_FIELD, 1 << SUMCHECK_LOG_N, 11)


def _gkr_case():
    """(tpu_zk circuit, inputs): an ADD tree of GKR_DEPTH layers."""
    ctx = jarith.field_ctx(GKR_FIELD)
    return jlayered.tree_sum_circuit(ctx, GKR_DEPTH, op=jlayered.ADD), _values(GKR_FIELD, 1 << GKR_DEPTH, 12)


def _port_circuit():
    jc, inputs = _gkr_case()
    return circuit_from_arrays(arith.field_ctx(GKR_FIELD), jc.layers), inputs


def reference(port_sumcheck_blob: bytes, port_gkr_blob: bytes) -> dict:
    """tpu_zk's side (in the child process): its uninterrupted proofs, its
    blobs saved mid-proof, and the proofs it finishes from the port's blobs."""
    from tpu_zk.gkr import sparse as jsparse
    from tpu_zk.poly.multilinear import MultilinearPolynomial as JMLE
    from tpu_zk.sumcheck import basic as jbasic
    from tpu_zk.utils import checkpoint as jcheckpoint
    from tpu_zk.utils import serialize as jser

    ctx = jarith.field_ctx(SUMCHECK_FIELD)
    vals = _sumcheck_values()
    prover = jcheckpoint.CheckpointableSumcheckProver(JMLE.from_ints(ctx, vals))
    prover.run(max_rounds=PAUSE_ROUNDS)
    out = {
        "sumcheck_json": jser.sumcheck_proof_to_json(jbasic.Prover(JMLE.from_ints(ctx, vals)).prove(fused=False)),
        "sumcheck_blob": prover.save(),
        "sumcheck_from_port": jser.sumcheck_proof_to_json(
            jcheckpoint.CheckpointableSumcheckProver.load(port_sumcheck_blob).run()),
    }
    circuit, inputs = _gkr_case()
    gkr = jcheckpoint.CheckpointableSparseGkrProver(circuit, inputs)
    gkr.run(max_layers=PAUSE_LAYERS)
    out["gkr_json"] = jser.gkr_proof_to_json(jsparse.prove(circuit, inputs, fused=False), GKR_FIELD)
    out["gkr_blob"] = gkr.save()
    out["gkr_from_port"] = jser.gkr_proof_to_json(
        jcheckpoint.CheckpointableSparseGkrProver.load(circuit, port_gkr_blob).run(), GKR_FIELD)
    return out


def _port_sumcheck_blob(rounds: int) -> bytes:
    ctx = arith.field_ctx(SUMCHECK_FIELD)
    prover = CheckpointableSumcheckProver(MultilinearPolynomial.from_ints(ctx, _sumcheck_values()))
    assert (prover.run(max_rounds=rounds) is None) == (rounds < SUMCHECK_LOG_N)
    return prover.save()


def _port_gkr_blob(layers: int) -> bytes:
    circuit, inputs = _port_circuit()
    prover = CheckpointableSparseGkrProver(circuit, inputs)
    assert prover.run(max_layers=layers) is None
    return prover.save()


@pytest.fixture(scope="module")
def ref():
    return jax_reference.call("tests.test_torch_utils", "reference", _port_sumcheck_blob(PAUSE_ROUNDS),
                              _port_gkr_blob(PAUSE_LAYERS))


# -- counters ------------------------------------------------------------------


def test_counters_bump_mul():
    ctx = arith.field_ctx("bn254_fq")
    a = ctx.array([1, 2, 3, 4])
    counters.enable(True)
    counters.reset()
    try:
        arith.mont_mul(ctx, a, a)
        s = counters.summary()
    finally:
        counters.enable(False)
    assert s == {"bn254_fq": {"mul": 4}}


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("n", [6, 8])
def test_counters_match_field_tracker_basic_sumcheck(n, fused):
    """The reference's field-tracker counts for the basic sumcheck prover
    over a 2^n table (``sumcheck_protocol/src/basic_sumcheck/protocol.rs:42-55``,
    ``prover.rs:35-89``): mul 2^n - 1 and sub 2^n - 1 (the lerps of n
    halving folds), add 2^(n+2) - 2n - 4 (the initial sum, every round's half
    sums, the lerps' adds).  The port counts every vectorized operation at
    the elements it touches, when it runs (N = 2^n):

    * sub: -1.  The last round folds nothing (the reference folds its
      2-entry table anyway); K2 counts its N/2 + ... + 2 = N - 2 subs.
    * mul: +N + 2n.  K2's N - 2 lerp products (-1, as sub), plus N for
      ``from_mont`` of the whole table (its transcript bytes; the reference
      has no Montgomery form), 1 for the claimed sum's scaling by R^2, 2 for
      the first univariate's, 2(n - 1) for the later rounds' half sums
      (each a reduction of K2's block sums scaled by R^2).  ``fused=True``
      adds 2n more: each round's univariate leaves Montgomery form on the
      device (K1) before its bytes are packed, where the host loop converts
      on the host.
    * add: -N + 2n + 2.  N for the claimed sum and N for the first round's
      half sums (one vectorized sum each, counted at its N elements), and
      K2's N - 2 lerp adds; the later rounds' half sums come out of K2's
      block sums, which the port does not count as adds.
    """
    ctx = arith.field_ctx("bn254_fr")
    N = 1 << n
    poly = MultilinearPolynomial.from_ints(ctx, [(i * 7 + 3) % 97 for i in range(N)])
    counters.enable(True)
    counters.reset()
    try:
        basic.Prover(poly).prove(fused=fused)
        s = counters.summary()["bn254_fr"]
    finally:
        counters.enable(False)
    ref_mul, ref_sub, ref_add = N - 1, N - 1, 4 * N - 2 * n - 4
    assert s["sub"] == ref_sub - 1, s
    assert s["mul"] == ref_mul + N + 2 * n + (2 * n if fused else 0), s
    assert s["add"] == ref_add - N + 2 * n + 2, s


def test_counters_disabled_count_nothing():
    counters.reset()
    ctx = arith.field_ctx("bn254_fr")
    basic.Prover.init(ctx, list(range(8))).prove(fused=False)
    assert counters.summary() == {}


# -- roofline ------------------------------------------------------------------

HAND_COUNTS = {
    # one 2^4 round: 16 elements read, 8 written, 64 bytes each; 8 products of 2 * 8^2 wide multiply-adds
    "sumcheck round": (roofline.sumcheck_round_model(4), 24 * 64, 8 * 128, 0),
    # a 2^4 forward in passes of radix 2^2, 2^2: butterflies 4 * (2 * 2 - 3) a pass, pre-twiddles 16 once;
    # bytes 2 * 16 * 64 a pass, 16 * 64 of pre-twiddles, the 16-entry int64 index
    "ntt": (roofline.ntt_model(4, radix_log2=2), 2 * 2048 + 1024 + 128, (2 * 4 + 16) * 128, 0),
    # 2^4 points, c = 4, 16-bit scalars: 5 windows of 16 bucket adds and 2 * 8 running-sum adds, 12 products each
    "msm": (roofline.msm_model(4, c=4, scalar_bits=16), 16 * 4 * 64, 5 * 32 * 12 * 128, 0),
    # one FRI round at 2^3: 15 hashes of 4,320 ops, 4 fold products; bytes 8 + 4 elements, 15 digests
    "fri": (roofline.fri_model(3, 1), 12 * 64 + 15 * 32, 4 * 128, 15 * 4320),
    # depth 1: one layer of s = 1, two phases of one round at T = 2: 5 T products, 6 T elements each
    "gkr": (roofline.gkr_layer_model(1), 2 * 12 * 64, 2 * 10 * 128, 0),
}


@pytest.mark.parametrize("name", HAND_COUNTS)
def test_roofline_models_match_hand_counts(name):
    model, n_bytes, wide_mads, logic_ops = HAND_COUNTS[name]
    assert (model.bytes_moved, model.wide_mads, model.logic_ops) == (n_bytes, wide_mads, logic_ops)
    row = model.row(1e-3)
    assert row["t_roofline_ms"] == pytest.approx(max(row["t_memory_ms"], row["t_compute_ms"]))
    assert "| " + model.name + " |" in roofline.render_markdown([row])


def test_sponge_counts_and_bound():
    """K7's work by hand: from fill level 100, 64 bytes (one block at 136),
    a squeeze (its clone; the digest to 60), 96 bytes (one block at 136, to
    20), a squeeze (its clone; to 52): 4 permutations; one step's bound is
    its permutations' chains of 24 rounds of 6 dependent instructions, each
    at the probed latency."""
    assert roofline.sponge_permutations(100, [(64, False), (0, True), (96, True)]) == (4, 52)
    assert roofline.sponge_permutations(0, [(300, False)]) == (2, 28)
    assert roofline.PERMUTATION_DEPTH == 144
    assert roofline.sponge_step_bound_ms(2, 96, 2e-9) == (2 * 144 * 2e-9 * 1e3, "operations")
    assert roofline.sponge_step_bound_ms(0, 3_350_000, 2e-9)[1] == "bytes"


def test_bound_helpers():
    """chip_smoke.py's bounds: bytes at 3.35 TB/s, products in the cheaper of
    the probed wide and 32-bit multiply-adds."""
    fr = arith.field_ctx("bn254_fr")
    assert roofline.mont_mul_wide_mads(fr) == 128 and roofline.mont_mul_wide_mads(24) == 288
    rates = (1e12, 4e12)
    assert roofline.ops_ms(1e9, rates) == {"wide": 1.0, "32-bit": 0.5}
    assert roofline.bound_ms(3.35e9, 1e9, rates) == (1.0, "bytes")
    assert roofline.bound_ms(3.35e8, 1e9, rates) == (0.5, "operations")


# -- checkpoints ---------------------------------------------------------------


@pytest.mark.parametrize("rounds", SUMCHECK_PAUSES)
def test_sumcheck_checkpoint_resume_bit_identical(rounds):
    ctx = arith.field_ctx(SUMCHECK_FIELD)
    want = serialize.sumcheck_proof_to_json(basic.Prover.init(ctx, _sumcheck_values()).prove())
    proof = CheckpointableSumcheckProver.load(_port_sumcheck_blob(rounds)).run()
    assert serialize.sumcheck_proof_to_json(proof) == want
    assert basic.Verifier.init().verify(proof)


@pytest.mark.parametrize("layers", GKR_PAUSES)
def test_sparse_gkr_checkpoint_resume_bit_identical(layers):
    circuit, inputs = _port_circuit()
    want = serialize.gkr_proof_to_json(sparse.prove(circuit, inputs), GKR_FIELD)
    proof = CheckpointableSparseGkrProver.load(circuit, _port_gkr_blob(layers)).run()
    assert serialize.gkr_proof_to_json(proof, GKR_FIELD) == want
    assert sparse.verify(circuit, proof, inputs)


def test_sumcheck_checkpoints_cross_packages(ref):
    """A tpu_zk blob finishes in the port to tpu_zk's proof; the port's blob
    finishes in tpu_zk to the port's proof."""
    ctx = arith.field_ctx(SUMCHECK_FIELD)
    assert serialize.sumcheck_proof_to_json(CheckpointableSumcheckProver.load(ref["sumcheck_blob"]).run()) \
        == ref["sumcheck_json"]
    assert ref["sumcheck_from_port"] == serialize.sumcheck_proof_to_json(
        basic.Prover.init(ctx, _sumcheck_values()).prove()) == ref["sumcheck_json"]


def test_sparse_gkr_checkpoints_cross_packages(ref):
    circuit, inputs = _port_circuit()
    assert serialize.gkr_proof_to_json(CheckpointableSparseGkrProver.load(circuit, ref["gkr_blob"]).run(),
                                       GKR_FIELD) == ref["gkr_json"]
    assert ref["gkr_from_port"] == serialize.gkr_proof_to_json(sparse.prove(circuit, inputs), GKR_FIELD) \
        == ref["gkr_json"]


def _with_version(blob: bytes, version: int) -> bytes:
    with np.load(io.BytesIO(blob), allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(arrays.pop("__meta__").tobytes().decode())
    meta["format_version"] = version
    buf = io.BytesIO()
    np.savez(buf, __meta__=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8), **arrays)
    return buf.getvalue()


@pytest.mark.parametrize("kind", ["version 3", "pickle"])
def test_checkpoint_refuses_unknown_blobs(kind):
    sumcheck_blob, gkr_blob = _port_sumcheck_blob(2), _port_gkr_blob(1)
    if kind == "version 3":
        sumcheck_blob, gkr_blob = _with_version(sumcheck_blob, 3), _with_version(gkr_blob, 3)
    else:
        sumcheck_blob = gkr_blob = pickle.dumps({"round": 2, "transcript": b"\x00" * 200})
    with pytest.raises(ValueError):
        CheckpointableSumcheckProver.load(sumcheck_blob)
    with pytest.raises(ValueError):
        CheckpointableSparseGkrProver.load(_port_circuit()[0], gkr_blob)
