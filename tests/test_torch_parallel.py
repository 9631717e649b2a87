"""tpu_zk_torch.parallel held against the port's one-device functions and against tpu_zk.

Every shard runs on the CPU, in this process, with D in {1, 2, 4, 8}
shards: the sharded basic sumcheck (tables of 2^6 and 2^8, and N = 2D), the
sharded MSM (13 and 61 points, so that N is not a multiple of D), the
sharded Merkle tree (2^8 leaves), the sharded NTT (2^10, in two and in three
passes, forward and inverse), sharded FRI (a 2^8 domain, two rounds) and
sharded GKR (``tree_sum_circuit`` of depth 4, ADD and MUL, over BN254 Fr and
BLS12-381 Fr).  Each output must equal the port's one-device output
exactly, and tpu_zk's: its one-device functions on the same inputs (its own
tests hold those equal to its sharded ones), the host's sum for the MSMs,
and for GKR its proofs of depth-3 BLS12-381 Fr trees, the deepest its
compiles leave room for.  Everything is integer or byte arithmetic:
tolerance zero.

tpu_zk runs once, in :func:`reference`, in a fresh process
(``tests/jax_reference.py``) that the first test starts.  The tests against
the port's one-device functions come first and run while it computes; each
sharded output is made once (the ``_sharded_*`` helpers cache them) and the
tests against tpu_zk, last, read them again.
"""

import concurrent.futures
import functools

import numpy as np
import pytest
import torch

from tests import jax_reference
from tpu_zk_torch import device as tdevice
from tpu_zk_torch.circuit.layered import ADD, MUL, tree_sum_circuit
from tpu_zk_torch.curves.ec_device import DeviceCurve
from tpu_zk_torch.curves.msm_pippenger import msm_pippenger
from tpu_zk_torch.fields.arith import field_ctx
from tpu_zk_torch.fri import fri
from tpu_zk_torch.gkr import sparse
from tpu_zk_torch.merkle.device_merkle import merkle_field_tree
from tpu_zk_torch.ntt.ntt import NTT
from tpu_zk_torch.ntt.sixstep import SixStepPlan
from tpu_zk_torch.parallel import mesh as tmesh
from tpu_zk_torch.parallel import sharded_fri, sharded_gkr, sharded_msm, sharded_ntt, sharded_sumcheck
from tpu_zk_torch.parallel.dryrun import dryrun_multichip
from tpu_zk_torch.parallel.sharded_merkle import sharded_merkle_field_tree
from tpu_zk_torch.poly.multilinear import MultilinearPolynomial
from tpu_zk_torch.sumcheck import basic
from tpu_zk_torch.transcript.fiat_shamir import Transcript
from tpu_zk_torch.utils.serialize import gkr_proof_to_json

tdevice.set_default_device("cpu")  # these tests run the plain versions, on the CPU
torch.set_num_threads(1)  # small tensors: more threads only take cores from the other test workers

SHARDS = [1, 2, 4, 8]
SUMCHECK_LOGS = [6, 8]
MSM_SIZES = [13, 61]  # no multiple of 2, 4 or 8
MERKLE_LEAVES = 256
NTT_LOG = 10
NTT_MAX_LOGS = {"two passes": 5, "three passes": 4}  # radix 2^5 x 2^5, and 2^4 x 2^3 x 2^3
FRI_CASE = ("bn254_fr", 8, 6, 6)  # (field, domain_log2, final_size_log2, num_queries): two rounds, blowup 4
GKR_DEPTH = 4  # 16 rows a shard's layer at D = 8: every D shards a layer
GKR_CASES = {f"{field} {name}": (field, op) for field in ("bn254_fr", "bls12_381_fr")
             for name, op in (("add", ADD), ("mul", MUL))}
# tpu_zk's GKR prove compiles ~40 s of programs a field at depth 3 (more deeper): its proofs are made at
# this depth over this field only, and the port's sharded proofs held against them there
GKR_REF_DEPTH, GKR_REF_FIELD = 3, "bls12_381_fr"


def _values(p: int, n: int, seed: int) -> list[int]:
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % p for _ in range(n)]


def _sumcheck_values(n: int) -> list[int]:
    return _values(field_ctx("bn254_fr").p, n, 10 + n)


def _msm_inputs(n: int):
    """(k_i, scalars): BN254 G1 points k_i G and scalars below r."""
    rng = np.random.default_rng(20 + n)
    ks = [int(k) for k in rng.integers(1, 1 << 30, n)]
    return ks, _values(field_ctx("bn254_fr").p, n, 30 + n)


def _ntt_values() -> list[int]:
    return _values(field_ctx("bn254_fr").p, 1 << NTT_LOG, 70)


def _fri_coeffs() -> list[int]:
    """A polynomial of degree < 2^(domain - 2), padded to the domain."""
    field, dlog, _, _ = FRI_CASE
    return _values(field_ctx(field).p, 1 << (dlog - 2), 40) + [0] * ((1 << dlog) - (1 << (dlog - 2)))


def _gkr_inputs(field: str, depth: int) -> list[int]:
    return [v % 97 + 1 for v in _values(field_ctx(field).p, 1 << depth, 50 + depth)]


def _fri_tuples(proof) -> dict:
    """A FriProof of either package as plain data."""
    return {"roots": list(proof.roots), "final": list(proof.final_codeword),
            "queries": [[(q.index, q.value_lo, q.value_hi, list(q.path_lo), list(q.path_hi)) for q in rounds]
                        for rounds in proof.queries]}


def reference() -> dict:
    """Everything the tests compare against, computed by tpu_zk (in the
    child process): its compiles take nearly all the time, so the GKR
    proofs and the rest run in two threads side by side."""
    from tpu_zk.circuit.layered import ADD as JADD, MUL as JMUL, tree_sum_circuit as jtree
    from tpu_zk.curves.host_ec import HostCurve
    from tpu_zk.fields.arith import field_ctx as jfield_ctx
    from tpu_zk.fri import fri as jfri
    from tpu_zk.gkr import sparse as jsparse
    from tpu_zk.merkle.device_merkle import merkle_field_tree as jmerkle_field_tree
    from tpu_zk.ntt.ntt import NTT as JNTT
    from tpu_zk.poly.multilinear import MultilinearPolynomial as JMLE
    from tpu_zk.sumcheck import basic as jbasic
    from tpu_zk.transcript.fiat_shamir import Transcript as JTranscript
    from tpu_zk.utils.serialize import gkr_proof_to_json as jgkr_json

    def gkr():
        ctx = jfield_ctx(GKR_REF_FIELD)
        return {op: jgkr_json(jsparse.prove(jtree(ctx, GKR_REF_DEPTH, op={ADD: JADD, MUL: JMUL}[op]),
                                            _gkr_inputs(GKR_REF_FIELD, GKR_REF_DEPTH)), GKR_REF_FIELD)
                for op in (ADD, MUL)}

    def rest():
        fr = jfield_ctx("bn254_fr")
        out = {"sumcheck": {}, "msm": {}}
        for n in (1 << log for log in SUMCHECK_LOGS):
            proof = jbasic.Prover(JMLE.from_ints(fr, _sumcheck_values(n))).prove()
            out["sumcheck"][n] = (proof.initial_claimed_sum, [u.to_ints() for u in proof.round_univariate_polynomials])
        host = HostCurve("bn254")
        for n in MSM_SIZES:  # (sum k_i s_i) G on the host
            ks, scalars = _msm_inputs(n)
            out["msm"][n] = host.g1_affine(host.g1_mul(host.g1_generator(), sum(k * v for k, v in zip(ks, scalars))))
        leaves = fr.array(_values(fr.p, MERKLE_LEAVES, 60))
        out["merkle"] = [np.asarray(level).astype(np.uint8) for level in jmerkle_field_tree(fr, leaves)]
        out["ntt"] = np.asarray(JNTT("bn254_fr", NTT_LOG).forward(fr.array(_ntt_values())))
        field, dlog, final_log, queries = FRI_CASE
        cfg = jfri.FriConfig(field, dlog, final_log, queries)
        codeword = JNTT(field, dlog, cfg.root).forward(cfg.ctx.array(_fri_coeffs()))
        out["fri"] = {"codeword": np.asarray(codeword), **_fri_tuples(jfri.prove(cfg, codeword, JTranscript()))}
        return out

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        gkr_run = pool.submit(gkr)
        out = rest()
        out["gkr"] = gkr_run.result()
    return out


_POOL = concurrent.futures.ThreadPoolExecutor(1)


@pytest.fixture(scope="module")
def ref_future():
    """tpu_zk's results, computed in the child process while the tests run."""
    future = _POOL.submit(jax_reference.call, "tests.test_torch_parallel", "reference")
    yield future
    future.cancel()


@pytest.fixture(scope="module")
def ref(ref_future):
    return ref_future.result()


def _mesh(d: int) -> tmesh.Mesh:
    return tmesh.make_mesh(d, ["cpu"])


# ---------------------------------------------------------------------------
# the port's outputs, sharded over d shards (d = 0: the one-device function), each made once


@functools.cache
def _sumcheck(n: int, d: int):
    ctx = field_ctx("bn254_fr")
    poly = MultilinearPolynomial.from_ints(ctx, _sumcheck_values(n))
    proof = sharded_sumcheck.ShardedProver(poly, _mesh(d)).prove() if d else basic.Prover(poly).prove()
    return proof, (proof.initial_claimed_sum, [u.to_ints() for u in proof.round_univariate_polynomials])


@functools.cache
def _msm(n: int, d: int):
    dc = DeviceCurve("bn254", device="cpu")
    ks, scalars = _msm_inputs(n)
    points = [dc.host.g1_affine(dc.host.g1_mul(dc.host.g1_generator(), k)) for k in ks]
    if d:
        return sharded_msm.sharded_msm(dc, _mesh(d), points, scalars)
    return dc.point_to_host(msm_pippenger(dc.ctx, dc.b3, (dc.points_to_device(points), dc.fr.array(scalars, mont=False))))


@functools.cache
def _merkle(d: int) -> list[np.ndarray]:
    ctx = field_ctx("bn254_fr")
    table = ctx.array(_values(ctx.p, MERKLE_LEAVES, 60))
    levels = sharded_merkle_field_tree(ctx, table, _mesh(d)) if d else merkle_field_tree(ctx, table)
    return [level.numpy() for level in levels]


@functools.cache
def _ntt_plans(passes: str) -> tuple[SixStepPlan, SixStepPlan]:
    root = NTT("bn254_fr", NTT_LOG, device="cpu").root
    return tuple(SixStepPlan("bn254_fr", NTT_LOG, root, inverse=inverse, max_log=NTT_MAX_LOGS[passes], device="cpu")
                 for inverse in (False, True))


@functools.cache
def _ntt(passes: str, d: int) -> torch.Tensor:
    fwd, _ = _ntt_plans(passes)
    table = field_ctx("bn254_fr").array(_ntt_values())
    return sharded_ntt.sharded_sixstep(fwd, table, _mesh(d)) if d else fwd(table)


@functools.cache
def _fri_config_and_codeword():
    field, dlog, final_log, queries = FRI_CASE
    cfg = fri.FriConfig(field, dlog, final_log, queries)
    return cfg, NTT(field, dlog, root=cfg.root, device="cpu").forward(cfg.ctx.array(_fri_coeffs()))


@functools.cache
def _fri(d: int):
    """(the proof, the transcript's snapshot after it)."""
    cfg, codeword = _fri_config_and_codeword()
    transcript = Transcript()
    proof = sharded_fri.prove(cfg, codeword, transcript, _mesh(d)) if d else fri.prove(cfg, codeword, transcript)
    return proof, transcript.snapshot()


@functools.cache
def _gkr(field: str, op: int, depth: int, d: int) -> str:
    circuit = tree_sum_circuit(field_ctx(field), depth, op=op)
    inputs = _gkr_inputs(field, depth)
    proof = sharded_gkr.prove(circuit, inputs, _mesh(d)) if d else sparse.prove(circuit, inputs)
    assert sparse.verify(circuit, proof, inputs)
    return gkr_proof_to_json(proof, field)


# ---------------------------------------------------------------------------
# the mesh


def test_mesh_places_shards_round_robin(ref_future):
    mesh = tmesh.Mesh(5, ["cpu", "meta"])
    assert mesh.size == 5 and mesh.primary == torch.device("cpu")
    assert [d.type for d in mesh.devices] == ["cpu", "meta", "cpu", "meta", "cpu"]
    assert mesh.distinct == (torch.device("cpu"), torch.device("meta"))
    assert _mesh(8).distinct == (torch.device("cpu"),) and _mesh(8).size == 8


def test_make_mesh_names_no_card_by_itself():
    """With no card the default devices, and any mesh naming a card, raise:
    nothing falls back to the CPU."""
    with pytest.raises(RuntimeError):
        tmesh.make_mesh(4)
    with pytest.raises(RuntimeError):
        tmesh.make_mesh(4, ["cuda:0"])


def test_init_distributed(monkeypatch):
    """No coordinator: a no-op.  A coordinator without a world size or a
    rank raises ValueError, and the default backend, NCCL, raises where
    torch has none (tests/test_torch_distributed.py forms the groups)."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert tmesh.init_distributed() is False
    with pytest.raises(ValueError, match="rank"):
        tmesh.init_distributed("tcp://localhost:29500", 2)
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    with pytest.raises(ValueError, match="world size"):
        tmesh.init_distributed()
    if not torch.distributed.is_nccl_available():
        with pytest.raises(RuntimeError, match="NCCL"):
            tmesh.init_distributed("tcp://localhost:29500", 2, 0)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("d", SHARDS)
def test_collectives(d):
    mesh = _mesh(d)
    t = torch.arange(8 * d * 3, dtype=torch.int64).view(8 * d, 3)
    parts = tmesh.shard_leading(mesh, t)
    assert [tuple(p.shape) for p in parts] == [(8, 3)] * d
    assert torch.equal(tmesh.gather(mesh, parts), t)
    assert all(torch.equal(v, t) for v in tmesh.replicated(mesh, t).values())
    assert torch.equal(tmesh.cross_shard_sum(mesh, parts), t.view(d, 8, 3).sum(0))
    swapped = tmesh.all_to_all(mesh, parts, split_dim=0, concat_dim=1)
    for s, part in enumerate(swapped):  # shard s: block s of every shard's rows, side by side
        assert torch.equal(part, torch.cat([p[s * 8 // d : (s + 1) * 8 // d] for p in parts], dim=1))
    with pytest.raises(ValueError):  # rows that do not split evenly, or a mesh of no shard
        tmesh.shard_leading(mesh, torch.zeros(8 * d + 1)) if d > 1 else tmesh.Mesh(0, ["cpu"])


# ---------------------------------------------------------------------------
# each sharded path against the port's one-device function


@pytest.mark.parametrize("d", SHARDS)
@pytest.mark.parametrize("n", [1 << log for log in SUMCHECK_LOGS] + ["2D"])
def test_sharded_sumcheck(d, n):
    n = 2 * d if n == "2D" else n
    proof, got = _sumcheck(n, d)
    assert got == _sumcheck(n, 0)[1]
    assert basic.Verifier.init().verify(proof)


@pytest.mark.parametrize("d", SHARDS)
@pytest.mark.parametrize("n", MSM_SIZES)
def test_sharded_msm(d, n):
    assert _msm(n, d) == _msm(n, 0)


@pytest.mark.parametrize("d", SHARDS)
def test_sharded_merkle(d):
    got, one = _merkle(d), _merkle(0)
    assert len(got) == len(one) == 9
    for g, o in zip(got, one):
        np.testing.assert_array_equal(g, o)


@pytest.mark.parametrize("d", SHARDS)
@pytest.mark.parametrize("passes", NTT_MAX_LOGS)
def test_sharded_ntt(d, passes):
    fwd, inv = _ntt_plans(passes)
    assert len(fwd.ms) == {"two passes": 2, "three passes": 3}[passes]
    mesh = _mesh(d)
    assert sharded_ntt.ShardedSixStep(fwd, mesh).shardable
    got = _ntt(passes, d)
    assert torch.equal(got, _ntt(passes, 0))
    back = sharded_ntt.sharded_sixstep(inv, got, mesh)
    assert torch.equal(back, inv(got)) and torch.equal(back, field_ctx("bn254_fr").array(_ntt_values()))


def test_sharded_ntt_too_small_to_shard_runs_the_plan():
    ctx = field_ctx("bn254_fr")
    plan = SixStepPlan("bn254_fr", 6, NTT("bn254_fr", 6, device="cpu").root, device="cpu")  # one pass of 2^6
    table = ctx.array(_values(ctx.p, 64, 71))
    sharded = sharded_ntt.ShardedSixStep(plan, _mesh(4))
    assert not sharded.shardable and torch.equal(sharded(table), plan(table))


@pytest.mark.parametrize("d", SHARDS)
def test_sharded_fri(d):
    (got, snapshot), (one, one_snapshot) = _fri(d), _fri(0)
    assert got == one
    assert snapshot == one_snapshot  # the transcript goes on where the one-device prove's does
    assert fri.verify(_fri_config_and_codeword()[0], got, Transcript())


@pytest.mark.parametrize("d", SHARDS)
@pytest.mark.parametrize("case", GKR_CASES)
def test_sharded_gkr(d, case):
    field, op = GKR_CASES[case]
    assert _gkr(field, op, GKR_DEPTH, d) == _gkr(field, op, GKR_DEPTH, 0)


def test_dryrun_multichip_on_eight_cpu_shards():
    dryrun_multichip(8, ["cpu"])


# ---------------------------------------------------------------------------
# the same outputs against tpu_zk's


@pytest.mark.parametrize("n", [1 << log for log in SUMCHECK_LOGS])
def test_sumcheck_matches_tpu_zk(n, ref):
    assert all(_sumcheck(n, d)[1] == ref["sumcheck"][n] for d in [0] + SHARDS)


@pytest.mark.parametrize("n", MSM_SIZES)
def test_msm_matches_tpu_zk(n, ref):
    assert all(_msm(n, d) == ref["msm"][n] for d in [0] + SHARDS)


def test_merkle_matches_tpu_zk(ref):
    for d in [0] + SHARDS:
        assert len(_merkle(d)) == len(ref["merkle"])
        for got, want in zip(_merkle(d), ref["merkle"]):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("passes", NTT_MAX_LOGS)
def test_ntt_matches_tpu_zk(passes, ref):
    for d in [0] + SHARDS:
        np.testing.assert_array_equal(_ntt(passes, d).numpy().view(np.uint32), ref["ntt"])


def test_fri_matches_tpu_zk(ref):
    np.testing.assert_array_equal(_fri_config_and_codeword()[1].numpy().view(np.uint32), ref["fri"]["codeword"])
    want = {k: v for k, v in ref["fri"].items() if k != "codeword"}
    assert all(_fri_tuples(_fri(d)[0]) == want for d in [0] + SHARDS)


@pytest.mark.parametrize("op", [ADD, MUL], ids=["add", "mul"])
def test_gkr_matches_tpu_zk(op, ref):
    assert all(_gkr(GKR_REF_FIELD, op, GKR_REF_DEPTH, d) == ref["gkr"][op] for d in [0] + SHARDS)
