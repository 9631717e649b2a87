"""tpu_zk_torch's Keccak rows (K5), Merkle trees and FRI held against tpu_zk.

The same numpy-made bytes, field elements and low-degree polynomials go
through both packages: K5's plain version against ``keccak256_batch`` (host)
and ``keccak_fixed_batch`` (on the CPU the XLA lane path
``keccak_f1600_lanes``, the function of the TPU kernel
``_hash_block_T_pallas``, which the JAX suite never runs in interpret mode);
``merkle_field_tree`` levels and ``MerkleTree`` roots and paths; and whole
``FriProof``s (roots, final codeword, every query's index, values and
paths) for a BN254 Fr domain of 2^8 and a BLS12-381 Fr domain of 2^6
(four and two rounds, final size 2^4).  Each package verifies the
other's proof and rejects it tampered.  On the CPU the port runs its
kernels' plain versions; everything is integer or byte arithmetic, so every
comparison is exact (tolerance zero).

Every compiled tpu_zk computation runs once, in :func:`reference`, which
the module fixture calls in a fresh process (``tests/jax_reference.py``).
Each FRI round size compiles its own tpu_zk round program, about three
seconds each on the CPU: hence one domain per field, and few rounds.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from tests import jax_reference
from tpu_zk.fields import arith as jarith
from tpu_zk.fri import fri as jfri
from tpu_zk.merkle import merkle as jmerkle
from tpu_zk.transcript import keccak as jkeccak
from tpu_zk_torch import device as tdevice
from tpu_zk_torch.fields import arith
from tpu_zk_torch.fri import fri
from tpu_zk_torch.merkle import device_merkle, kernels, merkle
from tpu_zk_torch.ntt.ntt import NTT
from tpu_zk_torch.transcript import keccak
from tpu_zk_torch.transcript.fiat_shamir import Transcript
from tpu_zk_torch.utils.convert import limbs_to_numpy

tdevice.set_default_device("cpu")  # these tests run the plain versions, on the CPU
torch.set_num_threads(1)  # small tensors: more threads only take cores from the other test workers

WIDTHS = [0, 1, 32, 64, 134, 135]
ROWS = 9
TREE_LEAVES = 64
# (field, domain_log2, final_size_log2, num_queries); blowup 4 throughout
FRI_CASES = {"bn254_fr 2^8": ("bn254_fr", 8, 4, 10), "bls12_381_fr 2^6": ("bls12_381_fr", 6, 4, 8)}
TAMPERS = ["none", "final codeword", "query value", "merkle sibling"]


def _rows(w: int) -> np.ndarray:
    return np.random.default_rng(100 + w).integers(0, 256, size=(ROWS, w), dtype=np.uint8)


def _field_values(p: int, n: int, seed: int) -> list[int]:
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % p for _ in range(n)]


def _codeword_coeffs(case: str) -> list[int]:
    """A random polynomial of degree < 2^(domain - 2), padded to the domain."""
    field, dlog, _, _ = FRI_CASES[case]
    p = jarith.field_ctx(field).p
    return _field_values(p, 1 << (dlog - 2), dlog) + [0] * ((1 << dlog) - (1 << (dlog - 2)))


def _tamper(proof, how: str):
    """A copy of the proof (either package's classes) with one field changed."""
    import copy

    proof = copy.deepcopy(proof)
    if how == "final codeword":
        proof.final_codeword[0] += 1
    elif how == "query value":
        proof.queries[0][0].value_lo += 1
    elif how == "merkle sibling":
        path = proof.queries[0][1].path_hi
        path[2] = bytes([path[2][0] ^ 1]) + path[2][1:]
    return proof


def _as_tuples(proof) -> dict:
    """A FriProof of either package as plain data."""
    return {"roots": list(proof.roots), "final": list(proof.final_codeword),
            "queries": [[(q.index, q.value_lo, q.value_hi, list(q.path_lo), list(q.path_hi)) for q in rounds]
                        for rounds in proof.queries]}


def _from_tuples(data: dict, module):
    return module.FriProof(roots=list(data["roots"]), final_codeword=list(data["final"]),
                           queries=[[module.FriQueryRound(*q) for q in rounds] for rounds in data["queries"]])


def reference(port_proofs: dict) -> dict:
    """Everything the tests compare against, computed by tpu_zk (in the
    child process): Keccak digests of the rows, a field-leaf tree's levels,
    a byte-leaf tree's root and paths, per FRI case the codeword, the proof
    and the verdicts on the port's proof as is and tampered."""
    import jax.numpy as jnp

    from tpu_zk.merkle.device_merkle import field_leaf_bytes, keccak_fixed_batch, merkle_field_tree
    from tpu_zk.ntt.ntt import NTT as JNTT
    from tpu_zk.transcript.fiat_shamir import Transcript as JTranscript

    out = {"batch": {}, "fixed": {}}
    for w in WIDTHS:
        out["batch"][w] = jkeccak.keccak256_batch(_rows(w))
        out["fixed"][w] = np.asarray(keccak_fixed_batch(jnp.asarray(_rows(w), jnp.uint32))).astype(np.uint8)
    ctx = jarith.field_ctx("bn254_fr")
    table = ctx.array(_field_values(ctx.p, TREE_LEAVES, 5))
    out["field_tree"] = [np.asarray(level).astype(np.uint8) for level in merkle_field_tree(ctx, table)]
    out["field_leaves"] = np.asarray(field_leaf_bytes(ctx, table)).astype(np.uint8)
    tree = jmerkle.MerkleTree(_rows(32)[:8])
    out["byte_tree"] = {"root": tree.root, "paths": [tree.open(i) for i in range(8)]}

    out["fri"] = {}
    for case, (field, dlog, final_log, queries) in FRI_CASES.items():
        cfg = jfri.FriConfig(field, dlog, final_log, queries)
        jctx = cfg.ctx
        codeword = JNTT(field, dlog, cfg.root).forward(jctx.array(_codeword_coeffs(case)))
        proof = jfri.prove(cfg, codeword, JTranscript())
        out["fri"][case] = {
            "codeword": np.asarray(codeword),
            "proof": _as_tuples(proof),
            "verifies_own": jfri.verify(cfg, proof, JTranscript()),
            "port_verdicts": [jfri.verify(cfg, _tamper(_from_tuples(port_proofs[case], jfri), how), JTranscript())
                              for how in TAMPERS],
        }
    return out


@pytest.fixture(scope="module")
def port_fri():
    """case -> (config, codeword, proof) made by the port."""
    out = {}
    for case, (field, dlog, final_log, queries) in FRI_CASES.items():
        cfg = fri.FriConfig(field, dlog, final_log, queries)
        codeword = NTT(field, dlog, root=cfg.root).forward(cfg.ctx.array(_codeword_coeffs(case)))
        out[case] = cfg, codeword, fri.prove(cfg, codeword, Transcript())
    return out


@pytest.fixture(scope="module")
def ref(port_fri):
    return jax_reference.call("tests.test_torch_merkle_fri", "reference",
                              {case: _as_tuples(proof) for case, (_, _, proof) in port_fri.items()})


@pytest.mark.parametrize("w", WIDTHS)
def test_keccak_rows_plain_matches_keccak256_batch(w, ref):
    got = kernels.keccak_rows(torch.from_numpy(_rows(w))).numpy()
    np.testing.assert_array_equal(got, ref["batch"][w])
    np.testing.assert_array_equal(keccak.keccak256_batch(_rows(w)), ref["batch"][w])


@pytest.mark.parametrize("w", WIDTHS)
def test_keccak_rows_plain_matches_keccak_fixed_batch(w, ref):
    got = device_merkle.keccak_fixed_batch(torch.from_numpy(_rows(w))).numpy()
    np.testing.assert_array_equal(got, ref["fixed"][w])


def test_keccak_rows_writes_into_out_and_rejects_bad_rows():
    rows = torch.from_numpy(_rows(64))
    buf = torch.zeros((ROWS + 2, 32), dtype=torch.uint8)
    kernels.keccak_rows(rows, out=buf[1 : ROWS + 1])
    np.testing.assert_array_equal(buf[1 : ROWS + 1].numpy(), keccak.keccak256_batch(_rows(64)))
    assert not buf[0].any() and not buf[-1].any()
    for bad in (torch.zeros((2, 136), dtype=torch.uint8), torch.zeros((2, 8), dtype=torch.int32),
                torch.zeros((4, 8), dtype=torch.uint8)[:, ::2]):
        with pytest.raises(ValueError):
            kernels.keccak_rows(bad)


def test_merkle_field_tree_matches_tpu_zk(ref):
    ctx = arith.field_ctx("bn254_fr")
    vals = _field_values(ctx.p, TREE_LEAVES, 5)
    np.testing.assert_array_equal(device_merkle.field_leaf_bytes(ctx, ctx.array(vals)).numpy(), ref["field_leaves"])
    levels = device_merkle.merkle_field_tree(ctx, vals)  # host ints, placed on the (CPU) default device
    assert len(levels) == len(ref["field_tree"]) == 7
    for got, want in zip(levels, ref["field_tree"]):
        np.testing.assert_array_equal(got.numpy(), want)
    host = merkle.MerkleTree(ref["field_leaves"])
    for got, want in zip(host.levels, ref["field_tree"]):
        np.testing.assert_array_equal(got, want)


def test_merkle_tree_matches_tpu_zk(ref):
    tree = merkle.MerkleTree(_rows(32)[:8])
    assert tree.root == ref["byte_tree"]["root"]
    assert tree.num_leaves == 8
    for i in range(8):
        path = tree.open(i)
        assert path == ref["byte_tree"]["paths"][i]
        assert merkle.verify_path(tree.root, _rows(32)[i].tobytes(), i, path)
        assert jmerkle.verify_path(tree.root, _rows(32)[i].tobytes(), i, path)
    assert not merkle.verify_path(tree.root, b"\x00" * 32, 0, tree.open(1))
    assert not merkle.verify_path(tree.root, _rows(32)[0].tobytes(), 1, tree.open(0))


def test_merkle_levels_native_matches_numpy():
    leaves = _rows(64)[:8]
    flat = keccak.merkle_levels(leaves)
    assert flat.shape == (15, 32)
    want = [keccak.keccak256_plain(row.tobytes()) for row in leaves]
    assert [row.tobytes() for row in flat[:8]] == want
    assert flat[8].tobytes() == keccak.keccak256_plain(want[0] + want[1])


@pytest.mark.parametrize("case", list(FRI_CASES))
def test_codeword_matches_tpu_zk(case, port_fri, ref):
    np.testing.assert_array_equal(limbs_to_numpy(port_fri[case][1]), ref["fri"][case]["codeword"])


@pytest.mark.parametrize("case", list(FRI_CASES))
def test_fri_proof_equals_tpu_zk(case, port_fri, ref):
    want = ref["fri"][case]
    assert want["verifies_own"]
    got = _as_tuples(port_fri[case][2])
    assert got["roots"] == want["proof"]["roots"]
    assert got["final"] == want["proof"]["final"]
    assert got["queries"] == want["proof"]["queries"]


@pytest.mark.parametrize("case", list(FRI_CASES))
def test_port_fri_proof_verifies_in_tpu_zk(case, ref):
    """tpu_zk accepts the port's proof and rejects each tampered copy."""
    assert ref["fri"][case]["port_verdicts"] == [True, False, False, False]


@pytest.mark.parametrize("how", TAMPERS)
@pytest.mark.parametrize("case", list(FRI_CASES))
def test_tpu_zk_fri_proof_verifies_in_port(case, how, port_fri, ref):
    cfg = port_fri[case][0]
    proof = _tamper(_from_tuples(ref["fri"][case]["proof"], fri), how)
    assert fri.verify(cfg, proof, Transcript()) == (how == "none")


@pytest.mark.parametrize("how", TAMPERS[1:])
def test_port_rejects_its_own_tampered_proof(how, port_fri):
    cfg, _, proof = port_fri["bn254_fr 2^8"]
    assert fri.verify(cfg, proof, Transcript())
    assert not fri.verify(cfg, _tamper(proof, how), Transcript())


def test_fri_rejects_high_degree():
    """Random evaluations (degree far above the bound) fail, as in tests/test_merkle_fri.py."""
    cfg = fri.FriConfig("bn254_fr", 8, 2, 20)
    vals = [(i * 7919 + 31) % cfg.ctx.p for i in range(1 << 8)]
    proof = fri.prove(cfg, vals, Transcript())  # host ints, placed on the (CPU) default device
    assert not fri.verify(cfg, proof, Transcript())


def test_fri_rejects_wrong_shapes(port_fri):
    cfg, _, proof = port_fri["bn254_fr 2^8"]
    short = _tamper(proof, "none")
    short.roots = short.roots[:-1]
    assert not fri.verify(cfg, short, Transcript())
    fewer = _tamper(proof, "none")
    fewer.queries = fewer.queries[:-1]
    assert not fri.verify(cfg, fewer, Transcript())


def test_fold_codeword_matches_host_ints():
    """One fold against the formula on host ints."""
    cfg = fri.FriConfig("bn254_fr", 5, 2, 4)
    ctx, p = cfg.ctx, cfg.ctx.p
    vals = _field_values(p, 32, 9)
    beta = 0xBEEF % p
    inv_x, inv2 = cfg.fold_tables("cpu")
    got = ctx.to_ints(fri.fold_codeword(ctx, ctx.array(vals), ctx.scalar(beta), inv_x, inv2))
    w, h = cfg.root, pow(2, p - 2, p)
    want = [((vals[i] + vals[i + 16]) * h + beta * (vals[i] - vals[i + 16]) * h * pow(w, -i, p)) % p
            for i in range(16)]
    assert got == want


def test_new_entry_points_default_to_the_card():
    """With the default device left alone, the NTT, Merkle and FRI entry
    points put host values on ``cuda``: on a machine without a card that
    raises."""
    code = (
        "import torch\n"
        "from tpu_zk_torch.fields.arith import field_ctx\n"
        "from tpu_zk_torch.fri import fri\n"
        "from tpu_zk_torch.merkle.device_merkle import merkle_field_tree\n"
        "from tpu_zk_torch.ntt.ntt import NTT, polynomial_multiply\n"
        "from tpu_zk_torch.transcript.fiat_shamir import Transcript\n"
        "ctx = field_ctx('bn254_fr')\n"
        "calls = [lambda: polynomial_multiply('bn254_fr', [1, 2], [3, 4]), lambda: NTT('bn254_fr', 2).forward_ints([1] * 4),\n"
        "         lambda: merkle_field_tree(ctx, [1, 2]), lambda: fri.prove(fri.FriConfig('bn254_fr', 3), [1] * 8, Transcript())]\n"
        "if not torch.cuda.is_available():\n"
        "    for call in calls:\n"
        "        try:\n"
        "            call()\n"
        "        except (RuntimeError, AssertionError) as e:\n"
        "            assert 'cuda' in str(e).lower() or 'nvidia' in str(e).lower(), e\n"
        "        else:\n"
        "            raise AssertionError('computed without a card')\n"
    )
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                          cwd=str(jax_reference.ROOT))
    assert done.returncode == 0, done.stderr


def test_fri_stage_timers_cover_every_stage():
    """chip_smoke.py's stage timers of the NTT -> FRI path name functions
    that the path calls: each stage is timed at least once."""
    import chip_smoke
    from tpu_zk_torch.gkr import breakdown

    cfg = fri.FriConfig("bn254_fr", 6, 2, 4)
    coeffs = cfg.ctx.array(_field_values(cfg.ctx.p, 16, 6) + [0] * 48)

    def path():
        return fri.verify(cfg, fri.prove(cfg, NTT("bn254_fr", 6).forward(coeffs), Transcript()), Transcript())

    ok, stages, calls, each = breakdown.staged(path, "cpu", chip_smoke.fri_stages())
    assert ok
    names = [stage for _, _, stage in chip_smoke.fri_stages()]
    assert sorted(calls) == sorted(names)
    assert calls["Merkle levels (K5)"] == calls["fold (K1, K3)"] == cfg.num_rounds
    assert len(each["Merkle levels (K5)"]) == cfg.num_rounds  # the tree of each round, timed apart
    assert all(seconds >= 0 for seconds in stages.values())
