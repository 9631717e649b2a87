"""tpu_zk_torch's device sponge and fused provers held against tpu_zk.

The same inputs (from ``numpy.random.default_rng``) go through
``tpu_zk.transcript.device_fs`` and ``tpu_zk.sumcheck.fused`` and through
the port's counterparts: sponge states, buffers, fill levels, digests,
Montgomery challenges, round polynomials and proof JSON must be equal
exactly (integers and bytes, tolerance zero).  On the CPU the port runs
K7's plain version (``transcript/kernels.py``); the fused provers' default
(``fused=True``) and the host-synced loop (``fused=False``) must give the
same bytes.

Every compiled tpu_zk computation runs once, in :func:`reference`, which the
module fixture calls in a fresh process (``tests/jax_reference.py``).
"""

import numpy as np
import pytest
import torch

from tests import jax_reference
from tpu_zk.circuit import layered as jlayered
from tpu_zk.fields import arith as jarith
from tpu_zk.sumcheck import fused as jfused
from tpu_zk_torch import device as tdevice
from tpu_zk_torch.fields import arith
from tpu_zk_torch.gkr import fused_sparse, sparse
from tpu_zk_torch.kzg.trusted_setup import TrustedSetup
from tpu_zk_torch.poly.composed import SumPolynomial
from tpu_zk_torch.poly.multilinear import MultilinearPolynomial
from tpu_zk_torch.sumcheck import basic, fused, gkr_sumcheck
from tpu_zk_torch.transcript import device_fs
from tpu_zk_torch.transcript.fiat_shamir import Transcript
from tpu_zk_torch.transcript.keccak import RATE, Keccak256
from tpu_zk_torch.transcript.kernels import sponge_round, sponge_round_plain, sponge_step, sponge_step_plain
from tpu_zk_torch.utils import counters, serialize
from tpu_zk_torch.utils.convert import circuit_from_arrays, limbs_from_numpy, limbs_to_numpy

tdevice.set_default_device("cpu")  # these tests run the plain versions, on the CPU
torch.set_num_threads(1)  # small tensors: more threads only take cores from the other test workers

SPONGE_KS = [0, 1, 32, 64, 104, 135, 136, 137, 300]  # bytes absorbed before a squeeze, at every pos 0..135
STATIC_POS = [0, 135]  # fill levels also run through tpu_zk's static-pos DeviceSponge (eager: ~3 s a case)
BASIC_CASES = [("bn254_fr", 6), ("bn254_fr", 8), ("bls12_381_fr", 6), ("bls12_381_fr", 8)]
GKR_DEGREES = [2, 3]
GKR_ROWS = 8  # entries of each factor table of the GKR working sets: three rounds
MIXED_DEPTH = 4


def _lanes_from_pairs(pairs: np.ndarray) -> np.ndarray:
    """tpu_zk's [25, 2] uint32 (lo, hi) state -> the port's [25] int64 lane bits."""
    p = pairs.astype(np.uint64)
    return (p[:, 0] | (p[:, 1] << np.uint64(32))).view(np.int64)


def _sponge_input(k: int, pos: int):
    """A random sponge (state pairs, tail with zeros from pos on) and k data bytes."""
    rng = np.random.default_rng(1000 * k + pos)
    pairs = rng.integers(0, 1 << 32, size=(25, 2), dtype=np.uint64).astype(np.uint32)
    buf = np.zeros(RATE, np.uint8)
    buf[:pos] = rng.integers(0, 256, size=pos, dtype=np.uint8)
    return pairs, buf, rng.integers(0, 256, size=k, dtype=np.uint8)


def _table(name: str, log_n: int):
    ctx = jarith.field_ctx(name)
    rng = np.random.default_rng(log_n * 7 + len(name))
    return [int.from_bytes(rng.bytes(32), "little") % ctx.p for _ in range(1 << log_n)]


def _working_set(degree: int):
    """A random BN254 Fr [2, degree, GKR_ROWS, L] Montgomery working set (uint32 limbs)."""
    ctx = jarith.field_ctx("bn254_fr")
    rng = np.random.default_rng(40 + degree)
    vals = [int.from_bytes(rng.bytes(32), "little") % ctx.p for _ in range(2 * degree * GKR_ROWS)]
    return limbs_to_numpy(arith.field_ctx("bn254_fr").array(vals, device="cpu")).reshape(2, degree, GKR_ROWS, ctx.L)


def _host_seeded(hasher, degree: int):
    """A host transcript (a fresh ``hasher``) that has absorbed 30 + degree bytes."""
    hasher.update(b"\x05" * (30 + degree))
    return hasher


def _mixed_circuit():
    """A random BN254 Fr circuit of MIXED_DEPTH layers: layer i has 2^i gates
    of random op, random inputs among the 2^(i+1) below and random output
    slots (some shared, so outputs accumulate), the top slot always used."""
    rng = np.random.default_rng(77)
    layers = []
    for i in range(MIXED_DEPTH):
        n = 1 << i
        outs = rng.integers(0, n, size=n)
        outs[0] = n - 1
        layers.append(jlayered.Layer.from_arrays(rng.integers(0, 2 * n, size=n), rng.integers(0, 2 * n, size=n), outs,
                                                 rng.integers(0, 2, size=n)))
    ctx = jarith.field_ctx("bn254_fr")
    rng = np.random.default_rng(78)
    return jlayered.Circuit(ctx, layers), [int.from_bytes(rng.bytes(32), "little") % ctx.p for _ in range(2 << (MIXED_DEPTH - 1))]


def reference() -> dict:
    """Everything the tests compare against, computed by tpu_zk (in the
    child process): the sponge cases through absorb_dyn/squeeze_dyn/
    digest_to_mont (and DeviceSponge at STATIC_POS), fused_basic_prove with
    the proofs and next challenges of basic.Prover, fused_gkr_sumcheck_prove,
    and sparse.prove of the mixed circuit."""
    import jax
    import jax.numpy as jnp

    from tpu_zk.gkr import sparse as jsparse
    from tpu_zk.poly.multilinear import MultilinearPolynomial as JMLE
    from tpu_zk.sumcheck import basic as jbasic
    from tpu_zk.transcript import device_fs as jfs
    from tpu_zk.transcript.fiat_shamir import Transcript as JTranscript
    from tpu_zk.transcript.keccak import Keccak256 as JKeccak256
    from tpu_zk.utils import serialize as jser

    jctx = jarith.field_ctx("bn254_fr")
    # every fill level at once: the traced-pos functions mapped over a batch of sponges
    absorb = jax.jit(jax.vmap(jfs.absorb_dyn))
    squeeze = jax.jit(jax.vmap(jfs.squeeze_dyn))
    to_mont = jax.jit(jax.vmap(lambda d: jfs.digest_to_mont(jctx, d)))
    sponge = {}
    for k in SPONGE_KS:
        inputs = [_sponge_input(k, pos) for pos in range(RATE)]
        st = jnp.asarray(np.stack([pairs for pairs, _, _ in inputs]))
        bf = jnp.asarray(np.stack([buf for _, buf, _ in inputs]).astype(np.uint32))
        ps = jnp.arange(RATE, dtype=jnp.int32)
        data = np.stack([d for _, _, d in inputs]).astype(np.uint32)
        for i in range(0, k, RATE):  # absorb_dyn takes at most RATE bytes a call
            st, bf, ps = absorb(st, bf, ps, jnp.asarray(data[:, i : i + RATE]))
        after = (np.asarray(st), np.asarray(bf), np.asarray(ps))
        digest, st, bf, ps = squeeze(st, bf, ps)
        squeezed = (np.asarray(st), np.asarray(bf), np.asarray(ps))
        challenge = np.asarray(to_mont(digest))
        for pos in range(RATE):
            pairs, buf, data = inputs[pos]
            sponge[k, pos] = {"absorbed": tuple(a[pos] for a in after), "digest": np.asarray(digest[pos]),
                              "squeezed": tuple(a[pos] for a in squeezed), "challenge": challenge[pos]}
            if pos in STATIC_POS:
                s = jfs.DeviceSponge(jnp.asarray(pairs), jnp.asarray(buf.astype(np.uint32)), pos).absorb(jnp.asarray(data.astype(np.uint32)))
                r, s2 = s.challenge_mont(jctx)
                sponge[k, pos]["static"] = (np.asarray(s.state), np.asarray(s.buf), s.pos, np.asarray(r),
                                            np.asarray(s2.state), np.asarray(s2.buf), s2.pos)

    host = JKeccak256()
    host.update(b"\x07" * 150)
    seeded = jfs.DeviceSponge.from_host(host)
    out = {"sponge": sponge, "from_host": (np.asarray(seeded.state), np.asarray(seeded.buf), seeded.pos),
           "basic": {}, "gkr": {}}

    for name, log_n in BASIC_CASES:
        ctx = jarith.field_ctx(name)
        poly = JMLE.from_ints(ctx, _table(name, log_n))
        prover = jbasic.Prover(poly)
        proof = prover.prove()  # fused, tpu_zk's default
        # fused_basic_prove itself, from the sponge the prover seeded (the same compiled program)
        t = JTranscript()
        t.append(poly.convert_to_bytes())
        t.append(ctx.to_bytes_be(poly.sum()))
        s = jfs.DeviceSponge.from_host(t._hasher)
        res = jfused.fused_basic_prove(ctx, poly.table, s.state, s.buf, s.pos)
        out["basic"][name, log_n] = {"json": jser.sumcheck_proof_to_json(proof),
                                     "next_challenge": prover.transcript.sample_random_challenge(),
                                     "fused": tuple(np.asarray(x) for x in res), "pos": s.pos}

    for degree in GKR_DEGREES:
        s = jfs.DeviceSponge.from_host(_host_seeded(JKeccak256(), degree))
        res = jfused.fused_gkr_sumcheck_prove(jctx, jnp.asarray(_working_set(degree)), s.state, s.buf, s.pos)
        out["gkr"][degree] = {"fused": tuple(np.asarray(x) for x in res), "pos": s.pos}

    # tpu_zk's host-synced prover: its fused one, whose programs (one a layer phase and fill level) take four
    # times as long to compile on the CPU, emits the same bytes (tests/test_fused_sparse.py)
    circuit, inputs = _mixed_circuit()
    out["mixed_json"] = jser.gkr_proof_to_json(jsparse.prove(circuit, inputs, fused=False), jctx.name)
    return out


@pytest.fixture(scope="module")
def ref():
    return jax_reference.call("tests.test_torch_fused", "reference")


# -- the device sponge ---------------------------------------------------------


def _port_sponge(k, pos):
    pairs, buf, data = _sponge_input(k, pos)
    return (torch.from_numpy(_lanes_from_pairs(pairs).copy()), torch.from_numpy(buf.copy()),
            torch.tensor([pos], dtype=torch.int32), torch.from_numpy(data.copy()))


def _same_sponge(got, want, what):
    state, buf, pos = got
    w_state, w_buf, w_pos = want
    assert np.array_equal(state.numpy(), _lanes_from_pairs(w_state)), what
    assert np.array_equal(buf.numpy(), w_buf.astype(np.uint8)), what
    assert int(pos[0]) == int(w_pos), what


@pytest.mark.parametrize("k", SPONGE_KS)
def test_sponge_matches_tpu_zk(k, ref):
    """K7's plain version at every fill level 0..135: k bytes absorbed, then
    a squeeze with its Montgomery challenge, against absorb_dyn/squeeze_dyn/
    digest_to_mont; the static-pos DeviceSponge at STATIC_POS."""
    ctx = arith.field_ctx("bn254_fr")
    for pos in range(RATE):
        want = ref["sponge"][k, pos]
        state, buf, p, data = _port_sponge(k, pos)
        device_fs.absorb_dyn(state, buf, p, data)
        _same_sponge((state, buf, p), want["absorbed"], (k, pos, "absorb"))
        digest, challenge = torch.empty(32, dtype=torch.uint8), torch.empty(ctx.L, dtype=torch.int32)
        sponge_step(state, buf, p, torch.empty(0, dtype=torch.uint8), digest, challenge, ctx)
        assert np.array_equal(digest.numpy(), want["digest"].astype(np.uint8)), (k, pos)
        _same_sponge((state, buf, p), want["squeezed"], (k, pos, "squeeze"))
        assert np.array_equal(limbs_to_numpy(challenge), want["challenge"]), (k, pos)
        assert np.array_equal(limbs_to_numpy(device_fs.digest_to_mont(ctx, digest)), want["challenge"])
        if pos in STATIC_POS:
            st, bf, ps, r, st2, bf2, ps2 = want["static"]
            s = device_fs.DeviceSponge(*_port_sponge(k, pos)[:3]).absorb(_port_sponge(k, pos)[3])
            _same_sponge((s.state, s.buf, s.pos), (st, bf, ps), (k, pos, "static absorb"))
            r_port, s = s.challenge_mont(ctx)
            assert np.array_equal(limbs_to_numpy(r_port), r)
            _same_sponge((s.state, s.buf, s.pos), (st2, bf2, ps2), (k, pos, "static squeeze"))


def test_sponge_squeeze_matches_the_host_transcript():
    """squeeze_dyn, absorb in pieces and the digest bytes against the host
    Keccak256 transcript (clone-finalize-reabsorb)."""
    rng = np.random.default_rng(3)
    host = Keccak256()
    s = device_fs.DeviceSponge.fresh("cpu")
    for n in (0, 1, 135, 136, 137, 64, 272, 7):
        data = rng.bytes(n)
        host.update(data)
        s.absorb(torch.frombuffer(bytearray(data), dtype=torch.uint8) if n else torch.empty(0, dtype=torch.uint8))
        digest, state, buf, pos = device_fs.squeeze_dyn(s.state, s.buf, s.pos)
        want = host.copy().digest()
        host.update(want)
        assert bytes(digest.numpy()) == want
        assert device_fs.DeviceSponge.to_host(state, buf, int(pos[0])).snapshot() == host.snapshot()


def test_sponge_from_host_to_host_round_trip(ref):
    host = Keccak256()
    host.update(b"\x07" * 150)
    s = device_fs.DeviceSponge.from_host(host, "cpu")
    _same_sponge((s.state, s.buf, s.pos), ref["from_host"], "from_host")
    assert device_fs.DeviceSponge.to_host(s.state, s.buf, int(s.pos[0])).snapshot() == host.snapshot()
    # the top bit of a lane survives the int64 carrier
    host._state[3] = np.uint64(0xFEDCBA9876543210)
    s = device_fs.DeviceSponge.from_host(host, "cpu")
    assert device_fs.DeviceSponge.to_host(s.state, s.buf, 14).snapshot() == host.snapshot()


def test_digest_to_mont_edges_and_bls12_381_fq_raises():
    """The digests 2^256 - 1 and p reduce mod p (the first operand of the
    Montgomery product may be any value below R); BLS12-381 Fq's 24 limbs
    are not a 32-byte digest's."""
    for name in ("bn254_fr", "bls12_381_fr", "bn254_fq"):
        ctx = arith.field_ctx(name)
        for value in ((1 << 256) - 1, ctx.p, 0, ctx.p - 1):
            digest = torch.tensor(list(value.to_bytes(32, "little")), dtype=torch.uint8)
            got = device_fs.digest_to_mont(ctx, digest)
            assert ctx.to_ints(got) == value % ctx.p
    fq = arith.field_ctx("bls12_381_fq")
    with pytest.raises(ValueError):
        device_fs.digest_to_mont(fq, torch.zeros(32, dtype=torch.uint8))
    s = device_fs.DeviceSponge.fresh("cpu")
    with pytest.raises(ValueError):
        s.challenge_mont(fq)
    with pytest.raises(ValueError):  # a state of the wrong width
        sponge_step(s.state[:24], s.buf, s.pos, torch.empty(0, dtype=torch.uint8))


ROUND_POS = sorted(set(range(0, RATE, 5)) | {104, 135})  # 29 fill levels, the block's last byte among them


def _round_case(ctx, w: int, pos: int):
    """A random sponge at fill level pos and w random Montgomery elements."""
    pairs, buf, _ = _sponge_input(0, pos)
    rng = np.random.default_rng(500 + 7 * w + pos)
    mont = ctx.array([int.from_bytes(rng.bytes(32), "little") % ctx.p for _ in range(w)], mont=False, device="cpu")
    return (torch.from_numpy(_lanes_from_pairs(pairs).copy()), torch.from_numpy(buf.copy()),
            torch.tensor([pos], dtype=torch.int32), mont)


@pytest.mark.parametrize("w,big_endian", [(2, True), (3, False)])
def test_sponge_round_matches_from_mont_pack_and_step(w, big_endian):
    """K7's round form (its plain version, through the wrapper) equals
    from_mont, pack_bytes_be/le and the byte form's plain version at 29 fill
    levels over 0..135, 135 among them: state, tail, fill level, plain slot,
    digest and challenge; and it counts from_mont's w products."""
    ctx = arith.field_ctx("bn254_fr")
    pack = device_fs.pack_bytes_be if big_endian else device_fs.pack_bytes_le
    for pos in ROUND_POS:
        state, buf, p, mont = _round_case(ctx, w, pos)
        want_state, want_buf, want_p = state.clone(), buf.clone(), p.clone()
        want_slot = arith.from_mont(ctx, mont)
        want_digest, want_chal = torch.empty(32, dtype=torch.uint8), torch.empty(ctx.L, dtype=torch.int32)
        sponge_step_plain(want_state, want_buf, want_p, pack(ctx, want_slot), want_digest, want_chal, ctx)
        slot, digest = torch.empty((w, ctx.L), dtype=torch.int32), torch.empty(32, dtype=torch.uint8)
        chal = torch.empty(ctx.L, dtype=torch.int32)
        counters.enable(True)
        counters.reset()
        try:
            sponge_round(state, buf, p, mont, slot, digest, chal, ctx, big_endian=big_endian)
            assert counters.summary() == {ctx.name: {"mul": w}}
        finally:
            counters.enable(False)
        for got, want in ((state, want_state), (buf, want_buf), (p, want_p), (slot, want_slot), (digest, want_digest),
                          (chal, want_chal)):
            assert torch.equal(got, want), (w, big_endian, pos)
        assert sponge_round.launches == 0  # the CPU runs the plain version


def test_sponge_round_plain_chains_across_a_block():
    """Rounds chained on one sponge through the plain version equal the byte
    form's steps on a copy, through every block boundary of 40 rounds."""
    ctx = arith.field_ctx("bn254_fr")
    state, buf, p, _ = _round_case(ctx, 1, 100)
    twin = (state.clone(), buf.clone(), p.clone())
    for i in range(40):
        w, big_endian = (2, True) if i % 3 == 0 else (3 + i % 2, False)
        _, _, _, mont = _round_case(ctx, w, i)
        slot, digest = torch.empty((w, ctx.L), dtype=torch.int32), torch.empty(32, dtype=torch.uint8)
        chal = torch.empty(ctx.L, dtype=torch.int32)
        sponge_round_plain(state, buf, p, mont, slot, digest, chal, ctx, big_endian)
        plain = arith.from_mont(ctx, mont)
        d2, c2 = torch.empty(32, dtype=torch.uint8), torch.empty(ctx.L, dtype=torch.int32)
        pack = device_fs.pack_bytes_be if big_endian else device_fs.pack_bytes_le
        sponge_step(*twin, pack(ctx, plain), d2, c2, ctx)
        assert torch.equal(slot, plain) and torch.equal(digest, d2) and torch.equal(chal, c2), i
        assert torch.equal(state, twin[0]) and torch.equal(buf, twin[1]) and torch.equal(p, twin[2]), i


def test_sponge_round_raises():
    """BLS12-381 Fq (24 limbs), a wrong dtype or shape, too many elements and
    tensors on mixed devices raise; nothing runs and nothing is counted."""
    ctx = arith.field_ctx("bn254_fr")
    state, buf, p, mont = _round_case(ctx, 2, 7)

    def outs(w=2, L=ctx.L):
        return torch.empty((w, L), dtype=torch.int32), torch.empty(32, dtype=torch.uint8), torch.empty(L, dtype=torch.int32)

    fq = arith.field_ctx("bls12_381_fq")
    with pytest.raises(ValueError):
        sponge_round(state, buf, p, fq.array([1, 2], device="cpu"), *outs(L=fq.L), fq, big_endian=True)
    bad = [
        (state, buf, p, mont.to(torch.int64), *outs()),  # dtype of mont
        (state, buf, p, mont, torch.empty((2, ctx.L), dtype=torch.int64), *outs()[1:]),  # dtype of the slot
        (state, buf, p, mont, *outs(w=3)),  # slot of another width
        (state, buf, p, mont[0], *outs(w=1)),  # mont not [w, L]
        (state, buf, p, mont, outs()[0], torch.empty(31, dtype=torch.uint8), outs()[2]),  # digest shape
        (state, buf, p, mont, *outs()[:2], torch.empty(ctx.L - 1, dtype=torch.int32)),  # challenge shape
        (state[:24], buf, p, mont, *outs()),  # state width
        (state, buf, p.to(torch.int64), mont, *outs()),  # pos dtype
        (state, buf, p, mont.t().contiguous().t(), *outs()),  # mont not contiguous
        (state, buf, p, mont.repeat(65, 1), *outs(w=130)),  # more elements than a launch takes
        (state.to("meta"), buf, p, mont, *outs()),  # mixed devices
    ]
    counters.reset()
    counters.enable()
    try:
        for i, args in enumerate(bad):
            before = (state.clone(), buf.clone(), p.clone())
            with pytest.raises(ValueError):
                sponge_round(*args, ctx, big_endian=False)
            assert torch.equal(state, before[0]) and torch.equal(buf, before[1]) and torch.equal(p, before[2]), i
        assert counters.summary() == {}  # a refused call counts no product
    finally:
        counters.enable(False)
        counters.reset()


# -- the fused provers ---------------------------------------------------------


@pytest.mark.parametrize("name,log_n", BASIC_CASES)
def test_fused_basic_prove_matches_tpu_zk(name, log_n, ref):
    """fused_basic_prove's univariates (plain and Montgomery), digests and
    final sponge against tpu_zk's; the device fill level equals final_pos."""
    ctx = arith.field_ctx(name)
    want = ref["basic"][name, log_n]
    poly = MultilinearPolynomial.from_ints(ctx, _table(name, log_n))
    t = Transcript()
    t.append(poly.convert_to_bytes())
    t.append(ctx.to_bytes_be(poly.sum()))
    s = device_fs.DeviceSponge.from_host(t._hasher)
    assert int(s.pos[0]) == want["pos"]
    plain, mont, digests, state, buf = fused.fused_basic_prove(ctx, poly.table, s.state, s.buf, s.pos)
    w_plain, w_mont, w_digests, w_state, w_buf = want["fused"]
    assert np.array_equal(limbs_to_numpy(plain), w_plain)
    assert np.array_equal(limbs_to_numpy(mont), w_mont)
    assert np.array_equal(digests.numpy(), w_digests.astype(np.uint8))
    assert np.array_equal(state.numpy(), _lanes_from_pairs(w_state))
    assert np.array_equal(buf.numpy(), w_buf.astype(np.uint8))
    assert int(s.pos[0]) == fused.final_pos(want["pos"], log_n, 2 * ctx.nbytes)


@pytest.mark.parametrize("name,log_n", BASIC_CASES)
def test_basic_prove_fused_and_host_synced_match_tpu_zk(name, log_n, ref):
    """basic.Prover.prove with fused=True (the default) and False: the proof
    JSON and the transcript's next challenge equal tpu_zk's."""
    ctx = arith.field_ctx(name)
    want = ref["basic"][name, log_n]
    for fused_flag in (True, False):
        prover = basic.Prover.init(ctx, _table(name, log_n))
        proof = prover.prove(fused=fused_flag)
        assert serialize.sumcheck_proof_to_json(proof) == want["json"], fused_flag
        assert prover.transcript.sample_random_challenge() == want["next_challenge"], fused_flag
        assert basic.Verifier.init().verify(proof)


@pytest.mark.parametrize("degree", GKR_DEGREES)
def test_fused_gkr_sumcheck_prove_matches_tpu_zk(degree, ref):
    ctx = arith.field_ctx("bn254_fr")
    want = ref["gkr"][degree]
    s = device_fs.DeviceSponge.from_host(_host_seeded(Keccak256(), degree))
    assert int(s.pos[0]) == want["pos"]
    coeffs, digests, state, buf, folded = fused.fused_gkr_sumcheck_prove(
        ctx, limbs_from_numpy(_working_set(degree)), s.state, s.buf, s.pos)
    w_coeffs, w_digests, w_state, w_buf = want["fused"]
    assert np.array_equal(limbs_to_numpy(coeffs), w_coeffs)
    assert np.array_equal(digests.numpy(), w_digests.astype(np.uint8))
    assert np.array_equal(state.numpy(), _lanes_from_pairs(w_state))
    assert np.array_equal(buf.numpy(), w_buf.astype(np.uint8))
    n = GKR_ROWS.bit_length() - 1
    assert int(s.pos[0]) == fused.final_pos(want["pos"], n, (degree + 1) * ctx.nbytes)
    assert folded.shape == (2, degree, 1, ctx.L)


@pytest.mark.parametrize("degree", GKR_DEGREES)
def test_prove_and_fold_fused_equals_host_synced(degree):
    """prove_and_fold with fused=True and False: the same proof, transcript
    and working set folded at every challenge, the last included (each
    factor table then holds its value at the challenge point)."""
    ctx = arith.field_ctx("bn254_fr")
    poly = SumPolynomial(ctx, limbs_from_numpy(_working_set(degree)))
    evals = gkr_sumcheck.generate_round_univariate(poly)
    claim = (evals[0] + evals[1]) % ctx.p
    runs = []
    for fused_flag in (True, False):
        transcript = Transcript()
        transcript.append(b"\x01" * 77)
        proof, done = gkr_sumcheck.prove_and_fold(poly, claim, transcript, fused_flag)
        runs.append((proof, done, transcript.sample_random_challenge()))
    (p1, d1, c1), (p2, d2, c2) = runs
    assert p1.random_challenges == p2.random_challenges and c1 == c2
    assert [u.coefficients for u in p1.round_univariate_polynomials] == [u.coefficients for u in p2.round_univariate_polynomials]
    assert torch.equal(d1.stacked, d2.stacked) and d1.stacked.shape[2] == 1
    point = p1.random_challenges
    for i in range(2):
        for j in range(degree):
            assert ctx.to_ints(d1.stacked[i, j, 0]) == MultilinearPolynomial(ctx, poly.stacked[i, j]).evaluate(point)


def test_vandermonde_inv_mont_matches_tpu_zk():
    for name in ("bn254_fr", "bls12_381_fr"):
        for npoints in (2, 3, 4):
            assert np.array_equal(fused._vandermonde_inv_mont(name, npoints), jfused._vandermonde_inv_mont(name, npoints))


def test_final_pos_is_the_device_fill_level():
    """final_pos (host) against the pos K7's plain version leaves on the
    device, over rounds of 64 and 96 bytes from every start."""
    for absorb in (64, 96, 144):
        for start in (0, 40, 135):
            s = device_fs.DeviceSponge.fresh("cpu")
            s.absorb(torch.zeros(start, dtype=torch.uint8))
            for _ in range(5):
                s.absorb(torch.ones(absorb, dtype=torch.uint8))
                s.squeeze()
            assert int(s.pos[0]) == fused.final_pos(start, 5, absorb)


def test_sparse_prove_fused_and_host_synced_match_tpu_zk(ref):
    """sparse.prove and fused_sparse.prove with fused=True and False on the
    random mixed circuit: JSON byte for byte equal to tpu_zk's."""
    jc, inputs = _mixed_circuit()
    circuit = circuit_from_arrays(arith.field_ctx("bn254_fr"), jc.layers)
    for prove in (sparse.prove, fused_sparse.prove):
        for fused_flag in (True, False):
            proof = prove(circuit, inputs, fused=fused_flag)
            assert serialize.gkr_proof_to_json(proof, "bn254_fr") == ref["mixed_json"], (prove, fused_flag)
    assert sparse.verify(circuit, serialize.gkr_proof_from_json(ref["mixed_json"]), inputs)


def test_prove_succinct_fused_equals_host_synced():
    """prove_succinct and fused_sparse.prove_succinct with fused=True and
    False: the same JSON, which verifies (the succinct JSON against tpu_zk's
    is tests/test_torch_succinct.py's, for both values of fused)."""
    ctx = arith.field_ctx("bls12_381_fr")
    G = jlayered.Gate
    jc = jlayered.Circuit(jarith.field_ctx("bls12_381_fr"), [jlayered.Layer([G.mul(0, 1, 0)]),
                                                            jlayered.Layer([G.add(0, 1, 0), G.mul(2, 3, 1)])])
    circuit = circuit_from_arrays(ctx, jc.layers)
    setup = TrustedSetup.initialize_setup("bls12_381", [5, 2])
    jsons = {serialize.succinct_proof_to_json(prove(circuit, [2, 3, 4, 5], setup, fused=f), ctx.name)
             for prove in (sparse.prove_succinct, fused_sparse.prove_succinct) for f in (True, False)}
    assert len(jsons) == 1
    assert sparse.verify_succinct(circuit, serialize.succinct_proof_from_json(jsons.pop()), setup)
