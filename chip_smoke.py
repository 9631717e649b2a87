#!/usr/bin/env python3
"""Run tpu_zk_torch's basic sumcheck, GKR, MSM, KZG, succinct GKR, NTT and FRI on one CUDA card and check its kernels.

    python3 chip_smoke.py [--seed S]

Phases, in order; any failure raises and the exit code is nonzero:

1. require a CUDA card; print ``nvidia-smi``'s name and power limit;
2. build the kernels (one nvcc per source, side by side, sm_90a), the host
   Keccak and the host pairing engine, timed; print each kernel's registers
   and spills as ptxas reported them; probe the card's rate of wide
   (32 x 32 + 64 -> 64 bit) multiply-adds, the unit of the field kernels'
   operation bounds, and of 32-bit funnel shifts and logic ops, K5's;
3. K1 (Montgomery multiply) against its plain version, bit-exact, all four
   fields: 2^20 random elements, every pair of edge values, a broadcast scalar;
4. K2 (fold + block sums) against its plain version, bit-exact: batch rows
   B in {1, 4}, T from 1 to 2^23 with ragged block tails, r in {0, 1, p-1,
   random} (random only, above 2^16 pairs);
5. K3 (modular add/sub) against its plain version, bit-exact, all four
   fields, add and sub: 2^20 random pairs, every pair of edge values, a
   broadcast b; then K1 and K3 on [2^23, 16] pairs, a depth-24 GKR round's;
6. the transcript golden: the first challenge for [0, 0, 3, 8] over BN254 Fq,
   computed by hand;
7. slice parity over BN254 Fr: the proof JSON from the card equals the one
   from the CPU (plain versions), and both verify -- basic sumcheck at 2^12,
   GKR on a depth-6 mixed ADD/MUL circuit and on a depth-8 ADD tree;
8. the basic-sumcheck main path over BN254 Fr at 2^24 (then at 2^20):
   ``to_mont`` of a random table, ``Prover.prove`` and ``Verifier.verify``,
   first call and warm; a tampered claim must fail; K1 and K2 must launch;
9. the GKR main path over BN254 Fr, ``tree_sum_circuit`` of depth 24
   (2^24 random inputs, 2^24 - 1 gates), then depth 20: ``Circuit.evaluate``,
   ``sparse.prove`` and ``sparse.verify``, first call and warm; the output
   must equal the host's sum of the inputs; a tampered wb evaluation and a
   tampered round coefficient must fail; K1, K2 and K3 must launch;
10. each kernel's time beside its plain version's, at the sumcheck's 2^24
   shapes and at a depth-24 GKR round's (K3 on 2^25 elements, K1 on 2^24
   pairs, K2 at B = 4, T = 2^23), each output bit-exact against the plain
   version's;
11. a GKR proof from host ints with no device argument: it must reach the
   card (K1, K2 and K3 launch);
12. K4a (MSM unit sums, every pass) and K4b (segment-weighted bucket
   totals) against their plain versions as group elements and against a
   second launch limb for limb, over BN254 and BLS12-381 G1, at 2^12 points
   with duplicates, P and -P, identity points, the scalars 0, 1, r - 1 and
   2^256 - 1, at c = 10 (the rule's), 8 (units of 4) and 16; scalars in
   {0, 1} at c = 2, all-zero, all-equal and below-2^16 scalars;
   ``msm_pippenger`` against the double-and-add MSM and host ints at 2^12,
   64, 3, 2, 1 and 0 points;
13. succinct-GKR parity: the proof JSON from the card equals the one from
   the CPU on a BLS12-381 two-layer circuit and a BN254 depth-6 mixed
   circuit; tampered proofs and a wrong opening point fail;
14. KZG alone over BN254 at 20 variables (setup, commit, open, verify apart),
   then succinct GKR at depth 20;
15. MSM alone over BN254 at 2^20 and 2^24 points, random, all-equal and
   below-2^16 scalars, first call and warm and stage by stage: each result
   must be (sum s_i a_i) G; at 2^24 every unit of every K4a pass and every
   segment total of K4b is held against the plain versions, and c (13-16),
   K4a's unit R (16-128) and K4b's segment m (8-64) are swept;
16. the succinct-GKR main path at depth 24: ``prove_succinct``, the proof to
   JSON and back, ``verify_succinct``, first call and warm, then under the
   stage timers; K1-K4 must launch and no double-and-add MSM run; tampered
   proofs fail;
17. K6 (NTT pass) against its plain version, bit-exact, both Fr fields, at
   every radix the plans use and small ones, with and without pre-twiddle,
   scale and natural-order store, ragged column counts;
18. K5 (Keccak rows) against its plain version, bit-exact, widths 0, 1, 32,
   64 and 135, 1 to 2^22 rows, rows off a 16-byte line;
19. the NTT path over BN254 Fr: ``NTT.forward``/``inverse`` at 2^24 and 2^20,
   first call and warm; inverse(forward(x)) == x; at 2^20 both equal the
   stage-at-a-time oracle; ``polynomial_multiply`` of two degree-2^19 - 1
   polynomials from host ints, checked at 32 random points by Horner on
   host ints; K6 must launch;
20. FRI: the proof from the card equals the CPU's at 2^10; then the NTT ->
   Merkle-committed ``fri.prove`` -> ``fri.verify`` path at 2^24 (a random
   polynomial of degree < 2^22) and 2^18 (``bench_fri``'s table and
   parameters), first call and warm, K5's Merkle levels round by round,
   then under the stage timers; tampered
   final codeword, query value and Merkle sibling fail, and so do random
   evaluations; K5 and K6 must launch;
21. K6 over the three passes of a 2^24 forward and K5 over a 2^24-leaf tree,
   beside their plain versions and bounds (wide multiply-adds and 32-bit
   logic/shift ops at the rates probed in phase 2).

The next-to-last line is ``{"kernels": [...]}``, the last line
``{"ok": true, "device": {...}}``.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

FIELDS = ["bn254_fq", "bn254_fr", "bls12_381_fr", "bls12_381_fq"]
MAIN_LOG_N = 24
BENCH_LOG_N = 20
PARITY_LOG_N = 12
GKR_DEPTHS = (24, 20)  # the main path's tree depths: BASELINE config 5's gate count, then the largest timed before
GKR_PARITY_DEPTHS = (6, 8)  # mixed ADD/MUL circuit, ADD tree
K2_MAX_LOG_T = {1: 23, 4: 21}  # batch rows -> largest power-of-two T checked


def log(msg: str) -> None:
    print(msg, flush=True)


def sync_time(fn):
    """(result, seconds) of fn(), synchronized on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def event_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps runs, after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rand_canonical(ctx, shape, gen, device):
    """Random canonical limbs: the top limb below p's top limb keeps values < p."""
    t = torch.randint(0, 1 << 16, (*shape, ctx.L), generator=gen, device=device, dtype=torch.int32)
    t[..., -1] = torch.randint(0, ctx.p >> (16 * (ctx.L - 1)), shape, generator=gen, device=device, dtype=torch.int32)
    return t


def max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0


def check_equal(what: str, got: torch.Tensor, want: torch.Tensor) -> None:
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"{what}: kernel disagrees with its plain version (max |diff| {max_err(got, want)})")


def check_k1(device, gen) -> None:
    from tpu_zk_torch.fields import kernels
    from tpu_zk_torch.fields.arith import field_ctx

    for name in FIELDS:
        ctx = field_ctx(name)
        a = rand_canonical(ctx, (1 << 20,), gen, device)
        b = rand_canonical(ctx, (1 << 20,), gen, device)
        check_equal(f"K1 {name} random", kernels.mont_mul(ctx, a, b), kernels.mont_mul_plain(ctx, a, b))
        e = ctx.array([0, 1, ctx.p - 1, ctx.R % ctx.p], mont=False, device=device)
        ea, eb = e.repeat_interleave(4, 0), e.repeat(4, 1)
        check_equal(f"K1 {name} edges", kernels.mont_mul(ctx, ea, eb), kernels.mont_mul_plain(ctx, ea, eb))
        for s in list(e) + [b[7]]:
            s = s.contiguous()
            check_equal(f"K1 {name} broadcast", kernels.mont_mul(ctx, a, s), kernels.mont_mul_plain(ctx, a, s))
        log(f"K1 {name}: 2^20 random, 16 edge pairs, 5 broadcast scalars bit-exact")


def check_k2(device, gen) -> None:
    from tpu_zk_torch.fields import kernels
    from tpu_zk_torch.fields.arith import field_ctx

    ctx = field_ctx("bn254_fr")
    rs = {"0": ctx.scalar(0, device=device), "1": ctx.scalar(1, device=device),
          "p-1": ctx.scalar(ctx.p - 1, device=device)}
    cases = 0
    for B, max_log_t in K2_MAX_LOG_T.items():
        for log_t in range(max_log_t + 1):
            T = 1 << log_t
            for T_case, block in ((T, min(1024, max(T // 2, 1))), (T + 3 + T // 3, 1024)):
                flat = rand_canonical(ctx, (B, 2 * T_case), gen, device)
                rr = dict(rs) if T_case <= 1 << 16 else {}
                rr["random"] = rand_canonical(ctx, (), gen, device)
                for rname, r in rr.items():
                    f_k, s_k = kernels.fold(ctx, flat, r, block)
                    f_p, s_p = kernels.fold_plain(ctx, flat, r, block)
                    check_equal(f"K2 folded B={B} T={T_case} block={block} r={rname}", f_k, f_p)
                    check_equal(f"K2 sums B={B} T={T_case} block={block} r={rname}", s_k, s_p)
                    cases += 1
                del flat
    log(f"K2 bn254_fr: {cases} cases bit-exact (B in 1,4; T 1..2^23; ragged tails)")


def check_k3(device, gen) -> None:
    from tpu_zk_torch.fields import kernels
    from tpu_zk_torch.fields.arith import field_ctx

    for name in FIELDS:
        ctx = field_ctx(name)
        a = rand_canonical(ctx, (1 << 20,), gen, device)
        b = rand_canonical(ctx, (1 << 20,), gen, device)
        e = ctx.array([0, 1, ctx.p - 1, ctx.R % ctx.p], mont=False, device=device)
        ea, eb = e.repeat_interleave(4, 0), e.repeat(4, 1)
        for kind, plain in (("add", kernels.add_plain), ("sub", kernels.sub_plain)):
            check_equal(f"K3 {name} {kind} random", kernels.addsub(ctx, a, b, kind), plain(ctx, a, b))
            check_equal(f"K3 {name} {kind} edges", kernels.addsub(ctx, ea, eb, kind), plain(ctx, ea, eb))
            for s in list(e) + [b[7]]:
                s = s.contiguous()
                check_equal(f"K3 {name} {kind} broadcast", kernels.addsub(ctx, a, s, kind), plain(ctx, a, s))
        log(f"K3 {name}: add and sub, 2^20 random, 16 edge pairs, 5 broadcast b bit-exact")

    # the pairs of a depth-24 GKR round: T = 2^23 per factor table
    ctx = field_ctx("bn254_fr")
    a = rand_canonical(ctx, (1 << 23,), gen, device)
    b = rand_canonical(ctx, (1 << 23,), gen, device)
    check_equal("K1 [2^23, 16]", kernels.mont_mul(ctx, a, b), kernels.mont_mul_plain(ctx, a, b))
    check_equal("K3 add [2^23, 16]", kernels.addsub(ctx, a, b, "add"), kernels.add_plain(ctx, a, b))
    check_equal("K3 sub [2^23, 16]", kernels.addsub(ctx, a, b, "sub"), kernels.sub_plain(ctx, a, b))
    log("K1, K3 bn254_fr at a depth-24 GKR round's [2^23, 16] pairs: bit-exact")


def check_transcript_golden(device) -> None:
    from tpu_zk_torch.fields.arith import field_ctx
    from tpu_zk_torch.sumcheck.basic import Prover
    from tpu_zk_torch.transcript.keccak import keccak256, keccak256_plain

    ctx = field_ctx("bn254_fq")
    vals = [0, 0, 3, 8]
    proof = Prover.init(ctx, vals, device=device).prove()
    absorbed = b"".join(v.to_bytes(32, "big") for v in vals + [11, 0, 11])
    if keccak256(absorbed) != keccak256_plain(absorbed):
        raise AssertionError("native Keccak disagrees with the numpy sponge")
    r0 = int.from_bytes(keccak256_plain(absorbed), "little") % ctx.p
    got = [u.to_ints() for u in proof.round_univariate_polynomials]
    if got != [[0, 11], [3 * r0 % ctx.p, 8 * r0 % ctx.p]]:
        raise AssertionError(f"transcript golden: round univariates {got}")
    log(f"transcript golden: r0 = {hex(r0)}")


def check_slice_parity(device, rng) -> None:
    from tpu_zk_torch.fields.arith import field_ctx
    from tpu_zk_torch.sumcheck.basic import Prover, Verifier
    from tpu_zk_torch.utils.serialize import sumcheck_proof_to_json

    ctx = field_ctx("bn254_fr")
    vals = [int.from_bytes(rng.bytes(32), "little") % ctx.p for _ in range(1 << PARITY_LOG_N)]
    jsons = []
    for dev in (device, torch.device("cpu")):
        proof = Prover.init(ctx, vals, device=dev).prove()
        if not Verifier.init().verify(proof):
            raise AssertionError(f"2^{PARITY_LOG_N} proof on {dev} does not verify")
        jsons.append(sumcheck_proof_to_json(proof))
    if jsons[0] != jsons[1]:
        raise AssertionError("proof JSON from the card differs from the CPU's")
    log(f"slice parity 2^{PARITY_LOG_N} bn254_fr: CUDA proof JSON == CPU proof JSON ({len(jsons[0])} bytes), both verify")


def mixed_circuit(ctx, depth: int, rng):
    """A random layered circuit: layer i has 2^i gates of random op, random
    inputs among the 2^(i+1) below, and random output slots (some shared,
    so outputs accumulate) below 2^i, the top slot always used."""
    from tpu_zk_torch.circuit.layered import Circuit, Layer

    layers = []
    for i in range(depth):
        n = 1 << i
        outs = rng.integers(0, n, size=n)
        outs[0] = n - 1
        layers.append(Layer.from_arrays(rng.integers(0, 2 * n, size=n), rng.integers(0, 2 * n, size=n), outs,
                                        rng.integers(0, 2, size=n)))
    return Circuit(ctx, layers)


def check_gkr_parity(device, rng) -> None:
    from tpu_zk_torch.circuit.layered import tree_sum_circuit
    from tpu_zk_torch.fields.arith import field_ctx
    from tpu_zk_torch.gkr import sparse
    from tpu_zk_torch.utils.serialize import gkr_proof_to_json

    ctx = field_ctx("bn254_fr")
    mixed_depth, tree_depth = GKR_PARITY_DEPTHS
    for what, circuit, depth in ((f"mixed depth {mixed_depth}", mixed_circuit(ctx, mixed_depth, rng), mixed_depth),
                                 (f"ADD tree depth {tree_depth}", tree_sum_circuit(ctx, tree_depth), tree_depth)):
        vals = [int.from_bytes(rng.bytes(32), "little") % ctx.p for _ in range(1 << depth)]
        jsons = []
        for dev in (device, torch.device("cpu")):
            table = ctx.array(vals, device=dev)
            proof = sparse.prove(circuit, table)
            if not sparse.verify(circuit, proof, table):
                raise AssertionError(f"GKR {what} proof on {dev} does not verify")
            jsons.append(gkr_proof_to_json(proof, ctx.name))
        if jsons[0] != jsons[1]:
            raise AssertionError(f"GKR {what}: proof JSON from the card differs from the CPU's")
        log(f"GKR parity {what} bn254_fr: CUDA proof JSON == CPU proof JSON ({len(jsons[0])} bytes), both verify")


def random_table(ctx, rng, log_n: int, device):
    """(plain [2^log_n, L] limbs on device, their sum mod p): random canonical
    BN254 Fr values made on the host from the seed."""
    from tpu_zk_torch.utils.convert import limbs_from_numpy

    limbs = rng.integers(0, 1 << 16, size=(1 << log_n, ctx.L), dtype=np.uint32)
    limbs[:, -1] &= 0x2FFF  # top limb < 0x3000 < p's (0x3064): every value < p
    want_sum = sum(int(s) << (16 * k) for k, s in enumerate(limbs.sum(axis=0, dtype=np.int64))) % ctx.p
    return limbs_from_numpy(limbs, device), want_sum


SUCCINCT_KERNELS = ("mont_mul", "fold", "addsub", "msm_buckets", "msm_bucket_reduce")


def _wrappers() -> dict:
    from tpu_zk_torch.curves import kernels as curve_kernels
    from tpu_zk_torch.fields import kernels
    from tpu_zk_torch.merkle import kernels as merkle_kernels
    from tpu_zk_torch.ntt import kernels as ntt_kernels

    return {"mont_mul": kernels.mont_mul, "fold": kernels.fold, "addsub": kernels.addsub,
            "msm_buckets": curve_kernels.msm_buckets, "msm_bucket_reduce": curve_kernels.msm_bucket_reduce,
            "keccak_rows": merkle_kernels.keccak_rows, "dif_pass": ntt_kernels.dif_pass}


def reset_launches() -> None:
    for wrapper in _wrappers().values():
        wrapper.launches = 0


def read_launches() -> dict:
    return {name: wrapper.launches for name, wrapper in _wrappers().items()}


def main_path(device, rng, log_n: int) -> dict:
    """to_mont + prove + verify of a random 2^log_n BN254 Fr table."""
    from tpu_zk_torch.fields import arith
    from tpu_zk_torch.fields.arith import field_ctx
    from tpu_zk_torch.poly.multilinear import MultilinearPolynomial
    from tpu_zk_torch.sumcheck.basic import Prover, Verifier

    ctx = field_ctx("bn254_fr")
    plain, want_sum = random_table(ctx, rng, log_n, device)

    reset_launches()
    poly, t_mont = sync_time(lambda: MultilinearPolynomial(ctx, arith.to_mont(ctx, plain)))
    proof, t_prove = sync_time(lambda: Prover(poly).prove())
    ok, t_verify = sync_time(lambda: Verifier.init().verify(proof))
    launches = read_launches()

    if not ok:
        raise AssertionError(f"2^{log_n} proof does not verify")
    if proof.initial_claimed_sum != want_sum:
        raise AssertionError(f"2^{log_n} claimed sum differs from the host's sum of the table")
    if len(proof.round_univariate_polynomials) != log_n:
        raise AssertionError("wrong number of rounds")
    for name in ("mont_mul", "fold"):  # basic sumcheck adds and subtracts nothing elementwise
        if launches[name] == 0:
            raise AssertionError(f"main path at 2^{log_n} never launched kernel {name}")
    proof.initial_claimed_sum += 1
    if Verifier.init().verify(proof):
        raise AssertionError(f"2^{log_n} proof with a tampered claim verifies")
    proof.initial_claimed_sum -= 1

    warm_proof, t_prove_warm = sync_time(lambda: Prover(poly).prove())
    ok, t_verify_warm = sync_time(lambda: Verifier.init().verify(warm_proof))
    if not ok:
        raise AssertionError(f"2^{log_n} warm proof does not verify")
    out = {
        "log_n": log_n, "to_mont_s": t_mont, "prove_first_s": t_prove, "verify_first_s": t_verify,
        "prove_warm_s": t_prove_warm, "verify_warm_s": t_verify_warm, "launches": launches,
    }
    log(f"main path 2^{log_n} bn254_fr: " + json.dumps(out))
    return out


def gkr_main_path(device, rng, depth: int) -> dict:
    """evaluate + prove + verify of tree_sum_circuit(depth) on random inputs."""
    from tpu_zk_torch.circuit.layered import tree_sum_circuit
    from tpu_zk_torch.fields import arith
    from tpu_zk_torch.fields.arith import field_ctx
    from tpu_zk_torch.gkr import sparse

    ctx = field_ctx("bn254_fr")
    plain, want_sum = random_table(ctx, rng, depth, device)
    circuit = tree_sum_circuit(ctx, depth)

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    table, t_mont = sync_time(lambda: arith.to_mont(ctx, plain))
    del plain
    ev, t_eval = sync_time(lambda: circuit.evaluate(table))
    proof, t_prove = sync_time(lambda: sparse.prove(circuit, table))
    ok, t_verify = sync_time(lambda: sparse.verify(circuit, proof, table))
    launches = read_launches()

    if not ok:
        raise AssertionError(f"GKR depth {depth} proof does not verify")
    if ev.output != [want_sum] or proof.circuit_output != [want_sum]:
        raise AssertionError(f"GKR depth {depth}: output differs from the host's sum of the inputs")
    if len(proof.sumcheck_proofs) != depth or len(proof.sumcheck_proofs[-1].round_univariate_polynomials) != 2 * depth:
        raise AssertionError(f"GKR depth {depth}: wrong number of layers or rounds")
    for name in ("mont_mul", "fold", "addsub"):  # plain GKR runs no MSM
        if launches[name] == 0:
            raise AssertionError(f"GKR main path at depth {depth} never launched kernel {name}")
    del ev
    proof.wb_evaluations[0] += 1
    if sparse.verify(circuit, proof, table):
        raise AssertionError(f"GKR depth {depth} proof with a tampered wb evaluation verifies")
    proof.wb_evaluations[0] -= 1
    coeffs = proof.sumcheck_proofs[-1].round_univariate_polynomials[3].coefficients
    coeffs[1] = (coeffs[1] + 1) % ctx.p
    if sparse.verify(circuit, proof, table):
        raise AssertionError(f"GKR depth {depth} proof with a tampered round coefficient verifies")

    _, t_eval_warm = sync_time(lambda: circuit.evaluate(table))
    warm_proof, t_prove_warm = sync_time(lambda: sparse.prove(circuit, table))
    ok, t_verify_warm = sync_time(lambda: sparse.verify(circuit, warm_proof, table))
    if not ok:
        raise AssertionError(f"GKR depth {depth} warm proof does not verify")
    out = {
        "depth": depth, "gates": (1 << depth) - 1, "to_mont_s": t_mont, "evaluate_first_s": t_eval,
        "prove_first_s": t_prove, "verify_first_s": t_verify, "evaluate_warm_s": t_eval_warm,
        "prove_warm_s": t_prove_warm, "verify_warm_s": t_verify_warm,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "launches": launches,
    }
    log(f"GKR main path depth {depth} bn254_fr: " + json.dumps(out))
    return out


HBM_BYTES_PER_S = 3.35e12  # the H100's published device-memory rate
K4_CHECK_LOG_N = 12
BLS_TIMED_LOG_N = 16  # K4 over BLS12-381 is timed at 2^16 points
PLAIN_CHUNK_UNITS = 1 << 17  # K4a's plain version over a 2^24 launch runs this many units at a time
KZG_VARS = 20  # BASELINE config 4's size; also the second succinct-GKR depth
SUCCINCT_DEPTH = 24  # this slice's full width: 2^24 inputs committed, 2^24 - 1 gates (BASELINE config 5)
MSM_LOG_NS = (20, 24)


def wide_mad_rate(device) -> float:
    """The card's wide multiply-adds per second, by csrc/probe.cu: the
    instruction the field kernels' CIOS issues, (uint64_t)a * b + c, in 8
    independent chains per thread, 2048 threads per SM.  The 32-bit form
    x * a + b is timed beside it and only logged."""
    import ctypes

    from tpu_zk_torch import _build

    lib = _build.kernel_library()
    blocks = torch.cuda.get_device_properties(device).multi_processor_count * 8
    iters = 1 << 16
    out = torch.empty(blocks * 256, dtype=torch.int32, device=device)

    def launcher(name, *consts):
        def launch():
            rc = getattr(lib, name)(ctypes.c_void_p(out.data_ptr()), blocks, iters, *consts,
                                    ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
            if rc != 0:
                raise RuntimeError(f"{name}: cudaError_t {rc}")
        return launch

    count = blocks * 256 * 8 * iters
    wide = count / (event_ms(launcher("tzk_wide_mad_probe", 0x9E3779B1), 5) / 1e3)
    narrow = count / (event_ms(launcher("tzk_imad_probe", 0x9E3779B1, 12345), 5) / 1e3)
    log(f"probe: {wide:.4e} wide (32 x 32 + 64 -> 64 bit) multiply-adds per second, "
        f"{narrow:.4e} 32-bit multiply-adds per second, ratio {narrow / wide:.3f}")
    return wide


def bound_ms(n_bytes: float, wide_mads: float, rate: float) -> tuple[float, str]:
    """The least milliseconds the card could take: the larger of the bytes
    over its memory rate and the wide multiply-adds over the probed rate."""
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S * 1e3, wide_mads / rate * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def mont_mul_wide_mads(ctx) -> int:
    """Wide multiply-adds of one CIOS product of N = L/2 32-bit limbs: N^2
    for a * b and N^2 for the reduction's m * p."""
    return 2 * (ctx.L // 2) ** 2


# Montgomery products that one complete addition needs: Algorithm 7 has 12
# products of two variables; its two by the constant b3 = 3b (9 on BN254, 12 on
# BLS12-381) are four modular additions each in csrc/ec.cuh.
EC_ADD_PRODUCTS = 12
C_SWEEP = (13, 14, 15, 16)  # window bits timed at 2^24 (the rule picks 16)
UNIT_SWEEP = (16, 32, 64, 128)  # entries a K4a thread sums (R), timed at 2^24
SEGMENT_SWEEP = (8, 16, 32, 64)  # buckets a K4b thread reduces (m), timed at 2^24
SCALAR_KINDS = ("random", "all equal", "below 2^16")


def rand_scalar_limbs(fr, n: int, rng, device) -> torch.Tensor:
    """Random canonical plain scalars [n, L]: the top limb below the modulus's."""
    from tpu_zk_torch.utils.convert import limbs_from_numpy

    limbs = rng.integers(0, 1 << 16, size=(n, fr.L), dtype=np.uint32)
    limbs[:, -1] %= fr.p >> (16 * (fr.L - 1))
    return limbs_from_numpy(limbs, device)


def unequal(ctx, P, Q) -> int:
    """How many of the points differ as group elements (exact, through K1)."""
    from tpu_zk_torch.curves.ec_device import ec_equal

    return int((~ec_equal(ctx, P, Q)).sum())


def skewed_scalars(fr, n: int, kind: str, rng, device) -> torch.Tensor:
    """Plain scalars [n, L] of one of SCALAR_KINDS."""
    s = rand_scalar_limbs(fr, n, rng, device)
    if kind == "all equal":
        s[:] = s[0].clone()
    elif kind == "below 2^16":
        s[:, 1:] = 0
    return s


def k4_passes(dc, points, scalars, c: int, unit: int, what: str, rate: float | None = None) -> dict:
    """Every K4a pass of one MSM's bucket sums, then K4b, each against its
    plain version as group elements and against a second launch limb for
    limb.  K4a's plain version runs PLAIN_CHUNK_UNITS units at a time (one
    call cannot hold a 2^24 launch's slots).  Returns the kernels' times
    (CUDA events) and their plain versions' (host clock), the adds each
    needed and, with ``rate``, the bounds."""
    from tpu_zk_torch.curves import kernels
    from tpu_zk_torch.curves import msm_pippenger as mp

    ctx = dc.ctx
    digits = mp.signed_digits(scalars, c)
    W, B = digits.shape[0], 1 << (c - 1)
    entries, counts = mp._bucket_entries(digits, c)
    del digits
    live, nonempty = int(counts.sum()), int((counts > 0).sum())
    out = {"c": c, "windows": W, "live_entries": live, "passes": [], "k4a_ms": 0.0, "k4a_plain_ms": 0.0}
    P, E, cnt = points, entries, counts
    while True:
        units, cnt = mp._unit_table(cnt, unit)
        rows = kernels.msm_buckets(ctx, dc.b3, P, E, units)
        again = kernels.msm_buckets(ctx, dc.b3, P, E, units)
        if not torch.equal(rows, again):
            raise AssertionError(f"K4a {what}: two launches on the same input differ")
        del again
        bad, plain_s = 0, 0.0
        for lo in range(0, units.shape[0], PLAIN_CHUNK_UNITS):
            part = units[lo : lo + PLAIN_CHUNK_UNITS]
            plain, dt = sync_time(lambda: kernels.msm_buckets_plain(ctx, dc.b3, P, E, part))
            plain_s += dt
            bad += unequal(ctx, kernels.rows_to_points(rows[lo : lo + PLAIN_CHUNK_UNITS]), kernels.rows_to_points(plain))
            del plain
        if bad:
            raise AssertionError(f"K4a {what}: {bad} of {units.shape[0]} unit sums differ from the plain version's")
        ms = event_ms(lambda: kernels.msm_buckets(ctx, dc.b3, P, E, units), 2)
        out["passes"].append({"units": units.shape[0], "ms": ms, "plain_ms": plain_s * 1e3})
        out["k4a_ms"] += ms
        out["k4a_plain_ms"] += plain_s * 1e3
        if rows.shape[0] == W * B:
            break
        P, E = kernels.rows_to_points(rows), None
    buckets = rows.view(W, B, 3, ctx.L)
    m = min(mp.SEGMENT, B)
    for seg in (m, 5):
        got = kernels.msm_bucket_reduce(ctx, dc.b3, buckets, seg)
        if not torch.equal(got, kernels.msm_bucket_reduce(ctx, dc.b3, buckets, seg)):
            raise AssertionError(f"K4b {what}: two launches on the same input differ")
        want, dt = sync_time(lambda: kernels.msm_bucket_reduce_plain(ctx, dc.b3, buckets, seg))
        bad = unequal(ctx, kernels.rows_to_points(got), kernels.rows_to_points(want))
        if bad:
            raise AssertionError(f"K4b {what}, segments of {seg}: {bad} segment totals differ from the plain version's")
        if seg == m:
            out.update(k4b_ms=event_ms(lambda: kernels.msm_bucket_reduce(ctx, dc.b3, buckets, m), 5),
                       k4b_plain_ms=dt * 1e3, segments=got.shape[1])
    # adds the function needs: K4a reduces the live entries to one point a nonempty bucket; K4b weighs a
    # window's B buckets, 2 adds a bucket by running sums, and carries its S segments' offsets, 2 adds a
    # segment by a second running sum over their sums (the kernel's double-and-add offsets do more)
    S = -(-B // m)
    out.update(k4a_adds=live - nonempty, k4b_adds=W * 2 * (B + S))
    if rate is not None:
        add_mads = EC_ADD_PRODUCTS * mont_mul_wide_mads(ctx)
        point_bytes = 3 * ctx.L * 4
        units_total = sum(p["units"] for p in out["passes"])
        # K4a reads each entry and its point and each later pass's partials once, writes each unit's sum once
        bytes_a = live * (4 + point_bytes) + (units_total - out["passes"][0]["units"]) * point_bytes \
            + units_total * point_bytes
        out["k4a_bound"] = bound_ms(bytes_a, out["k4a_adds"] * add_mads, rate)
        out["k4b_bound"] = bound_ms((W * B + W * S) * point_bytes, out["k4b_adds"] * add_mads, rate)
    return out


def check_k4(device, rng) -> dict:
    """Phase 12.  Returns K4a's and K4b's times beside their plain versions'
    at 2^12 BN254 points and random scalars."""
    from tpu_zk_torch.curves import ec_device, fixed_base
    from tpu_zk_torch.curves import msm_pippenger as mp
    from tpu_zk_torch.curves.ec_device import DeviceCurve

    n = 1 << K4_CHECK_LOG_N
    times = {}
    for name in ("bn254", "bls12_381"):
        dc = DeviceCurve(name, device=device)
        ctx, fr, hc = dc.ctx, dc.fr, dc.host
        r = fr.p
        # points k_i G with a duplicate, P and -P, identity points
        k = rand_scalar_limbs(fr, n, rng, device)
        k_ints = fr.to_ints(k[:64], mont=False)
        k_ints[1] = k_ints[0]
        k_ints[3] = r - k_ints[2]
        k_ints[4] = k_ints[5] = 0
        k[:64] = fr.array(k_ints, mont=False, device=device)
        table = fixed_base.host_window_table(dc, fr.L * 16)
        points = fixed_base.fixed_base_msm(ctx, dc.b3, table, fixed_base.digits4(k))
        # scalars: equal for the duplicate and for P, -P; 0, 1, r - 1, 2^256 - 1 (not reduced)
        s = rand_scalar_limbs(fr, n, rng, device)
        s[1], s[3] = s[0], s[2]
        s[6:9] = fr.array([0, 1, r - 1], mont=False, device=device)
        s[9] = 0xFFFF
        s_ints = [sum(int(v) << (16 * i) for i, v in enumerate(row)) for row in s[:64].cpu().tolist()]
        c = mp.window_bits(n)
        zero_one = torch.zeros_like(s)
        zero_one[::3, 0] = 1
        cases = [(s, c, mp.UNIT, f"edge points and scalars, c {c}"), (s, 8, 4, "edge points and scalars, c 8, units of 4"),
                 (s, 16, mp.UNIT, "edge points and scalars, c 16"), (zero_one, 2, mp.UNIT, "scalars 0 and 1, c 2"),
                 (torch.zeros_like(s), c, mp.UNIT, "all-zero scalars")]
        cases += [(skewed_scalars(fr, n, kind, rng, device), c, mp.UNIT, f"{kind} scalars, c {c}")
                  for kind in SCALAR_KINDS[1:]]
        for scalars, cc, unit, what in cases:
            run = k4_passes(dc, points, scalars, cc, unit, f"{name} 2^{K4_CHECK_LOG_N} points, {what}")
            if name == "bn254" and what.startswith("edge") and cc == c:
                times["K4a"] = {"ms": run["k4a_ms"], "plain_ms": run["k4a_plain_ms"]}
                times["K4b"] = {"ms": run["k4b_ms"], "plain_ms": run["k4b_plain_ms"]}

        whole = dc.point_to_host(mp.msm_pippenger(ctx, dc.b3, (points, s)))
        slow = dc.point_to_host(ec_device.msm(ctx, dc.b3, points, ec_device.scalar_bits(fr, s)))
        if whole is None or whole != slow:
            raise AssertionError(f"msm_pippenger {name}: differs from the double-and-add MSM")
        for few in (64, 3, 2, 1, 0):
            first = (tuple(t[:few].contiguous() for t in points), s[:few].contiguous())
            got = dc.point_to_host(mp.msm_pippenger(ctx, dc.b3, first))
            want = hc.g1_affine(hc.g1_mul(hc.g1_generator(), sum(a * b for a, b in zip(k_ints[:few], s_ints[:few])) % r))
            if got != want:
                raise AssertionError(f"msm_pippenger {name}: differs from host ints on {few} points")
        if dc.point_to_host(mp.msm_pippenger(ctx, dc.b3, (points, torch.zeros_like(s)))) is not None:
            raise AssertionError(f"msm_pippenger {name}: all-zero scalars do not give the identity")
        log(f"K4 {name}: every K4a pass and K4b equal their plain versions as group elements and a second launch "
            f"limb for limb (2^{K4_CHECK_LOG_N} points: {', '.join(w for *_, w in cases)}); msm_pippenger == "
            f"double-and-add == host ints (2^{K4_CHECK_LOG_N}, 64, 3, 2, 1 and 0 points)")
        if name == "bn254":
            for what, m in times.items():
                log(f"{what} bn254 2^{K4_CHECK_LOG_N} points, c {c}: {m['ms']:.4f} ms (plain {m['plain_ms']:.4f} ms)")
        else:  # the 12-word field's kernels at a size where they fill the card
            big = 1 << BLS_TIMED_LOG_N
            k = rand_scalar_limbs(fr, big, rng, device)
            points = fixed_base.fixed_base_msm(ctx, dc.b3, table, fixed_base.digits4(k))
            scalars = rand_scalar_limbs(fr, big, rng, device)
            _, t_msm = sync_time(lambda: mp.msm_pippenger(ctx, dc.b3, (points, scalars)))
            _, t_msm = sync_time(lambda: mp.msm_pippenger(ctx, dc.b3, (points, scalars)))
            run = k4_passes(dc, points, scalars, mp.window_bits(big), mp.UNIT, f"{name} 2^{BLS_TIMED_LOG_N} points")
            log(f"K4 {name} 2^{BLS_TIMED_LOG_N} points, c {run['c']}: K4a {run['k4a_ms']:.4f} ms over "
                f"{len(run['passes'])} passes, K4b {run['k4b_ms']:.4f} ms; msm_pippenger warm {t_msm * 1e3:.2f} ms")
    return times


def check_default_device(rng) -> None:
    """Phase 11: host ints and no device argument must reach the card."""
    from tpu_zk_torch.fields.arith import field_ctx
    from tpu_zk_torch.gkr import sparse

    ctx = field_ctx("bn254_fr")
    circuit = mixed_circuit(ctx, 5, rng)
    vals = [int.from_bytes(rng.bytes(32), "little") % ctx.p for _ in range(32)]
    reset_launches()
    proof = sparse.prove(circuit, vals)
    if not sparse.verify(circuit, proof, vals):
        raise AssertionError("the proof from host ints does not verify")
    launches = read_launches()
    if ctx.array([1]).device.type != "cuda" or not all(launches[k] > 0 for k in ("mont_mul", "fold", "addsub")):
        raise AssertionError(f"host ints with no device argument did not reach the card: launches {launches}")
    log(f"default device: a GKR proof from host ints with no device argument launched {launches}")


def check_succinct_parity(device, rng) -> None:
    """Phase 13."""
    from tpu_zk_torch.circuit.layered import Circuit, Gate, Layer
    from tpu_zk_torch.curves.params import CURVES
    from tpu_zk_torch.fields.arith import field_ctx
    from tpu_zk_torch.gkr import sparse
    from tpu_zk_torch.kzg import multilinear_kzg as kzg
    from tpu_zk_torch.kzg.trusted_setup import TrustedSetup
    from tpu_zk_torch.utils.serialize import succinct_proof_from_json, succinct_proof_to_json

    bls, bn = field_ctx("bls12_381_fr"), field_ctx("bn254_fr")
    two_layers = Circuit(bls, [Layer([Gate.mul(0, 1, 0)]), Layer([Gate.add(0, 1, 0), Gate.mul(2, 3, 1)])])
    cases = [
        ("two layers, bls12_381, taus [5, 2]", "bls12_381", two_layers, [2, 3, 4, 5], [5, 2]),
        ("mixed depth 6, bn254", "bn254", mixed_circuit(bn, 6, rng),
         [int.from_bytes(rng.bytes(32), "little") % bn.p for _ in range(64)],
         [int.from_bytes(rng.bytes(32), "little") % bn.p for _ in range(6)]),
    ]
    for what, curve, circuit, vals, taus in cases:
        field = circuit.ctx.name
        reset_launches()
        setup = TrustedSetup.initialize_setup(curve, taus)  # no device argument: the card
        proof = sparse.prove_succinct(circuit, vals, setup)
        launches = read_launches()
        if not all(launches[k] > 0 for k in ("msm_buckets", "msm_bucket_reduce", "mont_mul", "fold", "addsub")):
            raise AssertionError(f"succinct parity {what}: the card side skipped a kernel: {launches}")
        card_json = succinct_proof_to_json(proof, field)
        if not sparse.verify_succinct(circuit, succinct_proof_from_json(card_json), setup):
            raise AssertionError(f"succinct parity {what}: the card's proof does not verify")
        cpu_setup = TrustedSetup.initialize_setup(curve, taus, device="cpu")
        cpu_proof = sparse.prove_succinct(circuit, vals, cpu_setup)
        if not sparse.verify_succinct(circuit, cpu_proof, cpu_setup):
            raise AssertionError(f"succinct parity {what}: the CPU's proof does not verify")
        if succinct_proof_to_json(cpu_proof, field) != card_json:
            raise AssertionError(f"succinct parity {what}: proof JSON from the card differs from the CPU's")

        n = len(taus)
        rb = proof.sumcheck_proofs[-1].random_challenges[:n]
        c, opening = proof.input_polynomial_commitment, proof.input_rb_proof
        if not kzg.verify(setup, c, rb, opening):
            raise AssertionError(f"succinct parity {what}: the rb opening does not verify")
        wrong_value = kzg.MultilinearKZGProof(opening.evaluation + 1, list(opening.proofs))
        wrong_point = kzg.MultilinearKZGProof(opening.evaluation, [CURVES[curve]["g1"]] + list(opening.proofs[1:]))
        if (kzg.verify(setup, c, rb, wrong_value) or kzg.verify(setup, c, rb, wrong_point)
                or kzg.verify(setup, c, [rb[0] + 1] + rb[1:], opening)):
            raise AssertionError(f"succinct parity {what}: the pairing check accepts a tampered opening")
        log(f"succinct parity {what}: CUDA proof JSON == CPU proof JSON ({len(card_json)} bytes), both verify; "
            f"tampered evaluation, quotient point and opening point rejected; launches {launches}")


def timed_setup(device, n_vars: int, seed: int):
    """(setup with its folded bases, taus, times) for BN254, on the default
    device (the card), the stages timed by the breakdown's timers."""
    from tpu_zk_torch.gkr import breakdown
    from tpu_zk_torch.kzg.trusted_setup import TrustedSetup, generate_values_for_tau

    taus = generate_values_for_tau("bn254", n_vars, seed=seed)

    def make():
        setup = TrustedSetup.initialize_setup("bn254", taus)
        setup.folded_g1_bases()
        return setup

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    setup, stages, _, _ = breakdown.staged(make, device, breakdown.SUCCINCT_STAGES)
    torch.cuda.synchronize()
    times = {"n_vars": n_vars, "setup_s": time.perf_counter() - t0, "setup_stages_s": stages}
    log(f"setup bn254 {n_vars} variables: " + json.dumps(times))
    return setup, taus, times


def kzg_alone(device, rng, setup) -> dict:
    """Phase 14: commit, open, verify of a random 2^20 BN254 Fr table."""
    from tpu_zk_torch.fields import arith
    from tpu_zk_torch.fields.arith import field_ctx
    from tpu_zk_torch.kzg import multilinear_kzg as kzg
    from tpu_zk_torch.poly.multilinear import MultilinearPolynomial

    ctx = field_ctx("bn254_fr")
    n = setup.num_vars
    plain, _ = random_table(ctx, rng, n, device)
    poly = MultilinearPolynomial(ctx, arith.to_mont(ctx, plain))
    point = [int.from_bytes(rng.bytes(32), "little") % ctx.p for _ in range(n)]
    reset_launches()
    commitment, t_commit = sync_time(lambda: kzg.commit_to_polynomial(poly, setup))
    proof, t_open = sync_time(lambda: kzg.open_and_prove(poly, setup, point))
    launches = read_launches()
    pairs, t_points = sync_time(lambda: kzg.pairing_pairs(setup, commitment, point, proof))
    ok, t_pairing = sync_time(lambda: kzg.pairing_product_is_one("bn254", pairs))
    if not ok or not kzg.verify(setup, commitment, point, proof):
        raise AssertionError(f"KZG at {n} variables: the opening does not verify")
    if proof.evaluation != poly.evaluate(point) or len(proof.proofs) != n:
        raise AssertionError(f"KZG at {n} variables: wrong evaluation or number of quotient points")
    if kzg.verify(setup, commitment, point, kzg.MultilinearKZGProof(proof.evaluation + 1, proof.proofs)):
        raise AssertionError(f"KZG at {n} variables: a tampered evaluation verifies")
    if launches["msm_buckets"] == 0 or launches["msm_bucket_reduce"] == 0:
        raise AssertionError(f"KZG at {n} variables never launched K4: {launches}")
    _, t_commit_warm = sync_time(lambda: kzg.commit_to_polynomial(poly, setup))
    _, t_open_warm = sync_time(lambda: kzg.open_and_prove(poly, setup, point))
    out = {"n_vars": n, "commit_first_s": t_commit, "open_first_s": t_open, "commit_warm_s": t_commit_warm,
           "open_warm_s": t_open_warm, "verify_host_points_s": t_points, "verify_pairing_s": t_pairing,
           "launches": launches}
    log(f"KZG alone bn254 {n} variables: " + json.dumps(out))
    return out


def msm_stages(dc, points, scalars, c: int, unit: int | None = None, segment: int | None = None) -> dict:
    """One msm_pippenger, stage by stage, synchronized at each boundary:
    seconds of digits, sort, bucket sums (unit tables and K4a passes of
    ``unit`` entries, default UNIT), K4b (segments of ``segment``, default
    SEGMENT), window sums (K4a passes) and the host combine; the result
    point."""
    from tpu_zk_torch.curves import msm_pippenger as mp

    unit, segment = unit or mp.UNIT, segment or mp.SEGMENT
    ctx, b3 = dc.ctx, dc.b3
    out = {}
    digits, out["digits_s"] = sync_time(lambda: mp.signed_digits(scalars, c))
    W, B = digits.shape[0], 1 << (c - 1)
    (entries, counts), out["sort_s"] = sync_time(lambda: mp._bucket_entries(digits, c))
    del digits
    buckets, out["bucket_sums_s"] = sync_time(lambda: mp._sum_groups(ctx, b3, points, entries, counts, unit))
    del entries
    segments, out["k4b_s"] = sync_time(
        lambda: mp.msm_bucket_reduce(ctx, b3, buckets.view(W, B, 3, ctx.L), min(segment, B)))
    windows, out["window_sums_s"] = sync_time(lambda: mp._window_sums(ctx, b3, segments))
    out["point"], out["combine_s"] = sync_time(lambda: mp._combine_windows(ctx, b3, windows, c))
    return out


def msm_alone(device, rng, setup, taus, rate: float) -> dict:
    """Phase 15.  Returns the runs and K4a's and K4b's rows at 2^24."""
    from tpu_zk_torch.curves import msm_pippenger as mp
    from tpu_zk_torch.fields import arith
    from tpu_zk_torch.kzg.trusted_setup import compute_lagrange_basis_device

    dc = setup.curve
    ctx, fr, hc = dc.ctx, dc.fr, dc.host
    multipliers = compute_lagrange_basis_device(fr, taus, device=device)  # powers[i] = multipliers[i] G
    out = {"runs": [], "kernels": {}, "c_sweep": [], "unit_sweep": [], "segment_sweep": []}

    def expected(n, s):
        k = fr.to_ints(arith.sum_mod(fr, arith.mont_mul(fr, multipliers[:n], arith.to_mont(fr, s))))
        return hc.g1_affine(hc.g1_mul(hc.g1_generator(), k))

    for log_n in MSM_LOG_NS:
        n = 1 << log_n
        points = tuple(t[:n] for t in setup.g1_powers_of_tau)
        c = mp.window_bits(n)
        for kind in SCALAR_KINDS:
            s = skewed_scalars(fr, n, kind, rng, device)
            reset_launches()
            got, t_first = sync_time(lambda: mp.msm_pippenger(ctx, dc.b3, (points, s)))
            launches = read_launches()
            _, t_warm = sync_time(lambda: mp.msm_pippenger(ctx, dc.b3, (points, s)))
            want = expected(n, s)
            if dc.point_to_host(got) != want:
                raise AssertionError(f"MSM 2^{log_n}, {kind} scalars: the result is not (sum s_i a_i) G")
            if launches["msm_buckets"] < 2 or launches["msm_bucket_reduce"] != 1:
                raise AssertionError(f"MSM 2^{log_n}: expected K4a passes and one K4b launch, got {launches}")
            stages = msm_stages(dc, points, s, c)
            if dc.point_to_host(stages.pop("point")) != want:
                raise AssertionError(f"MSM 2^{log_n}, {kind} scalars: the staged run differs")
            run = {"log_n": log_n, "scalars": kind, "c": c, "first_s": t_first, "warm_s": t_warm,
                   "points_per_s_warm": n / t_warm, "launches": launches, "stages_s": stages}
            out["runs"].append(run)
            log(f"MSM alone bn254 2^{log_n}: " + json.dumps(run))
            if kind == "random":
                # every bucket of the launch, each pass, and K4b against the plain versions
                k4 = k4_passes(dc, points, s, c, mp.UNIT, f"MSM 2^{log_n}", rate)
                log(f"MSM alone 2^{log_n}: every K4a pass ({[p['units'] for p in k4['passes']]} units) and K4b "
                    f"({k4['segments']} segments a window) equal their plain versions: " + json.dumps(k4))
                out["k4"] = {**out.get("k4", {}), log_n: k4}
            if log_n == max(MSM_LOG_NS) and kind == "random":
                shape = f"{n} points, c {c}: {len(k4['passes'])} K4a passes over {k4['live_entries']} entries"
                out["kernels"]["K4a"] = {"ms": k4["k4a_ms"], "plain_ms": k4["k4a_plain_ms"], "bound": k4["k4a_bound"],
                                         "max_abs_err": 0, "shape": shape, "passes": k4["passes"]}
                out["kernels"]["K4b"] = {"ms": k4["k4b_ms"], "plain_ms": k4["k4b_plain_ms"], "bound": k4["k4b_bound"],
                                         "max_abs_err": 0,
                                         "shape": f"{k4['windows']} windows x {k4['segments']} segments of {mp.SEGMENT}"}
                for key, row in (("k4a", "K4a"), ("k4b", "K4b")):  # the same at the smaller MSM
                    out["kernels"][row].update({
                        f"at_2^{m}": {"ms": other[f"{key}_ms"], "plain_ms": other[f"{key}_plain_ms"],
                                      "bound_ms": other[f"{key}_bound"][0]}
                        for m, other in out["k4"].items() if m != log_n})
                for key, sweep, stages in (("unit", UNIT_SWEEP, ("bucket_sums_s",)),
                                           ("segment", SEGMENT_SWEEP, ("k4b_s", "window_sums_s"))):
                    for size in sweep:  # the better of two runs, each checked
                        runs = [msm_stages(dc, points, s, c, **{key: size}) for _ in range(2)]
                        if any(dc.point_to_host(r.pop("point")) != want for r in runs):
                            raise AssertionError(f"MSM 2^{log_n} with {key} {size}: the result is not (sum s_i a_i) G")
                        out[f"{key}_sweep"].append({key: size, **{k: min(r[k] for r in runs) for k in stages}})
                        log(f"MSM 2^{log_n} {key} sweep: " + json.dumps(out[f"{key}_sweep"][-1]))
                for cc in C_SWEEP:
                    _, t = sync_time(lambda: mp.msm_pippenger(ctx, dc.b3, (points, s), c=cc))
                    swept = msm_stages(dc, points, s, cc)
                    swept.pop("point")
                    out["c_sweep"].append({"c": cc, "warm_s": t, "stages_s": swept})
                    log(f"MSM 2^{log_n} c sweep: " + json.dumps(out["c_sweep"][-1]))
            del s
    return out


def succinct_main_path(device, rng, setup, setup_times: dict) -> dict:
    """Phases 14 and 16: prove_succinct, to JSON, verify_succinct of
    tree_sum_circuit(setup.num_vars) on random inputs, first call and warm,
    then once under the stage timers."""
    from tpu_zk_torch.circuit.layered import tree_sum_circuit
    from tpu_zk_torch.curves import ec_device
    from tpu_zk_torch.fields import arith
    from tpu_zk_torch.fields.arith import field_ctx
    from tpu_zk_torch.gkr import breakdown, sparse
    from tpu_zk_torch.utils.serialize import succinct_proof_from_json, succinct_proof_to_json

    ctx = field_ctx("bn254_fr")
    depth = setup.num_vars
    plain, want_sum = random_table(ctx, rng, depth, device)
    circuit = tree_sum_circuit(ctx, depth)
    table = arith.to_mont(ctx, plain)
    del plain

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    double_and_add = []
    saved_msm = ec_device.msm
    ec_device.msm = lambda *a, **k: double_and_add.append(1) or saved_msm(*a, **k)
    try:
        proof, t_prove = sync_time(lambda: sparse.prove_succinct(circuit, table, setup))
    finally:
        ec_device.msm = saved_msm
    proof_json, t_json = sync_time(lambda: succinct_proof_to_json(proof, ctx.name))
    received = succinct_proof_from_json(proof_json)
    ok, t_verify = sync_time(lambda: sparse.verify_succinct(circuit, received, setup))
    launches = read_launches()

    if not ok:
        raise AssertionError(f"succinct GKR depth {depth}: the proof does not verify")
    if proof.circuit_output != [want_sum]:
        raise AssertionError(f"succinct GKR depth {depth}: output differs from the host's sum of the inputs")
    if (len(proof.sumcheck_proofs) != depth or len(proof.input_rb_proof.proofs) != depth
            or len(proof.input_rc_proof.proofs) != depth or proof.input_polynomial_commitment is None):
        raise AssertionError(f"succinct GKR depth {depth}: wrong number of layers or quotient points")
    for name in SUCCINCT_KERNELS:
        if launches[name] == 0:
            raise AssertionError(f"succinct GKR main path at depth {depth} never launched kernel {name}")
    if double_and_add:
        raise AssertionError(f"succinct GKR depth {depth}: {len(double_and_add)} double-and-add MSMs ran")
    for what, change in (("wb evaluation", lambda q: q.wb_evaluations.__setitem__(0, q.wb_evaluations[0] + 1)),
                         ("KZG evaluation", lambda q: setattr(q.input_rb_proof, "evaluation", q.input_rb_proof.evaluation + 1)),
                         ("quotient point", lambda q: q.input_rc_proof.proofs.__setitem__(0, q.input_polynomial_commitment))):
        tampered = succinct_proof_from_json(proof_json)
        change(tampered)
        if sparse.verify_succinct(circuit, tampered, setup):
            raise AssertionError(f"succinct GKR depth {depth}: a proof with a tampered {what} verifies")

    warm, t_prove_warm = sync_time(lambda: sparse.prove_succinct(circuit, table, setup))
    ok, t_verify_warm = sync_time(lambda: sparse.verify_succinct(circuit, warm, setup))
    if not ok or succinct_proof_to_json(warm, ctx.name) != proof_json:
        raise AssertionError(f"succinct GKR depth {depth}: the warm proof differs or does not verify")
    peak = torch.cuda.max_memory_allocated() / 2**30
    del warm
    (_, prove_stages, prove_calls, prove_each), t_prove_timers = sync_time(
        lambda: breakdown.staged(lambda: sparse.prove_succinct(circuit, table, setup), device, breakdown.SUCCINCT_STAGES))
    (_, verify_stages, _, _), t_verify_timers = sync_time(
        lambda: breakdown.staged(lambda: sparse.verify_succinct(circuit, received, setup), device,
                                 breakdown.SUCCINCT_STAGES))
    out = {
        "depth": depth, "gates": (1 << depth) - 1, **setup_times, "prove_first_s": t_prove, "to_json_s": t_json,
        "proof_json_bytes": len(proof_json), "verify_first_s": t_verify, "prove_warm_s": t_prove_warm,
        "verify_warm_s": t_verify_warm, "peak_mem_gib": peak, "launches": launches,
        "prove_with_timers_s": t_prove_timers, "prove_whole_s": breakdown.whole_s(prove_each), "prove_stages_s": prove_stages,
        "prove_stage_calls": prove_calls,
        "verify_with_timers_s": t_verify_timers, "verify_stages_s": verify_stages,
    }
    log(f"succinct GKR main path depth {depth} bn254: " + json.dumps(out))
    return out


def measure(out: dict, what: str, kernel_fn, plain_fn) -> None:
    """out[what] = max |kernel - plain| over every output and both mean times
    (ms).  The outputs must be equal: a kernel wrong at a timed shape fails
    the run."""
    got, want = kernel_fn(), plain_fn()
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        check_equal(what, g, w)
    err = max(max_err(g, w) for g, w in zip(got, want))
    del got, want
    out[what] = {"max_abs_err": err, "ms": event_ms(kernel_fn, 20), "plain_ms": event_ms(plain_fn, 3)}


def kernel_times(device, gen) -> dict:
    """Each kernel and its plain version at the basic sumcheck's 2^24 shapes
    and at the first round of a depth-24 GKR layer (working set
    [2, 2, 2^24, 16], so T = 2^23 pairs per factor table)."""
    from tpu_zk_torch.fields import kernels
    from tpu_zk_torch.fields.arith import field_ctx

    ctx = field_ctx("bn254_fr")
    N, L = 1 << MAIN_LOG_N, ctx.L
    out = {}
    table = rand_canonical(ctx, (N,), gen, device)
    r = rand_canonical(ctx, (), gen, device)
    r2 = ctx.limbs(ctx.R2, device)  # to_mont's broadcast operand
    measure(out, "K1 sumcheck 2^24 x broadcast", lambda: kernels.mont_mul(ctx, table, r2),
            lambda: kernels.mont_mul_plain(ctx, table, r2))
    flat = table.view(1, N, L)  # fold_and_half_sums' 2^24 -> 2^23 round, block 1024
    measure(out, "K2 sumcheck B=1 2^24 -> 2^23", lambda: kernels.fold(ctx, flat, r, 1024),
            lambda: kernels.fold_plain(ctx, flat, r, 1024))
    del table, flat

    stacked = rand_canonical(ctx, (4, N), gen, device)  # [p*k, 2T, L]
    lo = stacked[:, : N // 2].reshape(-1, L)  # the round's contiguous copies, 2^25 elements
    hi = stacked[:, N // 2 :].reshape(-1, L)
    measure(out, "K3 GKR sub hi - lo 2^25", lambda: kernels.addsub(ctx, hi, lo, "sub"),
            lambda: kernels.sub_plain(ctx, hi, lo))
    measure(out, "K3 GKR add 2^25", lambda: kernels.addsub(ctx, hi, lo, "add"),
            lambda: kernels.add_plain(ctx, hi, lo))
    w = stacked[0]  # w(c) + w(b*), the phase-2 build's broadcast add over 2^24
    measure(out, "K3 GKR add 2^24 + broadcast", lambda: kernels.addsub(ctx, w, r, "add"),
            lambda: kernels.add_plain(ctx, w, r))
    a, b = lo[: N], hi[: N]  # the collapse products of one sample point: p*T = 2^24 pairs
    measure(out, "K1 GKR collapse 2^24 pairs", lambda: kernels.mont_mul(ctx, a, b),
            lambda: kernels.mont_mul_plain(ctx, a, b))
    del lo, hi, a, b
    measure(out, "K2 GKR B=4 2^24 -> 2^23", lambda: kernels.fold(ctx, stacked, r, 1024),
            lambda: kernels.fold_plain(ctx, stacked, r, 1024))
    for what, m in out.items():
        log(f"{what}: {m['ms']:.4f} ms (plain {m['plain_ms']:.4f} ms), max |diff| {m['max_abs_err']}")
    return out


def kernels_line(times: dict, launches: dict, k4_small: dict, k4_main: dict, k56: dict, rate: float) -> list[dict]:
    """The {"kernels": [...]} rows.  K1-K3: times at a depth-24 GKR round's
    shapes, the basic sumcheck's beside them.  K4a, K4b: times at the 2^24
    MSM's shape (K4a: its bucket passes added up, its plain version run
    PLAIN_CHUNK_UNITS units at a time, one call cannot hold its slots);
    both kernels' times at 2^12 points beside them.  K5, K6: time per launch over one 2^24-leaf tree and
    one 2^24 forward transform.  ``launches`` is the depth-24 succinct
    path's count for K1-K4 and the 2^24 NTT -> FRI path's for K5 and K6;
    every path's count is beside it.  No PyTorch call computes any of these
    functions, so ``library_ms`` is null."""
    from tpu_zk_torch.fields.arith import field_ctx

    ctx = field_ctx("bn254_fr")
    elem = ctx.L * 4  # bytes of one element in the tensors' 16-bit-limb layout
    N = 1 << MAIN_LOG_N
    mul = mont_mul_wide_mads(ctx)
    # (bytes moved, wide multiply-adds) at each row's shape
    work = {
        "mont_mul": (3 * N * elem, N * mul),  # 2^24 pairs in, 2^24 out
        "fold": (4 * (N + N // 2) * elem, 4 * (N // 2) * mul),  # [4, 2^24, 16] in, [4, 2^23, 16] out
        "addsub": (3 * 2 * N * elem, 0),  # [2^25, 16] twice in, once out; adds with carry only
    }
    rows = []
    for name, key, replaces, gkr, sumcheck in (
        ("mont_mul", "K1", "tpu_zk/fields/pallas_kernels.py:142, tpu_zk/fields/pallas_kernels.py:270",
         "K1 GKR collapse 2^24 pairs", "K1 sumcheck 2^24 x broadcast"),
        ("fold", "K2", "tpu_zk/fields/mxu_mul.py:296, tpu_zk/fields/pallas_kernels.py:222",
         "K2 GKR B=4 2^24 -> 2^23", "K2 sumcheck B=1 2^24 -> 2^23"),
        ("addsub", "K3", "tpu_zk/fields/pallas_kernels.py:176, tpu_zk/fields/pallas_kernels.py:294",
         "K3 GKR sub hi - lo 2^25", None),
    ):
        mine = {k: v for k, v in times.items() if k.startswith(key)}
        least, by = bound_ms(*work[name], rate)
        row = {"name": name, "route": "cuda", "source": "tpu_zk_torch/csrc/kernels.cu", "replaces": replaces,
               "launches": launches["succinct"][name], "launches_by_path": {p: n[name] for p, n in launches.items()},
               "max_abs_err": max(m["max_abs_err"] for m in mine.values()), "ms": times[gkr]["ms"],
               "plain_ms": times[gkr]["plain_ms"], "bound_ms": least, "bound_by": by, "library_ms": None, "shape": gkr}
        if sumcheck:
            row.update(sumcheck_shape=sumcheck, sumcheck_ms=times[sumcheck]["ms"],
                       sumcheck_plain_ms=times[sumcheck]["plain_ms"])
        rows.append(row)
    for name, key, replaces in (
        ("msm_buckets", "K4a", "tpu_zk/curves/ec_pallas.py:114, tpu_zk/curves/ec_pallas.py:273"),
        ("msm_bucket_reduce", "K4b", "tpu_zk/curves/ec_pallas.py:273"),
    ):
        main_shape = k4_main[key]
        rows.append({"name": name, "route": "cuda", "source": "tpu_zk_torch/csrc/msm.cu", "replaces": replaces,
                     "launches": launches["succinct"][name], "launches_by_path": {p: n[name] for p, n in launches.items()},
                     "max_abs_err": main_shape["max_abs_err"], "ms": main_shape["ms"],
                     "plain_ms": main_shape["plain_ms"], "bound_ms": main_shape["bound"][0],
                     "bound_by": main_shape["bound"][1], "library_ms": None, "shape": main_shape["shape"],
                     "small_shape": f"2^{K4_CHECK_LOG_N} points", "small_ms": k4_small[key]["ms"],
                     "small_plain_ms": k4_small[key]["plain_ms"],
                     "max_abs_err_is": "points unequal to the plain version's as group elements",
                     **{k: v for k, v in main_shape.items() if k == "passes" or k.startswith("at_2^")}})
    for name, key, source, replaces in (
        ("keccak_rows", "K5", "tpu_zk_torch/csrc/keccak.cu", "tpu_zk/merkle/device_merkle.py:81"),
        ("dif_pass", "K6", "tpu_zk_torch/csrc/ntt.cu", "tpu_zk/ntt/sixstep.py:112, tpu_zk/fields/mxu_mul.py:405"),
    ):
        row = dict(k56[key])
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": launches["fri"][name], "launches_by_path": {p: n[name] for p, n in launches.items()},
                     "library_ms": None, **row})
    return rows


# ---------------------------------------------------------------------------
# phases 17-21: the NTT -> Merkle-committed FRI path (K5, K6)
# ---------------------------------------------------------------------------

NTT_LOG_NS = (24, 20)  # the main path's table size, then BASELINE config 2's
FRI_LOG_NS = (24, 18)  # a 2^24 low-degree-extension domain, then BASELINE config 3's
FRI_PARITY_LOG_N = 10
POLY_LOG_N = 20  # polynomial_multiply of two degree-2^19 - 1 polynomials
HORNER_POINTS = 32
K5_WIDTHS = (0, 1, 32, 64, 135)
K5_ROWS = (1, 3, 1000, 65537, 1 << 22)
# K6 blocks (A, m, C): every radix the plans use (2^8 at 2^24, 2^10 at 2^20, 2^9 at 2^18), the small ones
# of the tests, ragged column counts
K6_SHAPES = ((1, 256, 4096), (3, 256, 5), (2, 512, 129), (1, 1024, 64), (5, 1024, 1), (7, 1, 3), (1, 2, 1000),
             (4, 8, 33))


def keccak_ops(w: int) -> int:
    """The 32-bit logic and shift instructions that one Keccak-256 of a
    w-byte row needs at least (csrc/keccak.cu's count), each 64-bit lane two
    32-bit halves: a full round is 180 (theta's column parities 20 and
    rot1 10 by funnel shifts, its application A ^ C[x-1] ^ rot1(C[x+1]) one
    three-input op a half, 50; rho 48 funnel shifts, chi 50, iota 2).  The
    first round is cheaper where the padded block leaves lanes zero, and the
    last computes only the four lanes of the digest."""
    from tpu_zk_torch.transcript.keccak import _RC, _ROT

    src = {y + 5 * ((2 * x + 3 * y) % 5): (x + 5 * y, _ROT[x][y]) for x in range(5) for y in range(5)}  # pi
    block = [any(8 * k + b in (w, 135) or 8 * k + b < w for b in range(8)) for k in range(25)]
    total = 0
    for rnd in range(24):
        nz = block if rnd == 0 else [True] * 25  # lanes that may be nonzero
        outs = range(4) if rnd == 23 else range(25)
        needed = {5 * (i // 5) + (i % 5 + d) % 5 for i in outs for d in range(3)}  # chi's inputs
        col = [sum(nz[x + 5 * y] for y in range(5)) for x in range(5)]
        ops = sum(2 * (k // 2) for k in col) + sum(2 for k in col if k)  # parities; rot1 of each
        d_terms = [(col[(x + 4) % 5] > 0) + (col[(x + 1) % 5] > 0) for x in range(5)]
        theta_nz, shared_d = {}, set()
        for b in needed:
            lane, rot = src[b]
            x = lane % 5
            if nz[lane]:
                ops += 2 if d_terms[x] else 0
            elif d_terms[x] == 2:
                shared_d.add(x)  # D[x] made once for the column's zero lanes
            theta_nz[b] = nz[lane] or d_terms[x] > 0
            ops += 2 if rot and theta_nz[b] else 0
        ops += 2 * len(shared_d)
        ops += sum(2 for i in outs if theta_nz[5 * (i // 5) + (i % 5 + 2) % 5])  # chi: nothing to do when c is 0
        rc = int(_RC[rnd])
        total += ops + ((rc & 0xFFFFFFFF) != 0) + ((rc >> 32) != 0)
    return total


def k6_products(ctx, plan) -> int:
    """The Montgomery products that one transform of ``plan`` needs: each
    butterfly's hi = (u - v) w except where w = w^0 = 1 (slot 0 of each
    group of each stage: m - 1 of a column's m/2 log2 m), each pre-twiddle
    that is not 1 (counted on the plan's tables) and the inverse's scale."""
    one = ctx.one_mont(plan.device)
    n = 0
    for m, pre in zip(plan.ms, plan.pres):
        n += plan.N // m * (m // 2 * (m.bit_length() - 1) - (m - 1))
        if pre is not None:
            n += int((pre != one).any(-1).sum())
    return n + (plan.N if plan.scale is not None else 0)


def logic_rate(device) -> float:
    """The card's 32-bit funnel shifts and logic ops per second, by
    csrc/probe.cu: the instructions of K5's permutation."""
    import ctypes

    from tpu_zk_torch import _build

    lib = _build.kernel_library()
    blocks = torch.cuda.get_device_properties(device).multi_processor_count * 8
    iters = 1 << 16
    out = torch.empty(blocks * 256, dtype=torch.int32, device=device)

    def launch():
        rc = lib.tzk_logic_probe(ctypes.c_void_p(out.data_ptr()), blocks, iters, 7, 0x9E3779B1,
                                 ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if rc != 0:
            raise RuntimeError(f"tzk_logic_probe: cudaError_t {rc}")

    rate = blocks * 256 * 16 * iters / (event_ms(launch, 5) / 1e3)
    log(f"probe: {rate:.4e} 32-bit funnel shifts and logic ops per second")
    return rate


def check_k6(device, gen) -> None:
    """Phase 17: K6 against its plain version, bit-exact, both Fr fields."""
    from tpu_zk_torch.fields.arith import field_ctx
    from tpu_zk_torch.ntt import kernels
    from tpu_zk_torch.ntt.sixstep import SixStepPlan

    cases = 0
    for name in ("bn254_fr", "bls12_381_fr"):
        ctx = field_ctx(name)
        for A, m, C in K6_SHAPES:
            log_m = m.bit_length() - 1
            root = pow(5, (ctx.p - 1) >> log_m, ctx.p)  # an m-th root of unity (any one will do)
            tws = SixStepPlan(name, log_m, root, device=device).tws[0]
            x, pre = rand_canonical(ctx, (A, m, C), gen, device), rand_canonical(ctx, (A, m, C), gen, device)
            scale = rand_canonical(ctx, (), gen, device)
            dst = torch.randperm(A * m * C, generator=gen, device=device)
            for what, args in (("", ()), (" pre", (pre,)), (" pre scale", (pre, scale)), (" scale", (None, scale)),
                               (" pre scale dst", (pre, scale, dst))):
                check_equal(f"K6 {name} [{A}, {m}, {C}]{what}", kernels.dif_pass(ctx, x, tws, *args),
                            kernels.dif_pass_plain(ctx, x, tws, *args))
                cases += 1
    log(f"K6: {cases} cases bit-exact (both Fr fields; radix 1 to 2^10; pre-twiddle, scale, natural-order store; "
        f"ragged column counts)")


def check_k5(device, gen) -> None:
    """Phase 18: K5 against its plain version, bit-exact."""
    from tpu_zk_torch.merkle import kernels

    for w in K5_WIDTHS:
        for n in K5_ROWS:
            rows = torch.randint(0, 256, (n, w), generator=gen, device=device, dtype=torch.uint8)
            check_equal(f"K5 w={w} N={n}", kernels.keccak_rows(rows), kernels.keccak_rows_plain(rows))
    flat = torch.randint(0, 256, (1001 * 64,), generator=gen, device=device, dtype=torch.uint8)
    for offset in (8, 1):  # rows 8 bytes into a 16-byte line (8-byte loads), and 1 byte (byte loads)
        rows = flat[offset : offset + 999 * 64].view(999, 64)
        check_equal(f"K5 rows at byte offset {offset}", kernels.keccak_rows(rows), kernels.keccak_rows_plain(rows))
    log(f"K5: widths {K5_WIDTHS} x rows {K5_ROWS}, and rows at byte offsets 8 and 1, bit-exact")


def horner(coeffs: list, x: int, p: int) -> int:
    """coeffs(x) mod p on host ints: Horner in blocks of 1024 coefficients,
    each block one dot product with the powers of x."""
    import operator

    block = 1024
    powers = [1] * block
    for i in range(1, block):
        powers[i] = powers[i - 1] * x % p
    step = powers[-1] * x % p
    acc = 0
    for start in range((len(coeffs) - 1) // block * block, -1, -block):
        acc = (acc * step + sum(map(operator.mul, coeffs[start : start + block], powers))) % p
    return acc


def ntt_path(device, gen, rng) -> dict:
    """Phase 19: NTT.forward/inverse at 2^24 and 2^20, polynomial_multiply at
    2^20; K6 must launch."""
    from tpu_zk_torch.fields.arith import field_ctx
    from tpu_zk_torch.ntt.ntt import NTT, polynomial_multiply

    ctx = field_ctx("bn254_fr")
    out = {"runs": []}
    reset_launches()
    for log_n in NTT_LOG_NS:
        t = NTT("bn254_fr", log_n, device=device)
        table = rand_canonical(ctx, (1 << log_n,), gen, device)
        torch.cuda.reset_peak_memory_stats()
        fwd, t_fwd = sync_time(lambda: t.forward(table))
        back, t_inv = sync_time(lambda: t.inverse(fwd))
        if not torch.equal(back, table):
            raise AssertionError(f"NTT 2^{log_n}: inverse(forward(x)) != x")
        del back
        _, t_fwd_warm = sync_time(lambda: t.forward(table))
        _, t_inv_warm = sync_time(lambda: t.inverse(fwd))
        run = {"log_n": log_n, "passes": t.plan(False, table.device).ms, "forward_first_s": t_fwd,
               "inverse_first_s": t_inv, "forward_warm_s": t_fwd_warm, "inverse_warm_s": t_inv_warm,
               "forward_warm_ms_events": event_ms(lambda: t.forward(table), 5),
               "inverse_warm_ms_events": event_ms(lambda: t.inverse(fwd), 5),
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
        if log_n == min(NTT_LOG_NS):
            if not torch.equal(fwd, t.forward_stagewise(table)):
                raise AssertionError(f"NTT 2^{log_n}: the multi-pass forward differs from the stage-at-a-time oracle")
            if not torch.equal(t.inverse(fwd), t.inverse_stagewise(fwd)):
                raise AssertionError(f"NTT 2^{log_n}: the multi-pass inverse differs from the stage-at-a-time oracle")
            run["equals_stagewise"] = True
        out["runs"].append(run)
        log(f"NTT bn254_fr 2^{log_n}: " + json.dumps(run))
        del t, table, fwd

    half = 1 << (POLY_LOG_N - 1)
    a = [int.from_bytes(rng.bytes(32), "little") % ctx.p for _ in range(half)]
    b = [int.from_bytes(rng.bytes(32), "little") % ctx.p for _ in range(half)]
    c, t_mul = sync_time(lambda: polynomial_multiply("bn254_fr", a, b))  # host ints, no device: the card
    if len(c) != 2 * half - 1:
        raise AssertionError("polynomial_multiply: wrong product length")
    t0 = time.perf_counter()
    for _ in range(HORNER_POINTS):
        x = int.from_bytes(rng.bytes(32), "little") % ctx.p
        if horner(a, x, ctx.p) * horner(b, x, ctx.p) % ctx.p != horner(c, x, ctx.p):
            raise AssertionError(f"polynomial_multiply: the product differs from a(x) b(x) at x = {x}")
    t_horner = time.perf_counter() - t0
    out["launches"] = read_launches()
    out["polynomial_multiply"] = {"degree": half - 1, "s": t_mul, "horner_points": HORNER_POINTS,
                                  "horner_s": t_horner}
    if out["launches"]["dif_pass"] == 0 or out["launches"]["mont_mul"] == 0:
        raise AssertionError(f"NTT path never launched K6 or K1: {out['launches']}")
    log(f"polynomial_multiply bn254_fr degree 2^{POLY_LOG_N - 1} - 1 (host ints in and out): {t_mul:.3f} s; equals "
        f"a(x) b(x) at {HORNER_POINTS} random points (Horner on host ints, {t_horner:.1f} s); NTT path launches "
        + json.dumps(out["launches"]))
    return out


def fri_stages() -> list:
    """(owner, attribute, stage): the stage timers of the NTT -> FRI path."""
    from tpu_zk_torch.fri import fri
    from tpu_zk_torch.ntt.sixstep import SixStepPlan
    from tpu_zk_torch.transcript.fiat_shamir import Transcript

    return [
        (SixStepPlan, "__call__", "NTT (K6 passes)"),
        (fri, "field_leaf_bytes", "leaf bytes (from_mont K1, byte order)"),
        (fri, "merkle_tree_flat", "Merkle levels (K5)"),
        (fri, "fold_codeword", "fold (K1, K3)"),
        (Transcript, "append", "host transcript (absorb)"),
        (Transcript, "sample_random_challenge", "host transcript (squeeze)"),
        (fri, "_gather_openings", "query gathers and copy"),
        (fri, "verify_path", "verify: host Merkle paths"),
    ]


def fri_codeword(ctx, log_n: int, gen, device):
    """The NTT of a polynomial of degree < 2^(log_n - 2): random coefficients
    at 2^24, ``bench_fri``'s own table (limb 0 of coefficient i is
    i mod 65521, as Montgomery limbs) otherwise."""
    from tpu_zk_torch.fields import arith
    from tpu_zk_torch.ntt.ntt import NTT

    n, deg = 1 << log_n, 1 << (log_n - 2)
    if log_n == max(FRI_LOG_NS):
        coeffs = torch.zeros((n, ctx.L), dtype=torch.int32, device=device)
        coeffs[:deg] = arith.to_mont(ctx, rand_canonical(ctx, (deg,), gen, device))
    else:
        coeffs = torch.zeros((n, ctx.L), dtype=torch.int32, device=device)
        coeffs[:deg, 0] = torch.arange(deg, device=device, dtype=torch.int32) % 65521
    return NTT(ctx.name, log_n, device=device).forward(coeffs)


def fri_parity(device, gen) -> None:
    """The proof from the card equals the CPU's (plain versions) at 2^10."""
    from tpu_zk_torch.fri import fri
    from tpu_zk_torch.ntt.ntt import NTT
    from tpu_zk_torch.transcript.fiat_shamir import Transcript

    cfg = fri.FriConfig("bn254_fr", FRI_PARITY_LOG_N, final_size_log2=4, num_queries=20, blowup_log2=2)
    n = 1 << FRI_PARITY_LOG_N
    coeffs = torch.zeros((n, cfg.ctx.L), dtype=torch.int32, device=device)
    coeffs[: n >> 2] = rand_canonical(cfg.ctx, (n >> 2,), gen, device)
    proofs = []
    for dev in (device, torch.device("cpu")):
        codeword = NTT("bn254_fr", FRI_PARITY_LOG_N, device=dev).forward(coeffs.to(dev))
        proof = fri.prove(cfg, codeword, Transcript())
        if not fri.verify(cfg, proof, Transcript()):
            raise AssertionError(f"FRI parity 2^{FRI_PARITY_LOG_N}: the proof on {dev} does not verify")
        proofs.append(proof)
    if proofs[0] != proofs[1]:
        raise AssertionError(f"FRI parity 2^{FRI_PARITY_LOG_N}: the proof from the card differs from the CPU's")
    log(f"FRI parity 2^{FRI_PARITY_LOG_N} bn254_fr: CUDA proof == CPU proof (roots, final codeword, every query), "
        "both verify")


def _tampered(proof, how: str):
    import copy

    proof = copy.deepcopy(proof)
    if how == "final codeword":
        proof.final_codeword[0] += 1
    elif how == "query value":
        proof.queries[0][0].value_lo += 1
    else:  # a Merkle sibling
        path = proof.queries[0][1].path_hi
        path[2] = bytes([path[2][0] ^ 1]) + path[2][1:]
    return proof


def fri_path(device, gen, log_n: int) -> dict:
    """Phase 20: NTT of a low-degree polynomial, fri.prove, fri.verify,
    first call and warm, then once under the stage timers (K5's Merkle
    levels round by round among them); tampered proofs and a high-degree
    codeword fail; K5 and K6 must launch."""
    from tpu_zk_torch.fields.arith import field_ctx
    from tpu_zk_torch.fri import fri
    from tpu_zk_torch.gkr import breakdown
    from tpu_zk_torch.transcript.fiat_shamir import Transcript

    ctx = field_ctx("bn254_fr")
    cfg = fri.FriConfig("bn254_fr", log_n, final_size_log2=4, num_queries=20, blowup_log2=2)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    codeword, t_ntt = sync_time(lambda: fri_codeword(ctx, log_n, gen, device))
    proof, t_prove = sync_time(lambda: fri.prove(cfg, codeword, Transcript()))
    ok, t_verify = sync_time(lambda: fri.verify(cfg, proof, Transcript()))
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not ok:
        raise AssertionError(f"FRI 2^{log_n}: the proof does not verify")
    if len(proof.roots) != cfg.num_rounds or len(proof.queries) != 20 or len(proof.final_codeword) != 16:
        raise AssertionError(f"FRI 2^{log_n}: wrong number of rounds, queries or final values")
    for name in ("dif_pass", "keccak_rows", "mont_mul", "addsub"):
        if launches[name] == 0:
            raise AssertionError(f"FRI path at 2^{log_n} never launched kernel {name}: {launches}")
    for how in ("final codeword", "query value", "Merkle sibling"):
        if fri.verify(cfg, _tampered(proof, how), Transcript()):
            raise AssertionError(f"FRI 2^{log_n}: a proof with a tampered {how} verifies")
    warm, t_prove_warm = sync_time(lambda: fri.prove(cfg, codeword, Transcript()))
    ok, t_verify_warm = sync_time(lambda: fri.verify(cfg, warm, Transcript()))
    if not ok or warm != proof:
        raise AssertionError(f"FRI 2^{log_n}: the warm proof differs or does not verify")
    del warm
    noise = rand_canonical(ctx, (1 << log_n,), gen, device)  # random evaluations: degree far above 2^(log_n - 2)
    if fri.verify(cfg, fri.prove(cfg, noise, Transcript()), Transcript()):
        raise AssertionError(f"FRI 2^{log_n}: random evaluations pass the low-degree test")
    del noise
    (_, stages, calls, each), t_timed = sync_time(lambda: breakdown.staged(
        lambda: fri.verify(cfg, fri.prove(cfg, fri_codeword(ctx, log_n, gen, device), Transcript()), Transcript()),
        device, fri_stages()))
    out = {"log_n": log_n, "rounds": cfg.num_rounds, "ntt_s": t_ntt, "prove_first_s": t_prove,
           "verify_first_s": t_verify, "prove_warm_s": t_prove_warm, "verify_warm_s": t_verify_warm,
           "peak_mem_gib": peak, "launches": launches, "ntt_prove_verify_with_timers_s": t_timed,
           "stages_s": stages, "stage_calls": calls,
           "merkle_levels_s_by_round": each["Merkle levels (K5)"]}
    log(f"FRI path bn254_fr 2^{log_n}: " + json.dumps(out) + "; tampered final codeword, query value and Merkle "
        "sibling rejected; random evaluations rejected")
    return out


def k56_times(device, gen, rate: float, lrate: float) -> dict:
    """Phase 21: K6 over the three passes of one 2^24 forward and K5 over one
    2^24-leaf tree (the FRI path's largest), beside their plain versions
    and bounds, all per launch."""
    import math

    from tpu_zk_torch.fields.arith import field_ctx
    from tpu_zk_torch.merkle import kernels as mk
    from tpu_zk_torch.merkle.device_merkle import merkle_tree_flat
    from tpu_zk_torch.ntt import kernels as nk
    from tpu_zk_torch.ntt.ntt import NTT

    ctx = field_ctx("bn254_fr")
    log_n = max(FRI_LOG_NS)
    N, L, elem = 1 << log_n, ctx.L, ctx.L * 4
    plan = NTT("bn254_fr", log_n, device=device).plan(False, device)
    table = rand_canonical(ctx, (N,), gen, device)
    R = len(plan.ms)
    views = [table.view(math.prod(plan.ms[:i]), m, math.prod(plan.ms[i + 1 :]), L) for i, m in enumerate(plan.ms)]
    args = [(plan.tws[i], plan.pres[i]) + ((None, plan.dst) if i == R - 1 else ()) for i in range(R)]
    k6_err = 0
    for i in range(R):
        got, want = nk.dif_pass(ctx, views[i], *args[i]), nk.dif_pass_plain(ctx, views[i], *args[i])
        k6_err = max(k6_err, max_err(got, want))
        check_equal(f"K6 2^{log_n} pass {i}", got, want)
        del got, want
    passes_ms = [event_ms(lambda i=i: nk.dif_pass(ctx, views[i], *args[i]), 10) for i in range(R)]
    plain_ms = event_ms(lambda: [nk.dif_pass_plain(ctx, views[i], *args[i]) for i in range(R)], 1)
    products = k6_products(ctx, plan)
    n_bytes = sum(2 * N * elem + (N * elem if i else 0) for i in range(R)) + N * 8
    least, by = bound_ms(n_bytes, products * mont_mul_wide_mads(ctx), rate)
    k6 = {"ms": sum(passes_ms) / R, "passes_ms": passes_ms, "plain_ms": plain_ms / R, "bound_ms": least / R,
          "bound_by": by, "max_abs_err": k6_err, "shape": f"one 2^{log_n} forward: {R} passes of radix {plan.ms}"}
    del table, views, args, plan

    leaves = torch.randint(0, 256, (N, 32), generator=gen, device=device, dtype=torch.uint8)
    tree = merkle_tree_flat(leaves)
    levels = log_n + 1
    tree_ms = event_ms(lambda: merkle_tree_flat(leaves), 10)

    def plain_tree():
        flat = torch.empty_like(tree)
        flat[:N] = mk.keccak_rows_plain(leaves)
        off, width = 0, N
        while width > 1:
            flat[off + width : off + width + width // 2] = mk.keccak_rows_plain(flat[off : off + width].view(-1, 64))
            off, width = off + width, width // 2
        return flat

    want = plain_tree()
    k5_err = max_err(tree, want)
    check_equal(f"K5 2^{log_n}-leaf tree", tree, want)
    del want
    plain_tree_ms = event_ms(plain_tree, 1)
    hashes = 2 * N - 1
    by_bytes = (N * 32 + (N - 1) * 64 + hashes * 32) / HBM_BYTES_PER_S * 1e3
    by_ops = (N * keccak_ops(32) + (N - 1) * keccak_ops(64)) / lrate * 1e3
    least, by = (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")
    k5 = {"ms": tree_ms / levels, "tree_ms": tree_ms, "plain_ms": plain_tree_ms / levels, "bound_ms": least / levels,
          "bound_by": by, "max_abs_err": k5_err, "shape": f"one 2^{log_n}-leaf tree: {levels} launches, {hashes} hashes",
          "leaf_level_ms": event_ms(lambda: mk.keccak_rows(leaves, out=tree[:N]), 10)}
    log(f"K6 2^{log_n} forward: passes {passes_ms} ms (plain {plain_ms:.1f} ms in all), bound {k6['bound_ms'] * R:.4f} ms "
        f"({by}); K5 2^{log_n}-leaf tree {tree_ms:.4f} ms (leaf level {k5['leaf_level_ms']:.4f} ms; plain "
        f"{plain_tree_ms:.1f} ms), bound {least:.4f} ms ({k5['bound_by']})")
    return {"K5": k5, "K6": k6}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    t_script = time.perf_counter()
    # 1. the card
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60)
    log(smi.stdout.strip())
    device = torch.device("cuda:0")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # 2. build
    from tpu_zk_torch import _build

    t0 = time.perf_counter()
    _build.kernel_library()
    t1 = time.perf_counter()
    _build.keccak_library()
    t2 = time.perf_counter()
    _build.pairing_library()
    log(f"build: kernels {t1 - t0:.2f} s, keccak {t2 - t1:.2f} s, pairing {time.perf_counter() - t2:.2f} s")
    log("ptxas: " + json.dumps(_build.resource_usage()))
    rate = wide_mad_rate(device)
    lrate = logic_rate(device)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    rng = np.random.default_rng(args.seed)
    check_k1(device, gen)  # 3
    check_k2(device, gen)  # 4
    check_k3(device, gen)  # 5
    check_transcript_golden(device)  # 6
    check_slice_parity(device, rng)  # 7
    check_gkr_parity(device, rng)
    sumcheck_runs = [main_path(device, rng, MAIN_LOG_N), main_path(device, rng, BENCH_LOG_N)]  # 8
    gkr_runs = [gkr_main_path(device, rng, depth) for depth in GKR_DEPTHS]  # 9
    times = kernel_times(device, gen)  # 10
    check_default_device(rng)  # 11
    k4_small = check_k4(device, rng)  # 12
    check_succinct_parity(device, rng)  # 13

    setup, _, setup_times = timed_setup(device, KZG_VARS, args.seed)  # 14
    kzg_alone(device, rng, setup)
    succinct_main_path(device, rng, setup, setup_times)
    del setup
    setup, taus, setup_times = timed_setup(device, SUCCINCT_DEPTH, args.seed)
    k4_main = msm_alone(device, rng, setup, taus, rate)  # 15
    succinct_run = succinct_main_path(device, rng, setup, setup_times)  # 16
    del setup

    t_new = time.perf_counter()
    check_k6(device, gen)  # 17
    check_k5(device, gen)  # 18
    ntt_run = ntt_path(device, gen, rng)  # 19
    fri_parity(device, gen)  # 20
    fri_runs = [fri_path(device, gen, log_n) for log_n in FRI_LOG_NS]
    k56 = k56_times(device, gen, rate, lrate)  # 21
    log(f"phases 17-21 (NTT, Merkle, FRI): {time.perf_counter() - t_new:.1f} s; "
        f"whole script so far {time.perf_counter() - t_script:.1f} s")
    launches = {"sumcheck": sumcheck_runs[0]["launches"], "gkr": gkr_runs[0]["launches"],
                "succinct": succinct_run["launches"], "ntt": ntt_run["launches"], "fri": fri_runs[0]["launches"]}

    log(json.dumps({"kernels": kernels_line(times, launches, k4_small, k4_main["kernels"], k56, rate)}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
