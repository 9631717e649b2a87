#!/usr/bin/env python3
"""Run tpu_zk_torch's basic sumcheck and GKR on one CUDA card and check its kernels.

    python3 chip_smoke.py [--seed S]

Phases, in order; any failure raises and the exit code is nonzero:

1. require a CUDA card; print ``nvidia-smi``'s name and power limit;
2. build the kernels (nvcc, sm_90a) and the host Keccak, timed;
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
   version's.

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


def reset_launches() -> None:
    from tpu_zk_torch.fields import kernels

    kernels.mont_mul.launches = kernels.fold.launches = kernels.addsub.launches = 0


def read_launches() -> dict:
    from tpu_zk_torch.fields import kernels

    return {"mont_mul": kernels.mont_mul.launches, "fold": kernels.fold.launches, "addsub": kernels.addsub.launches}


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
    for name, n in launches.items():
        if n == 0:
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


def kernels_line(times: dict, launches: dict) -> list[dict]:
    """The {"kernels": [...]} rows: times at the GKR round's shapes, the
    basic sumcheck's beside them; launches from the depth-24 GKR path."""
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
        row = {"name": name, "route": "cuda", "source": "tpu_zk_torch/csrc/kernels.cu", "replaces": replaces,
               "launches": launches["gkr"][name], "launches_by_path": {p: n[name] for p, n in launches.items()},
               "max_abs_err": max(m["max_abs_err"] for m in mine.values()), "ms": times[gkr]["ms"],
               "plain_ms": times[gkr]["plain_ms"], "shape": gkr}
        if sumcheck:
            row.update(sumcheck_shape=sumcheck, sumcheck_ms=times[sumcheck]["ms"],
                       sumcheck_plain_ms=times[sumcheck]["plain_ms"])
        rows.append(row)
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

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
    log(f"build: kernels {t1 - t0:.2f} s, keccak {time.perf_counter() - t1:.2f} s")

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
    launches = {"sumcheck": sumcheck_runs[0]["launches"], "gkr": gkr_runs[0]["launches"]}

    log(json.dumps({"kernels": kernels_line(times, launches)}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
