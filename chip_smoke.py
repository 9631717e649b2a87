#!/usr/bin/env python3
"""Run tpu_zk_torch's basic sumcheck on one CUDA card and check its kernels.

    python3 chip_smoke.py [--seed S]

Phases, in order; any failure raises and the exit code is nonzero:

1. require a CUDA card; print ``nvidia-smi``'s name and power limit;
2. build the kernels (nvcc, sm_90a) and the host Keccak, timed;
3. K1 (Montgomery multiply) against its plain version, bit-exact, all four
   fields: 2^20 random elements, every pair of edge values, a broadcast scalar;
4. K2 (fold + block sums) against its plain version, bit-exact: batch rows
   B in {1, 4}, T from 1 to 2^23 with ragged block tails, r in {0, 1, p-1,
   random} (random only, above 2^16 pairs);
5. the transcript golden: the first challenge for [0, 0, 3, 8] over BN254 Fq,
   computed by hand;
6. slice parity at 2^12 over BN254 Fr: the proof JSON from the card equals
   the one from the CPU (plain versions), and both verify;
7. the main path over BN254 Fr at 2^24 (then at 2^20): ``to_mont`` of a random
   table, ``Prover.prove`` and ``Verifier.verify``, first call and warm; a
   tampered claim must fail; both kernels' launch counts must have risen;
8. each kernel's time at the main path's shapes beside its plain version's.

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


def main_path(device, rng, log_n: int) -> dict:
    """to_mont + prove + verify of a random 2^log_n BN254 Fr table."""
    from tpu_zk_torch.fields import arith, kernels
    from tpu_zk_torch.fields.arith import field_ctx
    from tpu_zk_torch.poly.multilinear import MultilinearPolynomial
    from tpu_zk_torch.sumcheck.basic import Prover, Verifier
    from tpu_zk_torch.utils.convert import limbs_from_numpy

    ctx = field_ctx("bn254_fr")
    N = 1 << log_n
    limbs = rng.integers(0, 1 << 16, size=(N, ctx.L), dtype=np.uint32)
    limbs[:, -1] &= 0x2FFF  # top limb < 0x3000 < p's (0x3064): every value < p
    want_sum = sum(int(s) << (16 * k) for k, s in enumerate(limbs.sum(axis=0, dtype=np.int64))) % ctx.p
    plain = limbs_from_numpy(limbs, device)
    del limbs

    kernels.mont_mul.launches = kernels.fold.launches = 0
    poly, t_mont = sync_time(lambda: MultilinearPolynomial(ctx, arith.to_mont(ctx, plain)))
    proof, t_prove = sync_time(lambda: Prover(poly).prove())
    ok, t_verify = sync_time(lambda: Verifier.init().verify(proof))
    launches = {"mont_mul": kernels.mont_mul.launches, "fold": kernels.fold.launches}

    if not ok:
        raise AssertionError(f"2^{log_n} proof does not verify")
    if proof.initial_claimed_sum != want_sum:
        raise AssertionError(f"2^{log_n} claimed sum differs from the host's sum of the table")
    if len(proof.round_univariate_polynomials) != log_n:
        raise AssertionError("wrong number of rounds")
    for name, n in launches.items():
        if n == 0:
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


def kernel_times(device, gen) -> list[dict]:
    """Each kernel and its plain version at the main path's 2^24 shapes."""
    from tpu_zk_torch.fields import kernels
    from tpu_zk_torch.fields.arith import field_ctx

    ctx = field_ctx("bn254_fr")
    N = 1 << MAIN_LOG_N
    table = rand_canonical(ctx, (N,), gen, device)
    r2 = ctx.limbs(ctx.R2, device)  # to_mont's broadcast operand
    k1 = kernels.mont_mul(ctx, table, r2)
    k1_err = max_err(k1, kernels.mont_mul_plain(ctx, table, r2))
    del k1
    k1_ms = event_ms(lambda: kernels.mont_mul(ctx, table, r2), 20)
    k1_plain_ms = event_ms(lambda: kernels.mont_mul_plain(ctx, table, r2), 3)

    flat = table.view(1, N, ctx.L)
    r = rand_canonical(ctx, (), gen, device)
    block = 1024  # fold_and_half_sums' block for a 2^24 -> 2^23 round
    (f_k, s_k), (f_p, s_p) = kernels.fold(ctx, flat, r, block), kernels.fold_plain(ctx, flat, r, block)
    k2_err = max(max_err(f_k, f_p), max_err(s_k, s_p))
    del f_k, s_k, f_p, s_p
    k2_ms = event_ms(lambda: kernels.fold(ctx, flat, r, block), 20)
    k2_plain_ms = event_ms(lambda: kernels.fold_plain(ctx, flat, r, block), 3)
    log(f"K1 2^24 x broadcast: {k1_ms:.4f} ms (plain {k1_plain_ms:.4f} ms); "
        f"K2 2^24 -> 2^23: {k2_ms:.4f} ms (plain {k2_plain_ms:.4f} ms)")
    return [
        {"name": "mont_mul", "route": "cuda", "source": "tpu_zk_torch/csrc/kernels.cu",
         "replaces": "tpu_zk/fields/pallas_kernels.py:142", "max_abs_err": k1_err, "ms": k1_ms,
         "plain_ms": k1_plain_ms},
        {"name": "fold", "route": "cuda", "source": "tpu_zk_torch/csrc/kernels.cu",
         "replaces": "tpu_zk/fields/mxu_mul.py:296", "max_abs_err": k2_err, "ms": k2_ms,
         "plain_ms": k2_plain_ms},
    ]


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
    check_transcript_golden(device)  # 5
    check_slice_parity(device, rng)  # 6
    main_runs = [main_path(device, rng, MAIN_LOG_N), main_path(device, rng, BENCH_LOG_N)]  # 7
    kernels_line = kernel_times(device, gen)  # 8
    for k in kernels_line:
        k["launches"] = main_runs[0]["launches"][k["name"]]

    log(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
