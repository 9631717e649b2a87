#!/usr/bin/env python3
"""Run tpu_zk_torch's basic sumcheck, GKR, MSM, KZG, succinct GKR, NTT, FRI, dense GKR, device sponge, checkpoints and sharded paths (in one process and in two) on one CUDA card and check its kernels.

    python3 chip_smoke.py [--seed S]

Phases, in order; any failure raises and the exit code is nonzero:

1. require a CUDA card; print ``nvidia-smi``'s name and power limit;
2. build the kernels (one nvcc per source, side by side, sm_90a), the host
   Keccak and the host pairing engine, timed; print each kernel's registers
   and spills as ptxas reported them (K7's among them); time a launch of
   an empty kernel (csrc/probe.cu), and the latency of one dependent logic
   op (one thread's chain, K7's bound), and read the SM clock; probe the card's rates of wide
   (32 x 32 + 64 -> 64 bit) and of 32-bit multiply-adds, the two units of
   the field kernels' operation bounds (each bound takes the cheaper), and
   of 32-bit funnel shifts and logic ops, K5's; run field.cuh's even/odd
   product mont_mul_eo beside mont_mul in one probe kernel, all four
   fields, both equal to K1's plain version, and time both;
3. K1 (Montgomery multiply) against its plain version, bit-exact, all four
   fields: 2^20 random elements, every pair of edge values, a broadcast scalar,
   and the non-canonical first operands R - 1 (2^256 - 1) and p times R^2;
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
   ``to_mont`` of a random table, ``Prover.prove`` (fused, the default) and
   ``Verifier.verify``, first call and warm; a tampered claim must fail; K1
   and K2 must launch, K7 once a round; ``prove(fused=False)`` gives the same
   proof and transcript; a warm fused prove's round loop runs under
   ``torch.cuda.set_sync_debug_mode("error")``; each path's host syncs
   (the debug mode's warnings, by the place that synced) and times; at
   2^24 a warm fused prove with K7's round form and one with each round
   made of from_mont, the pack and K7's byte form give the same proof, K7
   once a round in each, and K1 exactly one launch fewer a round with the
   round form (:func:`round_form_against_byte_form`, also in phases 9, 16,
   22 and 24), both timed;
9. the GKR main path over BN254 Fr, ``tree_sum_circuit`` of depth 24
   (2^24 random inputs, 2^24 - 1 gates), then depth 20: ``Circuit.evaluate``,
   ``sparse.prove`` and ``sparse.verify``, first call and warm; the output
   must equal the host's sum of the inputs; a tampered wb evaluation and a
   tampered round coefficient must fail; K1, K2 and K3 must launch, K7 once
   a round; a ``fused=False`` prove gives the same JSON; the warm fused
   prove's sumcheck phases run under the "error" sync debug mode; each
   path's host syncs, by place, and times; at depth 24 K7's round form
   against its byte form, as in phase 8;
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
   stage timers; K1-K4 must launch, K7 once a round, and no double-and-add
   MSM run; tampered proofs fail; a ``fused=False`` prove gives the same JSON;
   each path's host syncs and times; K7's round form against its byte
   form, as in phase 8;
17. K6 (NTT pass) against its plain version, bit-exact, both Fr fields, at
   every radix the plans use and small ones, the plans' last passes (C = 1),
   with and without pre-twiddle, scale and natural-order store, ragged column
   counts, and random values in the unread tws[:, 0] and tws[1:];
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
   evaluations; K5 and K6 must launch, and K7 (the commit rounds' device
   sponge) exactly once a round; a warm prove's host syncs counted by
   place, each commit round under the sync debug mode "error", and none
   may lie in ``fri.prove``'s commit loop;
21. K6 over the three passes of a 2^24 forward and K5 over a 2^24-leaf tree,
   beside their plain versions and bounds (multiply-adds and 32-bit
   logic/shift ops at the rates probed in phase 2): K6's time a pass, the
   products it made (counted by its threads) against ``k6_products``, and
   its share of the bound;
22. the dense GKR pipeline over BN254 Fr (``gkr/protocol.py``,
   ``gkr/succinct.py``): the proof JSON from the card equals the CPU's on a
   depth-4 mixed circuit, and the dense succinct JSON on the BLS12-381
   two-layer circuit of phase 13; ``tree_sum_circuit`` of depth 9 (512
   inputs, 511 gates; layer 8's wiring pair holds 2^26 entries, 8 GiB, the
   most an 80 GB card can fold at the next depth's 64 GiB):
   ``Circuit.evaluate``, ``protocol.prove`` and ``protocol.verify``, first
   call and warm, then under ``gkr/breakdown.py``'s dense stage timers; a
   host-synced prove (the GKR sumcheck with ``fused=False``) of the same
   JSON, each path's host syncs and times; K7 once a round, and its round
   form against its byte form as in phase 8; the
   output must equal the host's sum, the proof JSON ``sparse.prove``'s, a
   tampered wb evaluation and round coefficient must fail, K1-K3 must
   launch; the depth-9 tree of alternating ADD/MUL gates, its JSON equal
   to ``sparse.prove``'s; dense ``prove_succinct``/``verify_succinct`` at
   depth 9 (a 9-variable setup from the seed's taus), its JSON equal to
   ``sparse.prove_succinct``'s, a tampered KZG evaluation failing, K4a and
   K4b launching and no double-and-add MSM; the interactive sumcheck over
   2^20 entries, every round accepted, the oracle check true, a tampered
   claim rejected;
23. K7 (the device sponge) against its plain versions, bit-exact: its byte
   form over 10^4 random steps chained on one sponge (k <= 300 bytes, a
   squeeze with its challenge or none, from ``--seed``), every step's
   state, tail, fill level, digest and challenge; its round form over 1,536
   rounds chained on one sponge (2 Montgomery elements big-endian, 3 or 4
   little-endian, random below p, each round after a byte-form step that
   brings it to fill level i % 136, so rounds start at every level), every
   round's state, tail, fill level, plain slot, digest and challenge;
   ``digest_to_mont`` of 2^256 - 1 and p; both forms' time a launch,
   through the wrapper and with the ctypes arguments made once, at a basic
   round (64 bytes) and a GKR round (96 bytes), beside their plain
   versions', the round made as before the round form, the bound and the
   empty launch; the 2^24 basic
   sumcheck checkpointed after round 12 and the depth-20 sparse GKR after
   layer 10, loaded and finished to the uninterrupted proofs; the field
   counters over one 2^20 prove; ``roofline.render_markdown`` over phase 10's
   and 21's kernels;
24. every sharded path of ``tpu_zk_torch/parallel`` over a mesh of 4 shards,
   all on the one card, at the full sizes of the one-device phases, each
   output held against the one-device output of its phase (phases 8, 9, 15,
   19 and 20 keep their 2^24 inputs on the host for it): the basic
   sumcheck at 2^24 (K2 on every shard each round down to one row a shard),
   GKR on ``tree_sum_circuit(24)`` (K7 once a round, K2 on every shard each
   sharded round; K7's round form against its byte form, as in phase 8),
   the MSM of 2^24 points and of 2^24 - 3 (K4a's passes and
   K4b on every shard), the NTT at 2^24 (K6 once a pass on every shard),
   the Merkle tree of the 2^24 FRI codeword (K5 a level on every shard, then
   the top two levels) and FRI at 2^24, blowup 4 (K7 once a round); each
   path's first and warm time beside the one-device time, its peak memory
   and launches; then ``dryrun_multichip(4)`` on the card; each input is
   written to a temporary directory (np.save) and each output's digest
   kept (sha256 of the proof's claimed sum and univariates, of the GKR
   proof JSON, of the NTT output's bytes and the input's, of the Merkle
   root and of the FRI proof; the MSMs' affine points);
25. the same paths in a process group of two (torch.multiprocessing's
   spawn, ``init_distributed("file://...", 2, rank, backend="gloo")``:
   NCCL refuses two ranks on one card), each process holding 2 of the 4
   shards on the card (``make_mesh(4, ["cuda:0"])``), loading the kernels
   phase 2 built and phase 24's inputs: the basic sumcheck at 2^24, GKR on
   ``tree_sum_circuit(24)``, the MSM of 2^24 and 2^24 - 3 points, the NTT at
   2^24 forward and inverse, the Merkle tree and FRI at 2^24, then
   ``dryrun_multichip(4)`` over the group; every output of each process,
   first call and warm, equal to phase 24's (the MSM as a group element)
   and to the other's; each process's first and warm time, peak memory,
   launches, bytes sent across the group and seconds inside its
   collectives beside phase 24's times; a probe of gloo's transport (the
   card's copies to and from pageable and pinned host memory, and gloo's
   collectives on 512 MiB).  A process that raises fails the script at
   once, and so does the group's timeout or the join's.

The next-to-last line is ``{"kernels": [...]}``, the last line
``{"ok": true, "device": {...}}``.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import hashlib
import inspect
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

from tpu_zk_torch.utils.roofline import EC_ADD_PRODUCTS, HBM_BYTES_PER_S, bound_ms, mont_mul_wide_mads, ops_ms

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


def count_syncs(fn):
    """(fn(), host syncs during it): torch's sync debug mode set to "warn"
    while fn runs and its warnings counted, as a Counter of the places (file
    and line of the Python call that synced; the repo's files relative to
    its root) with the syncs at each; an empty Counter if none was seen."""
    root = os.path.dirname(os.path.abspath(__file__))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    places = collections.Counter()
    for w in caught:
        if "synchroniz" in str(w.message):
            rel = os.path.relpath(w.filename, root)
            places[f"{os.path.basename(w.filename) if rel.startswith('..') else rel}:{w.lineno}"] += 1
    return out, places


def sync_report(**runs: collections.Counter) -> dict:
    """The host syncs of each prove given (``fused=``, ``host_synced=``, ...):
    their totals, and each place that synced with its count, most first."""
    return {"host_syncs_a_prove": {what: c.total() for what, c in runs.items()},
            "host_sync_places": {what: dict(c.most_common()) for what, c in runs.items()}}


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
        # non-canonical first operands below R, as a digest is in digest_to_mont: R - 1 (2^256 - 1 on the
        # 256-bit fields) and p, times R^2 -> (a mod p) R
        big = torch.tensor([[0xFFFF] * ctx.L, [(ctx.p >> (16 * i)) & 0xFFFF for i in range(ctx.L)]], dtype=torch.int32,
                           device=device)
        r2 = ctx.limbs(ctx.R2, device)
        got = kernels.mont_mul(ctx, big, r2)
        check_equal(f"K1 {name} R - 1 and p times R^2", got, kernels.mont_mul_plain(ctx, big, r2))
        if ctx.to_ints(got) != [((1 << (16 * ctx.L)) - 1) % ctx.p, 0]:
            raise AssertionError(f"K1 {name}: (R - 1) R^2 and p R^2 do not reduce mod p")
        log(f"K1 {name}: 2^20 random, 16 edge pairs, 5 broadcast scalars, R - 1 and p times R^2 bit-exact")


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
    from tpu_zk_torch.transcript import kernels as transcript_kernels

    return {"mont_mul": kernels.mont_mul, "fold": kernels.fold, "addsub": kernels.addsub,
            "msm_buckets": curve_kernels.msm_buckets, "msm_bucket_reduce": curve_kernels.msm_bucket_reduce,
            "keccak_rows": merkle_kernels.keccak_rows, "dif_pass": ntt_kernels.dif_pass,
            "sponge_step": transcript_kernels.sponge_step, "sponge_round": transcript_kernels.sponge_round}


def k7_launches(launches: dict) -> int:
    """K7's launches in either form (both launch csrc/sponge.cu's one kernel)."""
    return launches["sponge_step"] + launches["sponge_round"]


@contextlib.contextmanager
def byte_form_rounds():
    """While the block runs, each fused round's transcript step is made as it
    was before K7's round form: from_mont (K1) into the round's slot, the
    byte pack and K7's byte form, in the fused provers and in the sharded
    GKR prover."""
    from tpu_zk_torch.fields import arith
    from tpu_zk_torch.parallel import sharded_gkr
    from tpu_zk_torch.sumcheck import fused
    from tpu_zk_torch.transcript import kernels as tk

    def step(state, buf, pos, mont, slot, digest, challenge, ctx, big_endian):
        slot.copy_(arith.from_mont(ctx, mont))
        tk.sponge_step(state, buf, pos, (tk.pack_bytes_be if big_endian else tk.pack_bytes_le)(ctx, slot), digest,
                       challenge, ctx)

    saved = fused.sponge_round, sharded_gkr.sponge_round
    fused.sponge_round = sharded_gkr.sponge_round = step
    try:
        yield
    finally:
        fused.sponge_round, sharded_gkr.sponge_round = saved


def round_form_against_byte_form(what: str, prove, rounds: int, same) -> dict:
    """A warm fused prove as it runs (K7's round form), then one with the
    byte form's rounds (:func:`byte_form_rounds`): the same proof
    (``same(a, b)``); K7 once a round in each, all in the round form in the
    first and all in the byte form in the second; K1 exactly one launch
    fewer a round in the first.  Both proves' K1 launches and times."""
    reset_launches()
    got, t_round = sync_time(prove)
    by_round = read_launches()
    with byte_form_rounds():
        reset_launches()
        old, t_byte = sync_time(prove)
        by_byte = read_launches()
    if not same(got, old):
        raise AssertionError(f"{what}: the proofs with K7's round form and with its byte form differ")
    del got, old
    if (by_round["sponge_round"], by_round["sponge_step"], by_byte["sponge_round"], by_byte["sponge_step"]) != (
            rounds, 0, 0, rounds):
        raise AssertionError(f"{what}: K7 launched {by_round['sponge_round']} + {by_round['sponge_step']} times "
                             f"(round + byte form), then {by_byte['sponge_round']} + {by_byte['sponge_step']} with "
                             f"the byte form's rounds; {rounds} rounds")
    if by_byte["mont_mul"] - by_round["mont_mul"] != rounds:
        raise AssertionError(f"{what}: K1 launched {by_round['mont_mul']} times with K7's round form and "
                             f"{by_byte['mont_mul']} with its byte form, not one fewer a round ({rounds})")
    out = {"rounds": rounds, "k7_launches": by_round["sponge_round"], "k1_launches": by_round["mont_mul"],
           "k1_launches_byte_form": by_byte["mont_mul"], "k3_launches": by_round["addsub"], "prove_s": t_round,
           "prove_byte_form_s": t_byte}
    log(f"{what}, K7's round form against its byte form: " + json.dumps(out))
    return out


def reset_launches() -> None:
    for wrapper in _wrappers().values():
        wrapper.launches = 0


def read_launches() -> dict:
    return {name: wrapper.launches for name, wrapper in _wrappers().items()}


@contextlib.contextmanager
def sync_error_in(owner, name: str):
    """Every call of ``owner.<name>`` (a fused round loop, a FRI commit round)
    runs under torch.cuda.set_sync_debug_mode("error"), so a host sync
    inside it raises; the mode before it comes back after each call (a
    "warn" count around the prove goes on outside)."""
    saved = getattr(owner, name)

    def strict(*args):
        before = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return saved(*args)
        finally:
            torch.cuda.set_sync_debug_mode(before)

    setattr(owner, name, strict)
    try:
        yield
    finally:
        setattr(owner, name, saved)


def same_sumcheck_proofs(a, b) -> bool:
    return (a.initial_claimed_sum == b.initial_claimed_sum
            and [u.to_ints() for u in a.round_univariate_polynomials] == [u.to_ints() for u in b.round_univariate_polynomials])


def main_path(device, rng, log_n: int) -> dict:
    """to_mont + prove + verify of a random 2^log_n BN254 Fr table, with the
    fused prover (the default) and the host-synced one (fused=False)."""
    from tpu_zk_torch.fields import arith
    from tpu_zk_torch.fields.arith import field_ctx
    from tpu_zk_torch.poly.multilinear import MultilinearPolynomial
    from tpu_zk_torch.sumcheck import fused
    from tpu_zk_torch.sumcheck.basic import Prover, Verifier

    ctx = field_ctx("bn254_fr")
    plain, want_sum = random_table(ctx, rng, log_n, device)

    reset_launches()
    poly, t_mont = sync_time(lambda: MultilinearPolynomial(ctx, arith.to_mont(ctx, plain)))
    prover = Prover(poly)
    proof, t_prove = sync_time(prover.prove)
    k7_prove = k7_launches(read_launches())
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
    if k7_prove != log_n:
        raise AssertionError(f"fused 2^{log_n} prove launched K7 {k7_prove} times, not once a round")
    proof.initial_claimed_sum += 1
    if Verifier.init().verify(proof):
        raise AssertionError(f"2^{log_n} proof with a tampered claim verifies")
    proof.initial_claimed_sum -= 1

    host_prover = Prover(poly)
    host_proof, t_host_first = sync_time(lambda: host_prover.prove(fused=False))
    if not same_sumcheck_proofs(proof, host_proof):
        raise AssertionError(f"2^{log_n}: the fused and host-synced proofs differ")
    if prover.transcript.sample_random_challenge() != host_prover.transcript.sample_random_challenge():
        raise AssertionError(f"2^{log_n}: the transcripts after the fused and host-synced proofs differ")

    with sync_error_in(fused, "fused_basic_prove"):  # a host sync in a warm fused round loop raises
        warm_proof, t_prove_warm = sync_time(lambda: Prover(poly).prove())
    ok, t_verify_warm = sync_time(lambda: Verifier.init().verify(warm_proof))
    if not ok or not same_sumcheck_proofs(proof, warm_proof):
        raise AssertionError(f"2^{log_n} warm proof differs or does not verify")
    _, t_host_warm = sync_time(lambda: Prover(poly).prove(fused=False))
    (_, syncs_fused), t_fused_counted = sync_time(lambda: count_syncs(lambda: Prover(poly).prove()))
    (_, syncs_host), t_host_counted = sync_time(lambda: count_syncs(lambda: Prover(poly).prove(fused=False)))
    round_form = (round_form_against_byte_form(f"basic sumcheck 2^{log_n}", lambda: Prover(poly).prove(), log_n,
                                               same_sumcheck_proofs) if log_n == MAIN_LOG_N else None)
    if log_n == MAIN_LOG_N:  # phase 24's one-device reference, on the host
        ONE_DEVICE["sumcheck"] = {"table": poly.table.cpu(), "claimed": proof.initial_claimed_sum,
                                  "univariates": [u.to_ints() for u in proof.round_univariate_polynomials],
                                  "warm_s": t_prove_warm, "host_synced_warm_s": t_host_warm}
    out = {
        "log_n": log_n, "to_mont_s": t_mont, "prove_first_s": t_prove, "verify_first_s": t_verify,
        "prove_warm_s": t_prove_warm, "verify_warm_s": t_verify_warm, "launches": launches,
        "k7_launches_a_prove": k7_prove, "host_synced_prove_first_s": t_host_first,
        "host_synced_prove_warm_s": t_host_warm, "warm_round_loop_ran_under_sync_error_mode": True,
        **sync_report(fused=syncs_fused, host_synced=syncs_host),
        "prove_counting_syncs_s": {"fused": t_fused_counted, "host_synced": t_host_counted},
        "round_form": round_form,
    }
    log(f"main path 2^{log_n} bn254_fr: " + json.dumps(out))
    return out


def gkr_main_path(device, rng, depth: int) -> dict:
    """evaluate + prove + verify of tree_sum_circuit(depth) on random inputs,
    fused (the default), then a host-synced prove (fused=False) of the same
    bytes."""
    from tpu_zk_torch.circuit.layered import tree_sum_circuit
    from tpu_zk_torch.fields import arith
    from tpu_zk_torch.fields.arith import field_ctx
    from tpu_zk_torch.gkr import sparse
    from tpu_zk_torch.sumcheck import fused
    from tpu_zk_torch.utils.serialize import gkr_proof_to_json

    ctx = field_ctx("bn254_fr")
    plain, want_sum = random_table(ctx, rng, depth, device)
    circuit = tree_sum_circuit(ctx, depth)

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    table, t_mont = sync_time(lambda: arith.to_mont(ctx, plain))
    del plain
    ev, t_eval = sync_time(lambda: circuit.evaluate(table, materialize=False))
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
    if k7_launches(launches) != depth * (depth + 1):  # one a round: layer i's two phases of i + 1 rounds
        raise AssertionError(f"GKR depth {depth}: K7 launched {k7_launches(launches)} times, not once a round")
    del ev
    proof.wb_evaluations[0] += 1
    if sparse.verify(circuit, proof, table):
        raise AssertionError(f"GKR depth {depth} proof with a tampered wb evaluation verifies")
    proof.wb_evaluations[0] -= 1
    coeffs = proof.sumcheck_proofs[-1].round_univariate_polynomials[3].coefficients
    coeffs[1] = (coeffs[1] + 1) % ctx.p
    if sparse.verify(circuit, proof, table):
        raise AssertionError(f"GKR depth {depth} proof with a tampered round coefficient verifies")

    _, t_eval_warm = sync_time(lambda: circuit.evaluate(table, materialize=False))
    with sync_error_in(fused, "fused_gkr_sumcheck_prove"):  # a host sync in a warm fused phase raises
        (warm_proof, syncs_fused), t_prove_warm = sync_time(lambda: count_syncs(lambda: sparse.prove(circuit, table)))
    ok, t_verify_warm = sync_time(lambda: sparse.verify(circuit, warm_proof, table))
    if not ok:
        raise AssertionError(f"GKR depth {depth} warm proof does not verify")
    (host_proof, syncs_host), t_host = sync_time(lambda: count_syncs(lambda: sparse.prove(circuit, table, fused=False)))
    if gkr_proof_to_json(host_proof, ctx.name) != gkr_proof_to_json(warm_proof, ctx.name):
        raise AssertionError(f"GKR depth {depth}: the fused and host-synced proofs differ")
    round_form = (round_form_against_byte_form(
        f"GKR depth {depth}", lambda: sparse.prove(circuit, table), depth * (depth + 1),
        lambda a, b: gkr_proof_to_json(a, ctx.name) == gkr_proof_to_json(b, ctx.name)) if depth == max(GKR_DEPTHS)
        else None)
    if depth == max(GKR_DEPTHS):  # phase 24's one-device reference, on the host
        ONE_DEVICE["gkr"] = {"inputs": table.cpu(), "json": gkr_proof_to_json(warm_proof, ctx.name),
                             "warm_s": t_prove_warm, "host_synced_s": t_host}
    out = {
        "depth": depth, "gates": (1 << depth) - 1, "to_mont_s": t_mont, "evaluate_first_s": t_eval,
        "prove_first_s": t_prove, "verify_first_s": t_verify, "evaluate_warm_s": t_eval_warm,
        "prove_warm_s": t_prove_warm, "verify_warm_s": t_verify_warm,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "launches": launches,
        "host_synced_prove_s": t_host, "warm_phases_ran_under_sync_error_mode": True,
        **sync_report(fused=syncs_fused, host_synced=syncs_host), "round_form": round_form,
    }
    log(f"GKR main path depth {depth} bn254_fr: " + json.dumps(out))
    return out


K4_CHECK_LOG_N = 12
BLS_TIMED_LOG_N = 16  # K4 over BLS12-381 is timed at 2^16 points
PLAIN_CHUNK_UNITS = 1 << 17  # K4a's plain version over a 2^24 launch runs this many units at a time
KZG_VARS = 20  # BASELINE config 4's size; also the second succinct-GKR depth
SUCCINCT_DEPTH = 24  # this slice's full width: 2^24 inputs committed, 2^24 - 1 gates (BASELINE config 5)
MSM_LOG_NS = (20, 24)


def mad_rates(device) -> tuple[float, float]:
    """The card's (wide, 32-bit) multiply-adds per second, by csrc/probe.cu:
    the wide one is the instruction field.cuh's mont_mul issues,
    (uint64_t)a * b + c, the 32-bit one x * a + b, the unit of carry chains
    of mad.lo / mad.hi (mont_mul_eo); each in 8 independent chains per
    thread, 2048 threads per SM."""
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
    return wide, narrow


LAUNCH_PROBE_LAUNCHES = 2000
LATENCY_PROBE_STEPS = 1 << 20  # dependent steps of one funnel shift and one logic op in the latency probe


def launch_latency(device) -> dict:
    """Phase 2: what one launch costs by itself: csrc/probe.cu's empty kernel
    launched LAUNCH_PROBE_LAUNCHES times back to back through ctypes, timed
    by CUDA events (the device's time from the first launch to the last) and
    by the host's clock (the Python call and the enqueue); the latency of one
    dependent 32-bit funnel shift or logic op (tzk_latency_probe: one
    thread's chain of 2 LATENCY_PROBE_STEPS of them, event-timed), in which
    K7's bound is counted; and the SM clock."""
    import ctypes

    from tpu_zk_torch import _build

    lib = _build.kernel_library()

    def launches():
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        for _ in range(LAUNCH_PROBE_LAUNCHES):
            rc = lib.tzk_empty_probe(stream)
            if rc != 0:
                raise RuntimeError(f"tzk_empty_probe: cudaError_t {rc}")

    device_ms = event_ms(launches, 3) / LAUNCH_PROBE_LAUNCHES
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    launches()
    host_ms = (time.perf_counter() - t0) * 1e3 / LAUNCH_PROBE_LAUNCHES
    torch.cuda.synchronize()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm,clocks.sm", "--format=csv,noheader,nounits"],
                         check=True, capture_output=True, text=True, timeout=60)
    max_mhz, now_mhz = (float(v) for v in smi.stdout.strip().splitlines()[0].split(","))
    chain_out = torch.empty(1, dtype=torch.int32, device=device)

    def chain():
        rc = lib.tzk_latency_probe(ctypes.c_void_p(chain_out.data_ptr()), LATENCY_PROBE_STEPS, 7, 0x9E3779B1,
                                   ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if rc != 0:
            raise RuntimeError(f"tzk_latency_probe: cudaError_t {rc}")

    dependent_op_s = event_ms(chain, 3) / 1e3 / (2 * LATENCY_PROBE_STEPS)
    out = {"launch_ms": max(device_ms, host_ms), "device_ms_a_launch": device_ms, "host_ms_a_launch": host_ms,
           "dependent_op_ns": dependent_op_s * 1e9, "dependent_op_cycles_at_max_clock": dependent_op_s * max_mhz * 1e6,
           "sm_clock_max_mhz": max_mhz, "sm_clock_now_mhz": now_mhz}
    log("launch probe: " + json.dumps(out))
    return out


PROBE_CHAIN = 64  # Montgomery products a thread of the product probe runs in series


def product_probe(device) -> None:
    """Phase 2: field.cuh's mont_mul_eo beside mont_mul in one probe kernel
    (csrc/probe.cu), all four fields: one product of 2^20 random pairs and
    of every pair of edge values equals K1's plain version for both; chains
    of PROBE_CHAIN products from the same inputs agree limb for limb; both
    timed in turns (mont_mul, mont_mul_eo, mont_mul_eo, mont_mul)."""
    import ctypes

    from tpu_zk_torch import _build
    from tpu_zk_torch.fields import kernels
    from tpu_zk_torch.fields.arith import field_ctx
    from tpu_zk_torch.fields.kernels import _launch_args

    lib = _build.kernel_library()
    gen = torch.Generator(device=device).manual_seed(1)
    for name in FIELDS:
        ctx = field_ctx(name)
        edges = [0, 1, 2, ctx.p - 1, ctx.p - 2, (ctx.p - 1) // 2, ctx.R % ctx.p]
        pairs = [(x, y) for x in edges for y in edges]
        a = torch.cat([ctx.array([x for x, _ in pairs], mont=False, device=device),
                       rand_canonical(ctx, (1 << 20,), gen, device)])
        b = torch.cat([ctx.array([y for _, y in pairs], mont=False, device=device),
                       rand_canonical(ctx, (1 << 20,), gen, device)])
        p32, n0inv = _launch_args(ctx)

        def run(even_odd: int, iters: int) -> torch.Tensor:
            res = torch.empty_like(a)
            rc = lib.tzk_mont_probe(ctypes.c_void_p(a.data_ptr()), ctypes.c_void_p(b.data_ptr()),
                                    ctypes.c_void_p(res.data_ptr()), a.shape[0], iters, even_odd, ctx.L, p32, n0inv,
                                    ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
            if rc != 0:
                raise RuntimeError(f"tzk_mont_probe: cudaError_t {rc}")
            return res

        want = kernels.mont_mul_plain(ctx, a, b)
        check_equal(f"mont_mul {name}", run(0, 1), want)
        check_equal(f"mont_mul_eo {name}", run(1, 1), want)
        check_equal(f"mont_mul_eo {name}, chains of {PROBE_CHAIN}", run(1, PROBE_CHAIN), run(0, PROBE_CHAIN))
        ms = {0: [], 1: []}
        for even_odd in (0, 1, 1, 0):
            ms[even_odd].append(event_ms(lambda: run(even_odd, PROBE_CHAIN), 5))
        log(f"product probe {name}: {a.shape[0]} chains of {PROBE_CHAIN}; equal to K1's plain version and to each "
            f"other; mont_mul {ms[0]} ms, mont_mul_eo {ms[1]} ms")


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


def k4_passes(dc, points, scalars, c: int, unit: int, what: str, rates: tuple | None = None) -> dict:
    """Every K4a pass of one MSM's bucket sums, then K4b, each against its
    plain version as group elements and against a second launch limb for
    limb.  K4a's plain version runs PLAIN_CHUNK_UNITS units at a time (one
    call cannot hold a 2^24 launch's slots).  Returns the kernels' times
    (CUDA events) and their plain versions' (host clock), the adds each
    needed and, with ``rates``, the bounds."""
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
    if rates is not None:
        add_mads = EC_ADD_PRODUCTS * mont_mul_wide_mads(ctx)
        point_bytes = 3 * ctx.L * 4
        units_total = sum(p["units"] for p in out["passes"])
        # K4a reads each entry and its point and each later pass's partials once, writes each unit's sum once
        bytes_a = live * (4 + point_bytes) + (units_total - out["passes"][0]["units"]) * point_bytes \
            + units_total * point_bytes
        out["k4a_bound"] = bound_ms(bytes_a, out["k4a_adds"] * add_mads, rates)
        out["k4b_bound"] = bound_ms((W * B + W * S) * point_bytes, out["k4b_adds"] * add_mads, rates)
        out["k4a_ops_ms"] = ops_ms(out["k4a_adds"] * add_mads, rates)
        out["k4b_ops_ms"] = ops_ms(out["k4b_adds"] * add_mads, rates)
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


def msm_alone(device, rng, setup, taus, rates: tuple) -> dict:
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
            if log_n == max(MSM_LOG_NS) and kind == "random":  # phase 24's one-device reference, on the host
                ONE_DEVICE["msm"] = {"points": tuple(c.cpu() for c in points), "scalars": s.cpu(), "want": want,
                                     "warm_s": t_warm}
            if kind == "random":
                # every bucket of the launch, each pass, and K4b against the plain versions
                k4 = k4_passes(dc, points, s, c, mp.UNIT, f"MSM 2^{log_n}", rates)
                log(f"MSM alone 2^{log_n}: every K4a pass ({[p['units'] for p in k4['passes']]} units) and K4b "
                    f"({k4['segments']} segments a window) equal their plain versions: " + json.dumps(k4))
                out["k4"] = {**out.get("k4", {}), log_n: k4}
            if log_n == max(MSM_LOG_NS) and kind == "random":
                shape = f"{n} points, c {c}: {len(k4['passes'])} K4a passes over {k4['live_entries']} entries"
                out["kernels"]["K4a"] = {"ms": k4["k4a_ms"], "plain_ms": k4["k4a_plain_ms"], "bound": k4["k4a_bound"],
                                         "ops_ms_by_unit": k4["k4a_ops_ms"], "max_abs_err": 0, "shape": shape,
                                         "passes": k4["passes"]}
                out["kernels"]["K4b"] = {"ms": k4["k4b_ms"], "plain_ms": k4["k4b_plain_ms"], "bound": k4["k4b_bound"],
                                         "ops_ms_by_unit": k4["k4b_ops_ms"], "max_abs_err": 0,
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
    tree_sum_circuit(setup.num_vars) on random inputs, first call and warm
    (fused, the default), a host-synced prove (fused=False) of the same
    bytes, then once under the stage timers."""
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

    if k7_launches(launches) != depth * (depth + 1):
        raise AssertionError(f"succinct GKR depth {depth}: K7 launched {k7_launches(launches)} times, not once a round")

    (warm, syncs_fused), t_prove_warm = sync_time(lambda: count_syncs(lambda: sparse.prove_succinct(circuit, table, setup)))
    ok, t_verify_warm = sync_time(lambda: sparse.verify_succinct(circuit, warm, setup))
    if not ok or succinct_proof_to_json(warm, ctx.name) != proof_json:
        raise AssertionError(f"succinct GKR depth {depth}: the warm proof differs or does not verify")
    peak = torch.cuda.max_memory_allocated() / 2**30
    del warm
    (host, syncs_host), t_host = sync_time(
        lambda: count_syncs(lambda: sparse.prove_succinct(circuit, table, setup, fused=False)))
    if succinct_proof_to_json(host, ctx.name) != proof_json:
        raise AssertionError(f"succinct GKR depth {depth}: the fused and host-synced proofs differ")
    del host
    round_form = (round_form_against_byte_form(
        f"succinct GKR depth {depth}", lambda: sparse.prove_succinct(circuit, table, setup), depth * (depth + 1),
        lambda a, b: succinct_proof_to_json(a, ctx.name) == succinct_proof_to_json(b, ctx.name))
        if depth == SUCCINCT_DEPTH else None)
    (_, prove_stages, prove_calls, prove_each), t_prove_timers = sync_time(
        lambda: breakdown.staged(lambda: sparse.prove_succinct(circuit, table, setup), device, breakdown.SUCCINCT_STAGES))
    (_, verify_stages, _, _), t_verify_timers = sync_time(
        lambda: breakdown.staged(lambda: sparse.verify_succinct(circuit, received, setup), device,
                                 breakdown.SUCCINCT_STAGES))
    out = {
        "depth": depth, "gates": (1 << depth) - 1, **setup_times, "prove_first_s": t_prove, "to_json_s": t_json,
        "proof_json_bytes": len(proof_json), "verify_first_s": t_verify, "prove_warm_s": t_prove_warm,
        "verify_warm_s": t_verify_warm, "peak_mem_gib": peak, "launches": launches,
        "host_synced_prove_s": t_host, **sync_report(fused=syncs_fused, host_synced=syncs_host),
        "round_form": round_form,
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


def kernels_line(times: dict, launches: dict, k4_small: dict, k4_main: dict, k56: dict, k7: dict,
                 rates: tuple) -> list[dict]:
    """The {"kernels": [...]} rows.  K1-K3: times at a depth-24 GKR round's
    shapes, the basic sumcheck's beside them.  K4a, K4b: times at the 2^24
    MSM's shape (K4a: its bucket passes added up, its plain version run
    PLAIN_CHUNK_UNITS units at a time, one call cannot hold its slots);
    both kernels' times at 2^12 points beside them.  K5, K6: time per launch over one 2^24-leaf tree and
    one 2^24 forward transform.  K7, a row a form (one kernel, two entry points): time per launch at a GKR
    round's step through the wrapper, with its arguments made once beside it, a basic round's beside them,
    its plain version on the CPU, its bound without and with the launch probe's time.  ``launches`` is the depth-24 succinct path's count for K1-K4 and K7's round form,
    and the 2^24 NTT -> FRI path's for K5, K6 and K7's byte form (its commit rounds; the fused rounds no
    longer launch it);
    every path's count is beside it, phase 22's dense, dense succinct and
    interactive paths among them.  No PyTorch call computes any of these
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
        least, by = bound_ms(*work[name], rates)
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
                     "bound_by": main_shape["bound"][1], "ops_ms_by_unit": main_shape["ops_ms_by_unit"],
                     "library_ms": None, "shape": main_shape["shape"],
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
    gkr_round = k7["GKR round"]
    k7_common = {"route": "cuda", "source": "tpu_zk_torch/csrc/sponge.cu", "bound_ms": gkr_round["bound_ms"],
                 "bound_by": gkr_round["bound_by"], "library_ms": None, "launch_ms": gkr_round["launch_ms"],
                 "bound_with_launch_ms": gkr_round["bound_with_launch_ms"],
                 "plain_is": "the plain version on the CPU (its tensors' device)"}
    rows.append({"name": "sponge_step", **k7_common,
                 "replaces": "tpu_zk/transcript/device_fs.py:79, tpu_zk/transcript/device_fs.py:314, "
                             "tpu_zk/transcript/device_fs.py:341, tpu_zk/transcript/device_fs.py:356",
                 "launches": launches["fri"]["sponge_step"], "launches_from": "fri",
                 "launches_by_path": {p: n["sponge_step"] for p, n in launches.items()},
                 "max_abs_err": k7["max_abs_err"], "ms": gkr_round["ms"], "plain_ms": gkr_round["plain_ms"],
                 "raw_launch_ms": gkr_round["raw_launch_ms"],
                 "shape": "the byte form at a GKR round's step: 96 bytes, a squeeze and its challenge",
                 "basic_round": {k: v for k, v in k7["basic round"].items() if not k.startswith("round_form")}})
    rows.append({"name": "sponge_round", **k7_common,
                 "replaces": "tpu_zk/sumcheck/fused.py (a fused round's from_mont, pack, absorb_dyn, squeeze_dyn "
                             "and digest_to_mont), tpu_zk/transcript/device_fs.py:79, "
                             "tpu_zk/transcript/device_fs.py:314, tpu_zk/transcript/device_fs.py:341",
                 "launches": launches["succinct"]["sponge_round"],
                 "launches_by_path": {p: n["sponge_round"] for p, n in launches.items()},
                 "max_abs_err": k7["round_chain"]["max_abs_err"], "ms": gkr_round["round_form_ms"],
                 "plain_ms": gkr_round["round_form_plain_ms"], "raw_launch_ms": gkr_round["round_form_raw_launch_ms"],
                 "byte_form_round_ms": gkr_round["byte_form_round_ms"],
                 "shape": "one GKR round: 3 Montgomery elements, 96 bytes LE, a squeeze and its challenge",
                 "basic_round": {k: v for k, v in k7["basic round"].items()
                                 if k.startswith("round_form") or k.startswith("bound") or k == "byte_form_round_ms"}})
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
# K6 blocks (A, m, C): every radix the plans use (2^8 at 2^24, 2^10 at 2^20, 2^9 at 2^18), the last pass of
# a 2^24 and of a 2^20 forward at a smaller A (C = 1), the small ones of the tests, ragged column counts
K6_SHAPES = ((1, 256, 4096), (4096, 256, 1), (64, 1024, 1), (3, 256, 2), (3, 256, 5), (2, 512, 129), (1, 1024, 64),
             (5, 1024, 1), (7, 1, 3), (1, 2, 1000), (4, 8, 33))


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
            # tws[:, 0] and tws[1:] are not read: random values there change nothing
            noise = tws.clone()
            noise[:, 0] = rand_canonical(ctx, (tws.shape[0],), gen, device)
            noise[1:] = rand_canonical(ctx, noise[1:].shape[:-1], gen, device)
            got = kernels.dif_pass(ctx, x, noise, pre, scale, dst)
            check_equal(f"K6 {name} [{A}, {m}, {C}] random tws[:, 0] and tws[1:]", got,
                        kernels.dif_pass_plain(ctx, x, noise, pre, scale, dst))
            check_equal(f"K6 {name} [{A}, {m}, {C}] random tws[:, 0] and tws[1:], against the plan's", got,
                        kernels.dif_pass(ctx, x, tws, pre, scale, dst))
            cases += 1
    log(f"K6: {cases} cases bit-exact (both Fr fields; radix 1 to 2^10; pre-twiddle, scale, natural-order store; "
        f"ragged column counts; random values in the unread tws[:, 0] and tws[1:])")


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
        if log_n == max(NTT_LOG_NS):  # phase 24's one-device reference, on the host
            ONE_DEVICE["ntt"] = {"table": table.cpu(), "forward": fwd.cpu(), "warm_ms": run["forward_warm_ms_events"],
                                 "warm_s": t_fwd_warm}
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
        (fri, "sponge_step", "device sponge (K7)"),
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


def commit_loop_lines() -> tuple[str, range]:
    """(the repo-relative file, its lines) of ``fri.prove``'s commit loop:
    the ``for`` over the rounds and its body."""
    from tpu_zk_torch.fri import fri

    lines, first = inspect.getsourcelines(fri.prove)
    head = next(i for i, line in enumerate(lines) if line.lstrip().startswith("for r in range(config.num_rounds)"))
    indent = len(lines[head]) - len(lines[head].lstrip())
    end = next((i for i in range(head + 1, len(lines))
                if lines[i].strip() and len(lines[i]) - len(lines[i].lstrip()) <= indent), len(lines))
    root = os.path.dirname(os.path.abspath(__file__))
    return os.path.relpath(inspect.getsourcefile(fri.prove), root), range(first + head, first + end)


def fri_path(device, gen, log_n: int) -> dict:
    """Phase 20: NTT of a low-degree polynomial, fri.prove, fri.verify,
    first call and warm, then once under the stage timers (K5's Merkle
    levels round by round among them); tampered proofs and a high-degree
    codeword fail; K5, K6 and K7 must launch, K7 once a commit round.  A
    warm prove's host syncs are counted by place, with every commit round
    under the sync debug mode "error": none may lie in the commit loop."""
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
    for name in ("dif_pass", "keccak_rows", "mont_mul", "addsub", "sponge_step"):
        if launches[name] == 0:
            raise AssertionError(f"FRI path at 2^{log_n} never launched kernel {name}: {launches}")
    if launches["sponge_step"] != cfg.num_rounds:
        raise AssertionError(f"FRI 2^{log_n}: the prove launched K7 {launches['sponge_step']} times, not once a "
                             f"commit round ({cfg.num_rounds})")
    for how in ("final codeword", "query value", "Merkle sibling"):
        if fri.verify(cfg, _tampered(proof, how), Transcript()):
            raise AssertionError(f"FRI 2^{log_n}: a proof with a tampered {how} verifies")
    warm, t_prove_warm = sync_time(lambda: fri.prove(cfg, codeword, Transcript()))
    ok, t_verify_warm = sync_time(lambda: fri.verify(cfg, warm, Transcript()))
    if not ok or warm != proof:
        raise AssertionError(f"FRI 2^{log_n}: the warm proof differs or does not verify")
    del warm
    reset_launches()
    with sync_error_in(fri, "_commit_round"):  # a host sync inside a commit round raises
        (counted, syncs), t_prove_counted = sync_time(lambda: count_syncs(lambda: fri.prove(cfg, codeword, Transcript())))
    k7_counted = read_launches()["sponge_step"]
    if counted != proof or k7_counted != cfg.num_rounds:
        raise AssertionError(f"FRI 2^{log_n}: the prove counting syncs differs, or launched K7 {k7_counted} times "
                             f"for {cfg.num_rounds} commit rounds")
    del counted
    loop_file, loop_lines = commit_loop_lines()
    in_loop = {place: n for place, n in syncs.items()
               if place.rpartition(":")[0] == loop_file and int(place.rpartition(":")[2]) in loop_lines}
    if in_loop:
        raise AssertionError(f"FRI 2^{log_n}: host syncs inside the commit loop ({loop_file}:{loop_lines.start}-"
                             f"{loop_lines.stop - 1}): {in_loop}")
    if log_n == max(FRI_LOG_NS):  # phase 24's one-device reference, on the host
        ONE_DEVICE["fri"] = {"codeword": codeword.cpu(), "proof": proof, "warm_s": t_prove_warm}
    noise = rand_canonical(ctx, (1 << log_n,), gen, device)  # random evaluations: degree far above 2^(log_n - 2)
    if fri.verify(cfg, fri.prove(cfg, noise, Transcript()), Transcript()):
        raise AssertionError(f"FRI 2^{log_n}: random evaluations pass the low-degree test")
    del noise
    (_, stages, calls, each), t_timed = sync_time(lambda: breakdown.staged(
        lambda: fri.verify(cfg, fri.prove(cfg, fri_codeword(ctx, log_n, gen, device), Transcript()), Transcript()),
        device, fri_stages()))
    out = {"log_n": log_n, "rounds": cfg.num_rounds, "ntt_s": t_ntt, "prove_first_s": t_prove,
           "verify_first_s": t_verify, "prove_warm_s": t_prove_warm, "verify_warm_s": t_verify_warm,
           "peak_mem_gib": peak, "launches": launches, "k7_launches_a_prove": k7_counted,
           "prove_counting_syncs_s": t_prove_counted, **sync_report(prove=syncs),
           "commit_loop": f"{loop_file}:{loop_lines.start}-{loop_lines.stop - 1}",
           "ntt_prove_verify_with_timers_s": t_timed, "stages_s": stages, "stage_calls": calls,
           "merkle_levels_s_by_round": each["Merkle levels (K5)"]}
    log(f"FRI path bn254_fr 2^{log_n}: " + json.dumps(out) + "; tampered final codeword, query value and Merkle "
        "sibling rejected; random evaluations rejected; no host sync in the commit loop")
    return out


def k56_times(device, gen, rates: tuple, lrate: float) -> dict:
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
    k6_err, made = 0, 0
    for i in range(R):
        (got, n), want = nk.dif_pass_products(ctx, views[i], *args[i]), nk.dif_pass_plain(ctx, views[i], *args[i])
        k6_err = max(k6_err, max_err(got, want))
        check_equal(f"K6 2^{log_n} pass {i}", got, want)
        made += n
        del got, want
    passes_ms = [event_ms(lambda i=i: nk.dif_pass(ctx, views[i], *args[i]), 10) for i in range(R)]
    plain_ms = event_ms(lambda: [nk.dif_pass_plain(ctx, views[i], *args[i]) for i in range(R)], 1)
    products = k6_products(ctx, plan)
    one = ctx.one_mont(device)
    pre_ones = sum(int((pre == one).all(-1).sum()) for pre in plan.pres if pre is not None)
    if made != products + pre_ones:
        raise AssertionError(f"K6 2^{log_n} forward made {made} products: the function needs {products}, and the "
                             f"kernel multiplies by the {pre_ones} pre-twiddles equal to one besides")
    n_bytes = sum(2 * N * elem + (N * elem if i else 0) for i in range(R)) + N * 8
    wide_mads = products * mont_mul_wide_mads(ctx)
    least, by = bound_ms(n_bytes, wide_mads, rates)
    by_unit = {unit: t / R for unit, t in ops_ms(wide_mads, rates).items()}
    k6 = {"ms": sum(passes_ms) / R, "passes_ms": passes_ms, "plain_ms": plain_ms / R, "bound_ms": least / R,
          "bound_by": by, "ops_ms_by_unit": by_unit, "bytes_ms": n_bytes / HBM_BYTES_PER_S * 1e3 / R,
          "products_made": made, "products_needed": products, "pre_twiddles_equal_to_one": pre_ones,
          "share_of_bound": least / sum(passes_ms), "max_abs_err": k6_err,
          "shape": f"one 2^{log_n} forward: {R} passes of radix {plan.ms}"}
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
    log(f"K6 2^{log_n} forward: passes {passes_ms} ms, {sum(passes_ms):.4f} ms in all (plain {plain_ms:.1f} ms); "
        f"products made {made}, needed {products} (k6_products) + {pre_ones} pre-twiddles equal to one; bound "
        f"{k6['bound_ms'] * R:.4f} ms ({by}; operations {by_unit['wide'] * R:.4f} ms wide, "
        f"{by_unit['32-bit'] * R:.4f} ms 32-bit; bytes {k6['bytes_ms'] * R:.4f} ms): "
        f"{100 * k6['share_of_bound']:.1f} % of it; K5 2^{log_n}-leaf tree {tree_ms:.4f} ms (leaf level {k5['leaf_level_ms']:.4f} ms; plain "
        f"{plain_tree_ms:.1f} ms), bound {least:.4f} ms ({k5['bound_by']})")
    return {"K5": k5, "K6": k6}


# ---------------------------------------------------------------------------
# phase 22: the dense GKR pipeline and the interactive sumcheck (K1-K4)
# ---------------------------------------------------------------------------

# the largest dense circuit an 80 GB card holds: layer i's wiring pair is [2, 2^(3i+2), 16] int32, so
# layer 8's is 8 GiB (2^31 limbs); a depth-10 tree's layer 9 would need 64 GiB and 32 GiB for its first fold
DENSE_DEPTH = 9
DENSE_PARITY_DEPTH = 4
INTERACTIVE_LOG_N = 20


def alternating_tree(ctx, depth: int):
    """tree_sum_circuit's shape with gate g of each layer ADD for even g and
    MUL for odd g."""
    from tpu_zk_torch.circuit.layered import Circuit, Layer

    layers = []
    for i in range(depth):
        g = np.arange(1 << i)
        layers.append(Layer.from_arrays(2 * g, 2 * g + 1, g, g % 2))
    return Circuit(ctx, layers)


def check_dense_parity(device, rng) -> None:
    """Phase 22, first: the dense proofs from the card equal the CPU's."""
    from tpu_zk_torch.circuit.layered import Circuit, Gate, Layer
    from tpu_zk_torch.fields.arith import field_ctx
    from tpu_zk_torch.gkr import protocol, succinct
    from tpu_zk_torch.kzg.trusted_setup import TrustedSetup
    from tpu_zk_torch.utils.serialize import gkr_proof_to_json, succinct_proof_to_json

    ctx = field_ctx("bn254_fr")
    circuit = mixed_circuit(ctx, DENSE_PARITY_DEPTH, rng)
    vals = [int.from_bytes(rng.bytes(32), "little") % ctx.p for _ in range(1 << DENSE_PARITY_DEPTH)]
    jsons = []
    for dev in (device, torch.device("cpu")):
        table = ctx.array(vals, device=dev)
        proof = protocol.prove(circuit, table)
        if not protocol.verify(circuit, proof, table):
            raise AssertionError(f"dense GKR mixed depth {DENSE_PARITY_DEPTH} proof on {dev} does not verify")
        jsons.append(gkr_proof_to_json(proof, ctx.name))
    if jsons[0] != jsons[1]:
        raise AssertionError(f"dense GKR mixed depth {DENSE_PARITY_DEPTH}: proof JSON from the card differs from the CPU's")

    bls = field_ctx("bls12_381_fr")
    two_layers = Circuit(bls, [Layer([Gate.mul(0, 1, 0)]), Layer([Gate.add(0, 1, 0), Gate.mul(2, 3, 1)])])
    succinct_jsons = []
    for dev in (device, torch.device("cpu")):
        setup = TrustedSetup.initialize_setup("bls12_381", [5, 2], device=dev)
        proof = succinct.prove_succinct(two_layers, [2, 3, 4, 5], setup)
        if not succinct.verify_succinct(two_layers, proof, setup):
            raise AssertionError(f"dense succinct two-layer proof on {dev} does not verify")
        succinct_jsons.append(succinct_proof_to_json(proof, bls.name))
    if succinct_jsons[0] != succinct_jsons[1]:
        raise AssertionError("dense succinct two layers: proof JSON from the card differs from the CPU's")
    log(f"dense parity: mixed depth {DENSE_PARITY_DEPTH} bn254_fr and succinct two layers bls12_381, "
        f"CUDA proof JSON == CPU proof JSON ({len(jsons[0])} and {len(succinct_jsons[0])} bytes), all verify")


@contextlib.contextmanager
def host_synced_gkr_sumcheck():
    """gkr_sumcheck.prove with fused=False while the block runs: the dense
    pipeline (gkr/protocol.py) calls it with the default, as tpu_zk's does."""
    from tpu_zk_torch.sumcheck import gkr_sumcheck

    saved = gkr_sumcheck.prove
    gkr_sumcheck.prove = lambda *a, **k: saved(*a, **{**k, "fused": False})
    try:
        yield
    finally:
        gkr_sumcheck.prove = saved


def dense_path(device, rng, seed: int) -> dict:
    """Phase 22: evaluate, dense prove and verify of tree_sum_circuit(9) on
    random inputs, first call and warm (fused, the default), a host-synced
    prove of the same bytes, then under the dense stage timers; the
    alternating ADD/MUL tree; dense prove_succinct and verify_succinct."""
    from tpu_zk_torch.circuit.layered import tree_sum_circuit
    from tpu_zk_torch.curves import ec_device
    from tpu_zk_torch.fields import arith
    from tpu_zk_torch.fields.arith import field_ctx
    from tpu_zk_torch.gkr import breakdown, protocol, sparse, succinct
    from tpu_zk_torch.kzg.trusted_setup import TrustedSetup, generate_values_for_tau
    from tpu_zk_torch.utils.serialize import gkr_proof_to_json, succinct_proof_from_json, succinct_proof_to_json

    ctx = field_ctx("bn254_fr")
    depth = DENSE_DEPTH
    plain, want_sum = random_table(ctx, rng, depth, device)
    circuit = tree_sum_circuit(ctx, depth)
    table = arith.to_mont(ctx, plain)
    del plain

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    ev, t_eval = sync_time(lambda: circuit.evaluate(table))
    proof, t_prove = sync_time(lambda: protocol.prove(circuit, table))
    ok, t_verify = sync_time(lambda: protocol.verify(circuit, proof, table))
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30

    if not ok:
        raise AssertionError(f"dense GKR depth {depth} proof does not verify")
    if ev.output != [want_sum] or proof.circuit_output != [want_sum] or ev.layer_evaluations[0] != [want_sum]:
        raise AssertionError(f"dense GKR depth {depth}: output differs from the host's sum of the inputs")
    if len(ev.layer_evaluations) != depth + 1 or len(ev.layer_evaluations[-1]) != 1 << depth:
        raise AssertionError(f"dense GKR depth {depth}: wrong layer evaluations")
    if len(proof.sumcheck_proofs) != depth or len(proof.sumcheck_proofs[-1].round_univariate_polynomials) != 2 * depth:
        raise AssertionError(f"dense GKR depth {depth}: wrong number of layers or rounds")
    for name in ("mont_mul", "fold", "addsub"):
        if launches[name] == 0:
            raise AssertionError(f"dense GKR at depth {depth} never launched kernel {name}")
    dense_json = gkr_proof_to_json(proof, ctx.name)
    if gkr_proof_to_json(sparse.prove(circuit, table), ctx.name) != dense_json:
        raise AssertionError(f"dense GKR depth {depth}: proof JSON differs from sparse.prove's")
    proof.wb_evaluations[0] += 1
    if protocol.verify(circuit, proof, table):
        raise AssertionError(f"dense GKR depth {depth} proof with a tampered wb evaluation verifies")
    proof.wb_evaluations[0] -= 1
    coeffs = proof.sumcheck_proofs[-1].round_univariate_polynomials[3].coefficients
    coeffs[1] = (coeffs[1] + 1) % ctx.p
    if protocol.verify(circuit, proof, table):
        raise AssertionError(f"dense GKR depth {depth} proof with a tampered round coefficient verifies")

    rounds = sum(len(p.round_univariate_polynomials) for p in proof.sumcheck_proofs)
    if k7_launches(launches) != rounds:
        raise AssertionError(f"dense GKR depth {depth}: K7 launched {k7_launches(launches)} times in {rounds} rounds")

    _, t_eval_warm = sync_time(lambda: circuit.evaluate(table))
    (warm, syncs_fused), t_prove_warm = sync_time(lambda: count_syncs(lambda: protocol.prove(circuit, table)))
    ok, t_verify_warm = sync_time(lambda: protocol.verify(circuit, warm, table))
    if not ok or gkr_proof_to_json(warm, ctx.name) != dense_json:
        raise AssertionError(f"dense GKR depth {depth}: the warm proof differs or does not verify")
    with host_synced_gkr_sumcheck():
        (host, syncs_host), t_host = sync_time(lambda: count_syncs(lambda: protocol.prove(circuit, table)))
    if gkr_proof_to_json(host, ctx.name) != dense_json:
        raise AssertionError(f"dense GKR depth {depth}: the fused and host-synced proofs differ")
    round_form = round_form_against_byte_form(f"dense GKR depth {depth}", lambda: protocol.prove(circuit, table),
                                              rounds, lambda a, b: gkr_proof_to_json(a, ctx.name) == gkr_proof_to_json(b, ctx.name))
    (_, prove_stages, prove_calls, _), t_prove_timers = sync_time(
        lambda: breakdown.staged(lambda: protocol.prove(circuit, table), device, breakdown.DENSE_STAGES))
    (ok, verify_stages, verify_calls, _), t_verify_timers = sync_time(
        lambda: breakdown.staged(lambda: protocol.verify(circuit, warm, table), device, breakdown.DENSE_STAGES))
    if not ok:
        raise AssertionError(f"dense GKR depth {depth}: the proof under the stage timers does not verify")

    mixed = alternating_tree(ctx, depth)
    mixed_proof = protocol.prove(mixed, table)
    if not protocol.verify(mixed, mixed_proof, table):
        raise AssertionError(f"dense GKR alternating ADD/MUL tree depth {depth}: the proof does not verify")
    if gkr_proof_to_json(mixed_proof, ctx.name) != gkr_proof_to_json(sparse.prove(mixed, table), ctx.name):
        raise AssertionError(f"dense GKR alternating ADD/MUL tree depth {depth}: proof JSON differs from sparse.prove's")

    setup = TrustedSetup.initialize_setup("bn254", generate_values_for_tau("bn254", depth, seed=seed))
    setup.folded_g1_bases()
    reset_launches()
    double_and_add = []
    saved_msm = ec_device.msm
    ec_device.msm = lambda *a, **k: double_and_add.append(1) or saved_msm(*a, **k)
    try:
        s_proof, t_s_prove = sync_time(lambda: succinct.prove_succinct(circuit, table, setup))
        s_json = succinct_proof_to_json(s_proof, ctx.name)
        ok, t_s_verify = sync_time(lambda: succinct.verify_succinct(circuit, succinct_proof_from_json(s_json), setup))
    finally:
        ec_device.msm = saved_msm
    s_launches = read_launches()
    if not ok:
        raise AssertionError(f"dense succinct GKR depth {depth}: the proof does not verify")
    for name in SUCCINCT_KERNELS:
        if s_launches[name] == 0:
            raise AssertionError(f"dense succinct GKR at depth {depth} never launched kernel {name}")
    if double_and_add:
        raise AssertionError(f"dense succinct GKR depth {depth}: {len(double_and_add)} double-and-add MSMs ran")
    if succinct_proof_to_json(sparse.prove_succinct(circuit, table, setup), ctx.name) != s_json:
        raise AssertionError(f"dense succinct GKR depth {depth}: proof JSON differs from sparse.prove_succinct's")
    tampered = succinct_proof_from_json(s_json)
    tampered.input_rb_proof.evaluation += 1
    if succinct.verify_succinct(circuit, tampered, setup):
        raise AssertionError(f"dense succinct GKR depth {depth}: a proof with a tampered KZG evaluation verifies")
    warm_s, t_s_prove_warm = sync_time(lambda: succinct.prove_succinct(circuit, table, setup))
    ok, t_s_verify_warm = sync_time(lambda: succinct.verify_succinct(circuit, warm_s, setup))
    if not ok or succinct_proof_to_json(warm_s, ctx.name) != s_json:
        raise AssertionError(f"dense succinct GKR depth {depth}: the warm proof differs or does not verify")

    out = {
        "depth": depth, "gates": (1 << depth) - 1, "evaluate_first_s": t_eval, "prove_first_s": t_prove,
        "verify_first_s": t_verify, "evaluate_warm_s": t_eval_warm, "prove_warm_s": t_prove_warm,
        "verify_warm_s": t_verify_warm, "peak_mem_gib": peak, "launches": launches,
        "host_synced_prove_s": t_host, **sync_report(fused=syncs_fused, host_synced=syncs_host),
        "proof_json_bytes": len(dense_json), "prove_with_timers_s": t_prove_timers, "prove_stages_s": prove_stages,
        "prove_stage_calls": prove_calls, "verify_with_timers_s": t_verify_timers, "verify_stages_s": verify_stages,
        "verify_stage_calls": verify_calls, "round_form": round_form,
        "succinct": {"prove_first_s": t_s_prove, "verify_first_s": t_s_verify, "prove_warm_s": t_s_prove_warm,
                     "verify_warm_s": t_s_verify_warm, "launches": s_launches},
    }
    log(f"dense GKR depth {depth} bn254_fr: " + json.dumps(out))
    return out


def interactive_path(device, rng) -> dict:
    """Phase 22, last: the interactive sumcheck over a random 2^20 BN254 Fr
    table; prover and verifier agree every round, the oracle check holds and
    a tampered claim is rejected."""
    from tpu_zk_torch.fields import arith
    from tpu_zk_torch.fields.arith import field_ctx
    from tpu_zk_torch.poly.multilinear import MultilinearPolynomial
    from tpu_zk_torch.sumcheck import interactive

    ctx = field_ctx("bn254_fr")
    plain, want_sum = random_table(ctx, rng, INTERACTIVE_LOG_N, device)
    poly = MultilinearPolynomial(ctx, arith.to_mont(ctx, plain))
    del plain

    def run():
        prover, verifier = interactive.Prover(poly), interactive.Verifier(poly)
        claim, univ = prover.prove(0)
        rounds = [(claim, univ)]
        if claim != want_sum or not verifier.verify(claim, univ):
            raise AssertionError("interactive sumcheck: round 0 disagrees with the host's sum")
        for _ in range(INTERACTIVE_LOG_N):
            claim, univ = prover.prove(verifier.generate_challenge())
            rounds.append((claim, univ))
            if not verifier.verify(claim, univ):
                raise AssertionError(f"interactive sumcheck: round {len(rounds) - 1} rejected")
        if not verifier.oracle_check() or rounds[-1][1][0] != 0:
            raise AssertionError("interactive sumcheck: the oracle check or the last round's split_at(0) fails")
        return verifier, rounds

    reset_launches()
    (verifier, rounds), t_first = sync_time(run)
    launches = read_launches()
    if not all(launches[k] > 0 for k in ("mont_mul", "fold")):
        raise AssertionError(f"interactive sumcheck skipped a kernel: {launches}")
    if verifier.verify(rounds[3][0] + 1, rounds[3][1]):
        raise AssertionError("interactive sumcheck: a tampered claim is accepted")
    _, t_warm = sync_time(run)
    out = {"log_n": INTERACTIVE_LOG_N, "rounds": len(rounds), "first_s": t_first, "warm_s": t_warm,
           "launches": launches}
    log(f"interactive sumcheck 2^{INTERACTIVE_LOG_N} bn254_fr: " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 23: K7 (the device sponge), checkpoints, counters, the roofline table
# ---------------------------------------------------------------------------

K7_STEPS = 10_000  # random steps chained on one sponge, K7's byte form against its plain version
K7_MAX_DATA = 300  # data bytes a step, at most
K7_ROUNDS = 1_536  # rounds chained on one sponge, K7's round form against its plain version
K7_ROUND_FORMS = ((2, True), (3, False), (4, False))  # (elements, big-endian): a basic round's, GKR rounds'
K7_TIMED = 1000  # launches a timed K7 step
CHECKPOINT_ROUND = 12  # the 2^24 basic sumcheck is saved after this round
CHECKPOINT_DEPTH, CHECKPOINT_LAYER = 20, 10  # the sparse GKR prove saved after this layer
COUNTERS_LOG_N = 20


def k7_raw_ms(entry: str, *args) -> float:
    """K7's time a launch through the C entry point ``entry`` with its ctypes
    arguments made once, launched K7_TIMED times in a row: the kernel
    without the wrapper's Python."""
    import ctypes

    from tpu_zk_torch import _build

    fn = getattr(_build.kernel_library(), entry)
    args = [*args, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)]

    def launches():
        for _ in range(K7_TIMED):
            fn(*args)
        if fn(*args) != 0:
            raise RuntimeError(f"{entry} refused a launch")

    return event_ms(launches, 3) / (K7_TIMED + 1)


def k7_round_chain(device, seed: int) -> dict:
    """Phase 23: K7's round form against its plain version, bit-exact, over
    K7_ROUNDS rounds chained on one sponge: each round's form from the seed
    (K7_ROUND_FORMS), its Montgomery elements random below p, and before it
    a byte-form step of random bytes that brings the round to fill level
    i % 136, so every level 0..135 starts rounds of each form; every round's
    state, tail, fill level, plain slot, digest and challenge."""
    from tpu_zk_torch.fields.arith import field_ctx
    from tpu_zk_torch.transcript import device_fs
    from tpu_zk_torch.transcript import kernels as tk

    ctx = field_ctx("bn254_fr")
    rng = np.random.default_rng(seed + 2312)
    forms = rng.integers(0, len(K7_ROUND_FORMS), size=K7_ROUNDS)
    limbs = rng.integers(0, 1 << 16, size=(K7_ROUNDS, 4, ctx.L), dtype=np.uint32)
    limbs[..., -1] &= 0x2FFF  # top limb < p's 0x3064: every value < p, a Montgomery form
    pads, pos, starts = [], 0, set()
    for i in range(K7_ROUNDS):
        pads.append((i % 136 - pos) % 136)
        starts.add((pos + pads[-1]) % 136)
        w = K7_ROUND_FORMS[forms[i]][0]
        pos = ((i % 136) + 32 * w + 32) % 136  # after absorbing 32 w bytes, and the digest's 32
    if starts != set(range(136)):
        raise AssertionError(f"K7 round chain: rounds start at {len(starts)} fill levels, not all 136")
    offs = np.concatenate([[0], np.cumsum(pads)]).tolist()
    pool_np = rng.integers(0, 256, size=offs[-1], dtype=np.uint8)
    records = []  # the kernel's run, then the plain version's
    for dev in (device, torch.device("cpu")):
        pool, mont = torch.from_numpy(pool_np).to(dev), torch.from_numpy(limbs.view(np.int32)).to(dev)
        sponge = device_fs.DeviceSponge.fresh(dev)
        states = torch.empty((K7_ROUNDS, 25), dtype=torch.int64, device=dev)
        bufs = torch.empty((K7_ROUNDS, 136), dtype=torch.uint8, device=dev)
        poss = torch.empty((K7_ROUNDS, 1), dtype=torch.int32, device=dev)
        slots = torch.zeros((K7_ROUNDS, 4, ctx.L), dtype=torch.int32, device=dev)
        digests = torch.zeros((K7_ROUNDS, 32), dtype=torch.uint8, device=dev)
        chals = torch.zeros((K7_ROUNDS, ctx.L), dtype=torch.int32, device=dev)
        t0 = time.perf_counter()
        for i in range(K7_ROUNDS):
            w, big_endian = K7_ROUND_FORMS[forms[i]]
            tk.sponge_step(sponge.state, sponge.buf, sponge.pos, pool[offs[i] : offs[i + 1]])
            tk.sponge_round(sponge.state, sponge.buf, sponge.pos, mont[i, :w], slots[i, :w], digests[i], chals[i], ctx,
                            big_endian)
            states[i], bufs[i], poss[i] = sponge.state, sponge.buf, sponge.pos
        if dev.type == "cuda":
            torch.cuda.synchronize()
        records.append(([t.cpu() for t in (states.view(torch.uint8), bufs, poss, slots, digests, chals)],
                        time.perf_counter() - t0))
    (kernel_out, kernel_s), (plain_out, plain_s) = records
    err = 0
    for what, got, want in zip(("states", "tails", "fill levels", "plain slots", "digests", "challenges"), kernel_out,
                               plain_out):
        err = max(err, max_err(got, want))
        check_equal(f"K7 round form, {K7_ROUNDS} chained rounds: {what}", got, want)
    counts = {f"w={w} {'BE' if be else 'LE'}": int((forms == k).sum()) for k, (w, be) in enumerate(K7_ROUND_FORMS)}
    log(f"K7 round form: {K7_ROUNDS} chained rounds ({counts}, each after a byte-form step to fill level i % 136, "
        f"{sum(pads)} bytes) bit-exact against the plain version; card {kernel_s:.3f} s, plain (CPU) {plain_s:.1f} s")
    return {"max_abs_err": err, "chain_card_s": kernel_s, "chain_plain_s": plain_s, "rounds": K7_ROUNDS, "forms": counts}


def check_k7(device, seed: int, launch: dict) -> dict:
    """Phase 23, first: K7's byte form against its plain version, bit-exact,
    on K7_STEPS random steps chained on one sponge from the seed (k <=
    K7_MAX_DATA data bytes, a squeeze with its BN254 Fr challenge or none):
    every step's state, tail, fill level, digest and challenge; its round
    form likewise (:func:`k7_round_chain`).  digest_to_mont (K1) of the digests
    2^256 - 1 and p.  Both forms' time a launch at a basic-sumcheck round
    (64 bytes and a squeeze) and a GKR round (96 bytes and a squeeze),
    through the wrapper and with the ctypes arguments made once, beside the
    plain version's (on the CPU), the byte form's whole round as it was
    before the round form (from_mont, the pack and the byte form) and the
    bound: the step's permutations, each a chain of PERMUTATION_DEPTH
    dependent instructions at the latency phase 2 probed, and the launch
    probe's time apart."""
    import ctypes

    from tpu_zk_torch.fields import arith
    from tpu_zk_torch.fields.arith import field_ctx
    from tpu_zk_torch.transcript import device_fs
    from tpu_zk_torch.transcript import kernels as tk
    from tpu_zk_torch.utils.roofline import PERMUTATION_DEPTH, sponge_permutations, sponge_step_bound_ms

    ctx = field_ctx("bn254_fr")
    rng = np.random.default_rng(seed + 23)
    ks = rng.integers(0, K7_MAX_DATA + 1, size=K7_STEPS)
    squeezes = rng.integers(0, 2, size=K7_STEPS).astype(bool)
    offs = np.concatenate([[0], np.cumsum(ks)]).tolist()
    pool_np = rng.integers(0, 256, size=offs[-1], dtype=np.uint8)
    records = []  # the kernel's run, then the plain version's
    for dev in (device, torch.device("cpu")):
        pool = torch.from_numpy(pool_np).to(dev)
        sponge = device_fs.DeviceSponge.fresh(dev)
        states = torch.empty((K7_STEPS, 25), dtype=torch.int64, device=dev)
        bufs = torch.empty((K7_STEPS, 136), dtype=torch.uint8, device=dev)
        poss = torch.empty((K7_STEPS, 1), dtype=torch.int32, device=dev)
        digests = torch.zeros((K7_STEPS, 32), dtype=torch.uint8, device=dev)
        chals = torch.zeros((K7_STEPS, ctx.L), dtype=torch.int32, device=dev)
        t0 = time.perf_counter()
        for i in range(K7_STEPS):
            data = pool[offs[i] : offs[i + 1]]
            if squeezes[i]:
                tk.sponge_step(sponge.state, sponge.buf, sponge.pos, data, digests[i], chals[i], ctx)
            else:
                tk.sponge_step(sponge.state, sponge.buf, sponge.pos, data)
            states[i], bufs[i], poss[i] = sponge.state, sponge.buf, sponge.pos
        if dev.type == "cuda":
            torch.cuda.synchronize()
        records.append(([t.cpu() for t in (states.view(torch.uint8), bufs, poss, digests, chals)],
                        time.perf_counter() - t0))
    (kernel_out, kernel_s), (plain_out, plain_s) = records
    err = 0
    for what, got, want in zip(("states", "tails", "fill levels", "digests", "challenges"), kernel_out, plain_out):
        err = max(err, max_err(got, want))
        check_equal(f"K7 {K7_STEPS} chained steps: {what}", got, want)
    perms, _ = sponge_permutations(0, zip(ks.tolist(), squeezes.tolist()))
    log(f"K7: {K7_STEPS} chained steps ({int(ks.sum())} bytes, {int(squeezes.sum())} squeezes, {perms} permutations) "
        f"bit-exact against the plain version; card {kernel_s:.3f} s, plain (CPU) {plain_s:.1f} s")
    rounds = k7_round_chain(device, seed)

    for value in ((1 << 256) - 1, ctx.p):
        digest = torch.tensor(list(value.to_bytes(32, "little")), dtype=torch.uint8, device=device)
        got = device_fs.digest_to_mont(ctx, digest)
        check_equal(f"digest_to_mont({hex(value)})", got, device_fs.digest_to_mont(ctx, digest.cpu()).to(device))
        if ctx.to_ints(got) != value % ctx.p:
            raise AssertionError(f"digest_to_mont({hex(value)}) is not the digest mod p")
    log("digest_to_mont of 2^256 - 1 and p on the card (K1): equal to the plain version and to the digest mod p")

    out = {"max_abs_err": err, "chain_card_s": kernel_s, "chain_plain_s": plain_s, "round_chain": rounds}
    dependent_op_s = launch["dependent_op_ns"] / 1e9
    p32, n0inv, r2 = tk._field_args(ctx)

    def ptr(t: torch.Tensor) -> ctypes.c_void_p:
        return ctypes.c_void_p(t.data_ptr())

    for what, w, big_endian in (("basic round", 2, True), ("GKR round", 3, False)):
        k = 32 * w
        mont = torch.from_numpy(rng.integers(0, 1 << 15, size=(w, ctx.L), dtype=np.int32)).to(device)
        data = torch.from_numpy(pool_np[:k].copy()).to(device)
        sponge = device_fs.DeviceSponge.fresh(device)
        digest = torch.empty(32, dtype=torch.uint8, device=device)
        chal = torch.empty(ctx.L, dtype=torch.int32, device=device)
        slot = torch.empty((w, ctx.L), dtype=torch.int32, device=device)
        pack = tk.pack_bytes_be if big_endian else tk.pack_bytes_le
        st, bf, ps = sponge.state, sponge.buf, sponge.pos
        ms = event_ms(lambda: tk.sponge_step(st, bf, ps, data, digest, chal, ctx), K7_TIMED)
        round_ms = event_ms(lambda: tk.sponge_round(st, bf, ps, mont, slot, digest, chal, ctx, big_endian), K7_TIMED)

        def byte_form_round():
            slot.copy_(arith.from_mont(ctx, mont))
            tk.sponge_step(st, bf, ps, pack(ctx, slot), digest, chal, ctx)

        byte_round_ms = event_ms(byte_form_round, K7_TIMED)
        raw_ms = k7_raw_ms("tzk_sponge_step", ptr(st), ptr(bf), ptr(ps), ptr(data), ctypes.c_int64(k), ptr(digest),
                           ptr(chal), ctypes.c_int(ctx.L), p32, n0inv, r2)
        round_raw_ms = k7_raw_ms("tzk_sponge_round", ptr(st), ptr(bf), ptr(ps), ptr(mont), ctypes.c_int(w),
                                 ctypes.c_int(int(big_endian)), ptr(slot), ptr(digest), ptr(chal), p32, n0inv, r2)
        cpu = device_fs.DeviceSponge.fresh("cpu")
        cpu_data, cpu_digest, cpu_chal, cpu_mont, cpu_slot = data.cpu(), digest.cpu(), chal.cpu(), mont.cpu(), slot.cpu()
        t0 = time.perf_counter()
        for _ in range(20):
            tk.sponge_step(cpu.state, cpu.buf, cpu.pos, cpu_data, cpu_digest, cpu_chal, ctx)
        plain_ms = (time.perf_counter() - t0) * 1e3 / 20
        t0 = time.perf_counter()
        for _ in range(20):
            tk.sponge_round(cpu.state, cpu.buf, cpu.pos, cpu_mont, cpu_slot, cpu_digest, cpu_chal, ctx, big_endian)
        round_plain_ms = (time.perf_counter() - t0) * 1e3 / 20
        perms, _ = sponge_permutations(0, [(k, True)] * (K7_TIMED + 1))  # the warm-up launch and the timed ones
        least, by = sponge_step_bound_ms(perms / (K7_TIMED + 1), k, dependent_op_s, ctx.L)
        out[what] = {"ms": ms, "raw_launch_ms": raw_ms, "plain_ms": plain_ms, "round_form_ms": round_ms,
                     "round_form_raw_launch_ms": round_raw_ms, "round_form_plain_ms": round_plain_ms,
                     "byte_form_round_ms": byte_round_ms, "bound_ms": least, "bound_by": by,
                     "permutations_a_step": perms / (K7_TIMED + 1), "launch_ms": launch["launch_ms"],
                     "bound_with_launch_ms": least + launch["launch_ms"]}
        log(f"K7 {what} step ({k} bytes, squeeze, challenge): byte form {ms:.5f} ms a launch through the wrapper, "
            f"{raw_ms:.5f} ms with its arguments made once (plain on the CPU {plain_ms:.3f} ms); round form ({w} "
            f"elements {'BE' if big_endian else 'LE'}) {round_ms:.5f} ms through the wrapper, {round_raw_ms:.5f} ms "
            f"with its arguments made once (plain {round_plain_ms:.3f} ms); the round made of from_mont, the pack and "
            f"the byte form {byte_round_ms:.5f} ms; bound {least:.5f} ms ({by}: {perms / (K7_TIMED + 1):.3f} "
            f"permutations of {PERMUTATION_DEPTH} dependent instructions at {launch['dependent_op_ns']:.3f} ns), "
            f"with the launch {least + launch['launch_ms']:.5f} ms")
    return out


def checkpoint_paths(device, rng) -> dict:
    """Phase 23: the 2^24 basic sumcheck saved after round CHECKPOINT_ROUND,
    loaded and finished, equal to the uninterrupted (fused) proof; the
    depth-20 sparse GKR prove saved after layer CHECKPOINT_LAYER, loaded and
    finished, its JSON equal to sparse.prove's."""
    from tpu_zk_torch.circuit.layered import tree_sum_circuit
    from tpu_zk_torch.fields import arith
    from tpu_zk_torch.fields.arith import field_ctx
    from tpu_zk_torch.gkr import sparse
    from tpu_zk_torch.poly.multilinear import MultilinearPolynomial
    from tpu_zk_torch.sumcheck.basic import Prover, Verifier
    from tpu_zk_torch.utils.checkpoint import CheckpointableSparseGkrProver, CheckpointableSumcheckProver
    from tpu_zk_torch.utils.serialize import gkr_proof_to_json

    ctx = field_ctx("bn254_fr")
    plain, _ = random_table(ctx, rng, MAIN_LOG_N, device)
    poly = MultilinearPolynomial(ctx, arith.to_mont(ctx, plain))
    del plain
    want = Prover(poly).prove()
    prover = CheckpointableSumcheckProver(poly)
    _, t_run = sync_time(lambda: prover.run(max_rounds=CHECKPOINT_ROUND))
    blob, t_save = sync_time(prover.save)
    del prover
    resumed, t_load = sync_time(lambda: CheckpointableSumcheckProver.load(blob, device))
    proof, t_finish = sync_time(resumed.run)
    if not same_sumcheck_proofs(want, proof) or not Verifier.init().verify(proof):
        raise AssertionError(f"2^{MAIN_LOG_N} sumcheck resumed after round {CHECKPOINT_ROUND}: the proof differs")
    out = {"sumcheck": {"log_n": MAIN_LOG_N, "round": CHECKPOINT_ROUND, "blob_bytes": len(blob), "run_s": t_run,
                        "save_s": t_save, "load_s": t_load, "finish_s": t_finish}}
    del blob, resumed, proof, want, poly

    plain, _ = random_table(ctx, rng, CHECKPOINT_DEPTH, device)
    table = arith.to_mont(ctx, plain)
    del plain
    circuit = tree_sum_circuit(ctx, CHECKPOINT_DEPTH)
    want = gkr_proof_to_json(sparse.prove(circuit, table), ctx.name)
    prover = CheckpointableSparseGkrProver(circuit, table)
    _, t_run = sync_time(lambda: prover.run(max_layers=CHECKPOINT_LAYER))
    blob, t_save = sync_time(prover.save)
    del prover
    resumed, t_load = sync_time(lambda: CheckpointableSparseGkrProver.load(circuit, blob, device))
    proof, t_finish = sync_time(resumed.run)
    if gkr_proof_to_json(proof, ctx.name) != want:
        raise AssertionError(f"GKR depth {CHECKPOINT_DEPTH} resumed after layer {CHECKPOINT_LAYER}: the proof differs")
    out["sparse_gkr"] = {"depth": CHECKPOINT_DEPTH, "layer": CHECKPOINT_LAYER, "blob_bytes": len(blob), "run_s": t_run,
                         "save_s": t_save, "load_s": t_load, "finish_s": t_finish}
    log("checkpoints: " + json.dumps(out))
    return out


def counters_path(device, rng) -> dict:
    """Phase 23: the field-operation counters over one fused 2^20 basic-sumcheck prove."""
    from tpu_zk_torch.fields import arith
    from tpu_zk_torch.fields.arith import field_ctx
    from tpu_zk_torch.poly.multilinear import MultilinearPolynomial
    from tpu_zk_torch.sumcheck.basic import Prover
    from tpu_zk_torch.utils import counters

    ctx = field_ctx("bn254_fr")
    plain, _ = random_table(ctx, rng, COUNTERS_LOG_N, device)
    poly = MultilinearPolynomial(ctx, arith.to_mont(ctx, plain))
    counters.enable(True)
    counters.reset()
    try:
        Prover(poly).prove()
        summary = counters.summary()
    finally:
        counters.enable(False)
    log(f"counters over one fused 2^{COUNTERS_LOG_N} basic-sumcheck prove:")
    counters.print_summary()
    return summary


def roofline_table(times: dict, k56: dict, rates: tuple, lrate: float, card: str) -> str:
    """Phase 23, last: roofline.render_markdown over phase 10's and 21's
    measured kernels, at the probed rates."""
    from tpu_zk_torch.utils import roofline

    N, elem, mul = 1 << MAIN_LOG_N, 64, mont_mul_wide_mads(16)
    models = {
        "K1 sumcheck 2^24 x broadcast": roofline.KernelModel("K1 2^24 x broadcast", 2 * N * elem, N * mul),
        "K2 sumcheck B=1 2^24 -> 2^23": roofline.sumcheck_round_model(MAIN_LOG_N),
        "K3 GKR sub hi - lo 2^25": roofline.KernelModel("K3 sub 2^25", 3 * 2 * N * elem, 0),
        "K3 GKR add 2^25": roofline.KernelModel("K3 add 2^25", 3 * 2 * N * elem, 0),
        "K3 GKR add 2^24 + broadcast": roofline.KernelModel("K3 add 2^24 + broadcast", 2 * N * elem, 0),
        "K1 GKR collapse 2^24 pairs": roofline.KernelModel("K1 2^24 pairs", 3 * N * elem, N * mul),
        "K2 GKR B=4 2^24 -> 2^23": roofline.KernelModel("K2 B=4 2^24 -> 2^23", 4 * (N + N // 2) * elem, 4 * N // 2 * mul),
    }
    rows = [models[what].row(m["ms"] / 1e3, rates, lrate) for what, m in times.items()]
    rows.append(roofline.ntt_model(MAIN_LOG_N).row(sum(k56["K6"]["passes_ms"]) / 1e3, rates, lrate))
    hashes = 2 * N - 1
    k5 = roofline.KernelModel(f"K5 2^{MAIN_LOG_N}-leaf tree", N * 32 + (N - 1) * 64 + hashes * 32, 0,
                              N * keccak_ops(32) + (N - 1) * keccak_ops(64))
    rows.append(k5.row(k56["K5"]["tree_ms"] / 1e3, rates, lrate))
    table = roofline.render_markdown(rows, card)
    log(table)
    return table


# ---------------------------------------------------------------------------
# phase 24: every sharded path (tpu_zk_torch/parallel) with SHARDS shards on the one card

SHARDS = 4  # shards of the mesh, all on cuda:0: each shard's launches and every cross-shard reduction at full size
MSM_SHORT = 3  # the second sharded MSM drops this many points, so that N is not a multiple of SHARDS
ONE_DEVICE: dict = {}  # phases 8, 9, 15, 19 and 20 keep their 2^24 inputs (on the host) and outputs here


def sharded_run(fn, check, mesh=None) -> dict:
    """fn's first and warm call, each held by check(result); the launches
    of the first, counted from 0, the bytes it sent across ``mesh``'s
    process group and the seconds inside those collectives, and the peak
    memory of both."""
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    if mesh is not None:
        mesh.group_bytes, mesh.group_s = 0, 0.0
    got, t_first = sync_time(fn)
    run = {"launches": read_launches()}
    if mesh is not None:
        run["group_bytes"], run["group_s"] = mesh.group_bytes, mesh.group_s
    check(got)
    del got
    got, t_warm = sync_time(fn)
    check(got)
    del got
    return {"first_s": t_first, "warm_s": t_warm, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, **run}


def require(what: str, ok: bool, detail) -> None:
    if not ok:
        raise AssertionError(f"{what}: {detail}")


def sharded_paths(device, card: str, inputs_dir: str) -> dict:
    """Phase 24: each sharded path over a mesh of SHARDS shards on the card,
    held against the one-device outputs of phases 8, 9, 15, 19 and 20 (whose
    inputs come back from the host one at a time); each shard's kernel
    launches counted; times beside the one-device ones.  Each input is
    also written to ``inputs_dir`` (np.save) for phase 25, and
    ``out["digests"]`` keeps what phase 25 must reproduce: the digests
    (:func:`digest`) of phase 24's outputs, each equal, as checked here, to
    its one-device output."""
    from tpu_zk_torch.circuit.layered import tree_sum_circuit
    from tpu_zk_torch.curves.ec_device import DeviceCurve
    from tpu_zk_torch.curves.msm_pippenger import msm_pippenger
    from tpu_zk_torch.fields.arith import field_ctx
    from tpu_zk_torch.fri.fri import FriConfig
    from tpu_zk_torch.merkle.device_merkle import merkle_field_tree
    from tpu_zk_torch.ntt.ntt import NTT
    from tpu_zk_torch.parallel import sharded_fri, sharded_gkr
    from tpu_zk_torch.parallel.dryrun import dryrun_multichip
    from tpu_zk_torch.parallel.mesh import make_mesh
    from tpu_zk_torch.parallel.sharded_merkle import sharded_merkle_field_tree
    from tpu_zk_torch.parallel.sharded_msm import sharded_msm_points
    from tpu_zk_torch.parallel.sharded_ntt import ShardedSixStep
    from tpu_zk_torch.parallel.sharded_sumcheck import ShardedProver
    from tpu_zk_torch.poly.multilinear import MultilinearPolynomial
    from tpu_zk_torch.transcript.fiat_shamir import Transcript
    from tpu_zk_torch.utils.serialize import gkr_proof_to_json

    ctx = field_ctx("bn254_fr")
    mesh = make_mesh(SHARDS, [device])
    D, log_d = mesh.size, mesh.size.bit_length() - 1
    out = {"shards": D, "devices": [str(d) for d in mesh.distinct], "card": card, "digests": {}}
    digests = out["digests"]

    # the basic sumcheck at 2^24 against phase 8's proof (the sharded prover keeps the host transcript)
    one = ONE_DEVICE.pop("sumcheck")
    table, n = one["table"].to(device), MAIN_LOG_N
    np.save(os.path.join(inputs_dir, "sumcheck_table.npy"), one["table"].numpy())
    digests["sumcheck"] = digest(json.dumps([one["claimed"], one["univariates"]]))

    def check_sumcheck(proof):
        require("sharded sumcheck 2^24", proof.initial_claimed_sum == one["claimed"]
                and [u.to_ints() for u in proof.round_univariate_polynomials] == one["univariates"],
                "the proof differs from the one-device proof")

    run = sharded_run(lambda: ShardedProver(MultilinearPolynomial(ctx, table), mesh).prove(),
                      check_sumcheck)
    folds = D * (n - log_d) + log_d - 1  # each shard's K2 a round down to one row a shard, then the D gathered rows
    require("sharded sumcheck 2^24", run["launches"]["fold"] == folds, f"K2 launched {run['launches']['fold']} "
            f"times, not {folds} ({D} shards a round for {n - log_d} rounds, then {log_d - 1})")
    out["sumcheck"] = {"log_n": n, **run, "one_device_fused_warm_s": one["warm_s"],
                       "one_device_host_synced_warm_s": one["host_synced_warm_s"]}
    log("sharded sumcheck 2^24: " + json.dumps(out["sumcheck"]))
    del table, one

    # GKR on tree_sum_circuit(24) against phase 9's proof JSON
    one = ONE_DEVICE.pop("gkr")
    depth = max(GKR_DEPTHS)
    inputs, circuit = one["inputs"].to(device), tree_sum_circuit(ctx, depth)
    np.save(os.path.join(inputs_dir, "gkr_inputs.npy"), one["inputs"].numpy())
    digests["gkr"] = digest(one["json"])
    run = sharded_run(lambda: sharded_gkr.prove(circuit, inputs, mesh),
                      lambda proof: require(f"sharded GKR depth {depth}", gkr_proof_to_json(proof, ctx.name)
                                            == one["json"], "the proof JSON differs from the one-device prove's"))
    rounds = depth * (depth + 1)  # layer i's two phases of i + 1 rounds
    shard_folds = sum(2 * D * (s - log_d) for s in range(1, depth + 1) if 1 << s >= 2 * D)
    require(f"sharded GKR depth {depth}", k7_launches(run["launches"]) == rounds,
            f"K7 launched {k7_launches(run['launches'])} times, not once a round ({rounds})")
    require(f"sharded GKR depth {depth}", run["launches"]["fold"] >= shard_folds,
            f"K2 launched {run['launches']['fold']} times, fewer than each shard's fold every sharded round "
            f"({shard_folds})")
    round_form = round_form_against_byte_form(
        f"sharded GKR depth {depth}", lambda: sharded_gkr.prove(circuit, inputs, mesh), rounds,
        lambda a, b: gkr_proof_to_json(a, ctx.name) == gkr_proof_to_json(b, ctx.name))
    out["gkr"] = {"depth": depth, **run, "k2_shard_folds": shard_folds, "one_device_fused_warm_s": one["warm_s"],
                  "one_device_host_synced_s": one["host_synced_s"], "round_form": round_form}
    log(f"sharded GKR depth {depth} ADD tree: " + json.dumps(out["gkr"]))
    del inputs, circuit, one

    # the MSM at 2^24 against phase 15's point, then 2^24 - MSM_SHORT points against a one-device MSM of them
    one = ONE_DEVICE.pop("msm")
    dc = DeviceCurve("bn254", device=device)
    points, scalars = tuple(c.to(device) for c in one["points"]), one["scalars"].to(device)
    for name, t in zip(("x", "y", "z", "scalars"), (*one["points"], one["scalars"])):
        np.save(os.path.join(inputs_dir, f"msm_{name}.npy"), t.numpy())
    digests["msm"] = one["want"]

    def check_msm(counts: dict, what: str):
        require(what, counts["msm_bucket_reduce"] == D and counts["msm_buckets"] >= 2 * D,
                f"expected K4a's passes and one K4b launch on each of {D} shards, got {counts}")

    run = sharded_run(lambda: sharded_msm_points(dc, mesh, points, scalars),
                      lambda got: require("sharded MSM 2^24", dc.point_to_host(got) == one["want"],
                                          "the point differs from the one-device MSM's"))
    check_msm(run["launches"], "sharded MSM 2^24")
    short = (1 << MSM_LOG_NS[-1]) - MSM_SHORT
    sub_points, sub_scalars = tuple(c[:short] for c in points), scalars[:short]
    want_short, t_short_one = sync_time(lambda: dc.point_to_host(msm_pippenger(dc.ctx, dc.b3, (sub_points, sub_scalars))))
    run_short = sharded_run(lambda: sharded_msm_points(dc, mesh, sub_points, sub_scalars),
                            lambda got: require(f"sharded MSM of {short} points", dc.point_to_host(got) == want_short,
                                                "the point differs from the one-device MSM's"))
    check_msm(run_short["launches"], f"sharded MSM of {short} points")
    digests["msm_short"] = want_short
    out["msm"] = {"points": 1 << MSM_LOG_NS[-1], **run, "one_device_warm_s": one["warm_s"],
                  "short": {"points": short, **run_short, "one_device_first_s": t_short_one}}
    log("sharded MSM bn254: " + json.dumps(out["msm"]))
    del points, scalars, sub_points, sub_scalars, one

    # the NTT at 2^24 against phase 19's forward transform
    one = ONE_DEVICE.pop("ntt")
    table, want = one["table"].to(device), one["forward"].to(device)
    np.save(os.path.join(inputs_dir, "ntt_table.npy"), one["table"].numpy())
    digests["ntt_forward"], digests["ntt_inverse"] = digest(one["forward"]), digest(one["table"])
    plan = NTT("bn254_fr", max(NTT_LOG_NS), device=device).plan(False, device)
    sharded = ShardedSixStep(plan, mesh)
    run = sharded_run(lambda: sharded(table),
                      lambda got: require("sharded NTT 2^24", torch.equal(got, want),
                                          "the transform differs from the one-device plan's"))
    require("sharded NTT 2^24", run["launches"]["dif_pass"] == len(plan.ms) * D,
            f"K6 launched {run['launches']['dif_pass']} times, not once a pass on each shard ({len(plan.ms) * D})")
    out["ntt"] = {"log_n": plan.n_log2, "passes": plan.ms, **run, "warm_ms_events": event_ms(lambda: sharded(table), 5),
                  "one_device_warm_s": one["warm_s"], "one_device_warm_ms_events": one["warm_ms"]}
    log("sharded NTT 2^24: " + json.dumps(out["ntt"]))
    del table, want, plan, sharded, one

    # the Merkle tree over phase 20's 2^24 codeword against the one-device tree (its root is the FRI proof's first)
    one = ONE_DEVICE.pop("fri")
    codeword = one["codeword"].to(device)
    np.save(os.path.join(inputs_dir, "fri_codeword.npy"), one["codeword"].numpy())
    digests["merkle"], digests["fri"] = digest(one["proof"].roots[0]), digest(repr(one["proof"]))
    tree, t_tree_one = sync_time(lambda: merkle_field_tree(ctx, codeword))
    _, t_tree_one_warm = sync_time(lambda: merkle_field_tree(ctx, codeword))
    require("one-device Merkle tree 2^24", tree[-1].cpu().numpy().tobytes() == one["proof"].roots[0],
            "its root is not the FRI proof's first root")
    run = sharded_run(lambda: sharded_merkle_field_tree(ctx, codeword, mesh),
                      lambda got: require("sharded Merkle tree 2^24", len(got) == len(tree)
                                          and all(torch.equal(a, b) for a, b in zip(got, tree)),
                                          "the levels differ from the one-device tree's"))
    leaves = codeword.shape[0]
    k5 = D * ((leaves // D).bit_length()) + log_d  # each shard's levels, then the top log2(D)
    require("sharded Merkle tree 2^24", run["launches"]["keccak_rows"] == k5,
            f"K5 launched {run['launches']['keccak_rows']} times, not {k5}")
    out["merkle"] = {"leaves": leaves, **run, "one_device_first_s": t_tree_one, "one_device_warm_s": t_tree_one_warm}
    log("sharded Merkle tree 2^24: " + json.dumps(out["merkle"]))
    del tree

    # FRI at 2^24, blowup 4, against phase 20's proof
    cfg = FriConfig("bn254_fr", max(FRI_LOG_NS), final_size_log2=4, num_queries=20, blowup_log2=2)
    run = sharded_run(lambda: sharded_fri.prove(cfg, codeword, Transcript(), mesh),
                      lambda proof: require("sharded FRI 2^24", proof == one["proof"],
                                            "the proof differs from the one-device prove's"))
    require("sharded FRI 2^24", run["launches"]["sponge_step"] == cfg.num_rounds and run["launches"]["keccak_rows"] > 0,
            f"expected K5, and K7 once a round ({cfg.num_rounds}), got {run['launches']}")
    out["fri"] = {"log_n": cfg.domain_log2, "rounds": cfg.num_rounds, **run, "one_device_warm_s": one["warm_s"]}
    log("sharded FRI 2^24: " + json.dumps(out["fri"]))
    del codeword, one

    # the dry run: a sharded sumcheck round, the sharded MSM against the host, sharded GKR against one device
    reset_launches()
    _, t_dry = sync_time(lambda: dryrun_multichip(SHARDS, [device]))
    out["dryrun"] = {"s": t_dry, "launches": read_launches()}
    log("dryrun_multichip(4) on the card: " + json.dumps(out["dryrun"]))
    return out


# ---------------------------------------------------------------------------
# phase 25: every sharded path in two processes (a gloo group), each holding 2 of the 4 shards on the one card

TWO_PROCESSES = 2  # ranks of the group; NCCL refuses two ranks on one card, gloo stages through the host
GROUP_TIMEOUT_S = 300  # a collective waiting on a process that is gone fails after this
PHASE25_JOIN_S = 600  # the whole phase; a child still running then fails the script
PROBE_BYTES = 1 << 29  # the transport probe's int64 table a process


def transport_probe(mesh, device) -> dict:
    """Seconds (best of two, both processes in step) of the pieces of gloo's
    transport on a PROBE_BYTES int64 table a process: the copies between
    the card and pageable or pinned host memory, and gloo's all_reduce,
    reduce_scatter_tensor, all_gather (of half the table) and send plus
    receive (half each way) on host tensors."""
    import torch.distributed as dist

    n = PROBE_BYTES // 8
    x = torch.ones(n, dtype=torch.int64, device=device)
    host, pinned = x.cpu(), torch.empty(n, dtype=torch.int64, pin_memory=True)
    mine, gathered = torch.empty(n // 2, dtype=torch.int64), [torch.empty(n // 2, dtype=torch.int64)
                                                              for _ in range(mesh.world)]
    received = torch.empty(n // 2, dtype=torch.int64)
    peer = 1 - mesh.rank

    def swap():
        ops = [dist.P2POp(dist.isend, host[: n // 2], peer), dist.P2POp(dist.irecv, received, peer)]
        for request in dist.batch_isend_irecv(ops):
            request.wait()

    def best(fn) -> float:
        times = []
        for _ in range(2):
            dist.barrier()
            times.append(sync_time(fn)[1])
        return min(times)

    return {"bytes": PROBE_BYTES, "d2h_pageable_s": best(lambda: x.cpu()),
            "d2h_pinned_s": best(lambda: pinned.copy_(x)),
            "h2d_pageable_s": best(lambda: host.to(device)), "h2d_pinned_s": best(lambda: x.copy_(pinned)),
            "gloo_all_reduce_s": best(lambda: dist.all_reduce(host)),
            "gloo_reduce_scatter_s": best(lambda: dist.reduce_scatter_tensor(mine, host)),
            "gloo_all_gather_half_s": best(lambda: dist.all_gather(gathered, host[: n // 2])),
            "gloo_send_recv_half_s": best(swap)}


def digest(x) -> str:
    """sha256 (hex) of a str's UTF-8, of bytes, or of a tensor's bytes."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous().cpu().numpy().reshape(-1).view(np.uint8)
    elif isinstance(x, str):
        x = x.encode()
    return hashlib.sha256(x).hexdigest()


def two_process_child(rank: int, store: str, inputs_dir: str, want: dict, out_dir: str, device: str) -> None:
    """Phase 25 in one process of the group: joins the gloo group, makes
    ``make_mesh(SHARDS, [device])`` (this rank's 2 of the 4 shards on the
    card), loads the kernels phase 2 built, runs every sharded path on
    phase 24's inputs (from ``inputs_dir``, whose sizes set the paths'
    sizes), first call and warm, each
    output's digest held equal to phase 24's (``want``), and writes its
    times, peak memory, launches, bytes sent across the group and digests
    to ``out_dir/<rank>.json``.  Anything that fails raises, and the
    parent's join fails the script."""
    import torch.distributed as dist

    from tpu_zk_torch import _build
    from tpu_zk_torch.circuit.layered import tree_sum_circuit
    from tpu_zk_torch.curves.ec_device import DeviceCurve
    from tpu_zk_torch.fields.arith import field_ctx
    from tpu_zk_torch.fri.fri import FriConfig
    from tpu_zk_torch.ntt.ntt import NTT
    from tpu_zk_torch.parallel import sharded_fri, sharded_gkr
    from tpu_zk_torch.parallel.dryrun import dryrun_multichip
    from tpu_zk_torch.parallel.mesh import init_distributed, make_mesh
    from tpu_zk_torch.parallel.sharded_merkle import sharded_merkle_field_tree
    from tpu_zk_torch.parallel.sharded_msm import sharded_msm_points
    from tpu_zk_torch.parallel.sharded_ntt import ShardedSixStep
    from tpu_zk_torch.parallel.sharded_sumcheck import ShardedProver
    from tpu_zk_torch.poly.multilinear import MultilinearPolynomial
    from tpu_zk_torch.transcript.fiat_shamir import Transcript
    from tpu_zk_torch.utils.serialize import gkr_proof_to_json

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")  # the group's sockets on the loopback: no hostname lookup
    t_start = time.perf_counter()
    device = torch.device(device)
    init_distributed(f"file://{store}", TWO_PROCESSES, rank, backend="gloo", timeout=GROUP_TIMEOUT_S)
    try:
        _build.kernel_library()  # phase 2's build, found by its sources' hash: loaded, not compiled
        mesh = make_mesh(SHARDS, [device])
        ctx = field_ctx("bn254_fr")
        out = {"rank": rank, "shards": list(mesh.local), "paths": {}}

        def load(name: str) -> torch.Tensor:
            return torch.from_numpy(np.load(os.path.join(inputs_dir, f"{name}.npy"))).to(device)

        def run(path: str, fn, keep) -> None:
            kept = []
            r = sharded_run(fn, lambda got: kept.append(keep(got)), mesh)
            require(f"rank {rank}: two-process {path}", kept == [want[path]] * 2,
                    f"{kept} differ from phase 24's {want[path]}")
            out["paths"][path] = {**r, "digest": kept[0]}

        table = load("sumcheck_table")
        run("sumcheck", lambda: ShardedProver(MultilinearPolynomial(ctx, table), mesh).prove(),
            lambda p: digest(json.dumps([p.initial_claimed_sum, [u.to_ints() for u in p.round_univariate_polynomials]])))
        del table
        inputs = load("gkr_inputs")
        circuit = tree_sum_circuit(ctx, inputs.shape[0].bit_length() - 1)
        run("gkr", lambda: sharded_gkr.prove(circuit, inputs, mesh), lambda p: digest(gkr_proof_to_json(p, ctx.name)))
        del inputs, circuit
        dc = DeviceCurve("bn254", device=device)
        points, scalars = tuple(load(f"msm_{c}") for c in "xyz"), load("msm_scalars")
        run("msm", lambda: sharded_msm_points(dc, mesh, points, scalars), dc.point_to_host)
        short = points[0].shape[0] - MSM_SHORT
        run("msm_short", lambda: sharded_msm_points(dc, mesh, tuple(c[:short] for c in points), scalars[:short]),
            dc.point_to_host)
        del points, scalars
        table = load("ntt_table")
        ntt = NTT("bn254_fr", table.shape[0].bit_length() - 1, device=device)
        forward, inverse = (ShardedSixStep(ntt.plan(inv, device), mesh) for inv in (False, True))
        run("ntt_forward", lambda: forward(table), digest)
        transformed = forward(table)
        run("ntt_inverse", lambda: inverse(transformed), digest)
        del table, transformed, forward, inverse
        codeword = load("fri_codeword")
        run("merkle", lambda: sharded_merkle_field_tree(ctx, codeword, mesh), lambda levels: digest(levels[-1]))
        cfg = FriConfig("bn254_fr", codeword.shape[0].bit_length() - 1, final_size_log2=4, num_queries=20,
                        blowup_log2=2)
        run("fri", lambda: sharded_fri.prove(cfg, codeword, Transcript(), mesh), lambda p: digest(repr(p)))
        del codeword
        out["transport"] = transport_probe(mesh, device)
        reset_launches()
        _, t_dry = sync_time(lambda: dryrun_multichip(SHARDS, [device]))
        out["paths"]["dryrun"] = {"first_s": t_dry, "launches": read_launches()}
        out["process_s"] = time.perf_counter() - t_start
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"{rank}.json"), "w") as f:
        json.dump(out, f)


def join_group(procs, timeout: float) -> None:
    """Wait for every process of the group: one that raised fails the wait
    at once (torch's ProcessRaisedException, the others terminated), and so
    does the deadline (TimeoutError).  No process outlives the call."""
    deadline = time.perf_counter() + timeout
    try:
        while not procs.join(timeout=max(deadline - time.perf_counter(), 0.01)):
            if time.perf_counter() >= deadline:
                raise TimeoutError(f"phase 25: the process group did not finish within {timeout} s")
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.kill()
                p.join(10)


def two_process_paths(sharded: dict, inputs_dir: str, device) -> dict:
    """Phase 25: the sharded paths of phase 24 in a group of two processes
    (gloo, a ``file://`` store), each with 2 of the SHARDS shards on the
    card, on phase 24's inputs; each process's outputs equal to phase 24's
    and to the other's; times beside phase 24's."""
    import torch.multiprocessing as mp

    torch.cuda.empty_cache()  # phase 24's tensors are gone: the children get the card's memory
    out_dir = os.path.join(inputs_dir, "out")
    os.makedirs(out_dir)
    t0 = time.perf_counter()
    procs = mp.start_processes(two_process_child, nprocs=TWO_PROCESSES, join=False, start_method="spawn",
                               args=(os.path.join(inputs_dir, "store"), inputs_dir, sharded["digests"], out_dir,
                                     str(device)))
    join_group(procs, PHASE25_JOIN_S)
    wall = time.perf_counter() - t0
    ranks = []
    for rank in range(TWO_PROCESSES):
        with open(os.path.join(out_dir, f"{rank}.json")) as f:
            ranks.append(json.load(f))
    for path, want in sharded["digests"].items():
        got = [r["paths"][path]["digest"] for r in ranks]
        require(f"two-process {path}", all(g == (list(want) if isinstance(want, tuple) else want) for g in got),
                f"the ranks' outputs {got} differ from phase 24's {want} or from each other")
    one_process = {"sumcheck": sharded["sumcheck"], "gkr": sharded["gkr"], "msm": sharded["msm"],
                   "msm_short": sharded["msm"]["short"], "ntt_forward": sharded["ntt"], "merkle": sharded["merkle"],
                   "fri": sharded["fri"], "dryrun": {"first_s": sharded["dryrun"]["s"]}}
    for path in ranks[0]["paths"]:
        row = {f"rank{r['rank']}": {k: v for k, v in r["paths"][path].items() if k != "digest"} for r in ranks}
        if path in one_process:
            row["phase24_one_process"] = {k: one_process[path].get(k) for k in ("first_s", "warm_s", "peak_mem_gib")}
        log(f"two-process {path}: " + json.dumps(row))
    log("two-process transport probe: " + json.dumps({f"rank{r['rank']}": r["transport"] for r in ranks}))
    return {"processes": TWO_PROCESSES, "shards": SHARDS, "wall_s": wall, "ranks": ranks}


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
    launch = launch_latency(device)
    rates = mad_rates(device)
    lrate = logic_rate(device)
    product_probe(device)

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
    k4_main = msm_alone(device, rng, setup, taus, rates)  # 15
    succinct_run = succinct_main_path(device, rng, setup, setup_times)  # 16
    del setup

    t_new = time.perf_counter()
    check_k6(device, gen)  # 17
    check_k5(device, gen)  # 18
    ntt_run = ntt_path(device, gen, rng)  # 19
    fri_parity(device, gen)  # 20
    fri_runs = [fri_path(device, gen, log_n) for log_n in FRI_LOG_NS]
    k56 = k56_times(device, gen, rates, lrate)  # 21
    log(f"phases 17-21 (NTT, Merkle, FRI): {time.perf_counter() - t_new:.1f} s; "
        f"whole script so far {time.perf_counter() - t_script:.1f} s")

    t_new = time.perf_counter()
    check_dense_parity(device, rng)  # 22
    dense_run = dense_path(device, rng, args.seed)
    interactive_run = interactive_path(device, rng)
    log(f"phase 22 (dense GKR, interactive sumcheck): {time.perf_counter() - t_new:.1f} s; "
        f"whole script so far {time.perf_counter() - t_script:.1f} s")
    t_new = time.perf_counter()
    k7 = check_k7(device, args.seed, launch)  # 23
    checkpoint_paths(device, rng)
    counters_path(device, rng)
    roofline_table(times, k56, rates, lrate, smi.stdout.strip())
    log(f"phase 23 (K7, checkpoints, counters, roofline): {time.perf_counter() - t_new:.1f} s; "
        f"whole script so far {time.perf_counter() - t_script:.1f} s")
    with tempfile.TemporaryDirectory() as inputs_dir:  # phase 24's inputs, for phase 25's processes
        t_new = time.perf_counter()
        sharded = sharded_paths(device, smi.stdout.strip(), inputs_dir)  # 24
        log(f"phase 24 (sharded paths, {SHARDS} shards on one card, {sharded['card']}): "
            f"{time.perf_counter() - t_new:.1f} s; whole script so far {time.perf_counter() - t_script:.1f} s")
        t_new = time.perf_counter()
        two = two_process_paths(sharded, inputs_dir, device)  # 25
        log(f"phase 25 (sharded paths, {TWO_PROCESSES} processes x {SHARDS // TWO_PROCESSES} shards on one card, "
            f"{sharded['card']}): {time.perf_counter() - t_new:.1f} s; whole script so far "
            f"{time.perf_counter() - t_script:.1f} s")
    launches = {"sumcheck": sumcheck_runs[0]["launches"], "gkr": gkr_runs[0]["launches"],
                "succinct": succinct_run["launches"], "ntt": ntt_run["launches"], "fri": fri_runs[0]["launches"],
                "dense": dense_run["launches"], "dense_succinct": dense_run["succinct"]["launches"],
                "interactive": interactive_run["launches"],
                **{f"sharded_{path}": sharded[path]["launches"]
                   for path in ("sumcheck", "gkr", "msm", "ntt", "merkle", "fri", "dryrun")},
                **{f"two_process_rank{r['rank']}_{path}": run["launches"]
                   for r in two["ranks"] for path, run in r["paths"].items()}}

    log(json.dumps({"kernels": kernels_line(times, launches, k4_small, k4_main["kernels"], k56, k7, rates)}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
