"""Where the time of a warm GKR prove goes, stage by stage; with
``--succinct``, where the time of a succinct GKR setup, prove and verify goes;
with ``--dense``, where the time of a dense GKR prove and verify goes.

    python3 -m tpu_zk_torch.gkr.breakdown [--succinct | --dense] [--host-synced] [--out FILE] [depth ...]

For each depth (default 24) of ``tree_sum_circuit`` over BN254 Fr, on random
canonical inputs made from the depth as seed, on the CUDA card, with the
fused prover (``FUSED_STAGES``) or, with ``--host-synced``, ``fused=False``
(``STAGES``): a warm-up prove that must verify, three timed warm proves and two timed verifies; one
prove with a synchronizing timer at every stage boundary (exclusive times,
calls per stage, time per layer); one prove under ``torch.profiler`` for the
device's busy time, idle share and time by kernel name.  Prints one JSON
line per depth and writes all of them to ``--out``
(``build/gkr_breakdown.json`` by default).

With ``--succinct`` (:func:`run_succinct`): the trusted setup, a warm-up
``prove_succinct`` that must verify, then one setup, one prove and one
verify with the stage timers of ``SUCCINCT_STAGES`` added (commit, each
open, the MSM's digits, sort, unit tables, K4a, K4b, window sums and
window combine, the verifier's host points and pairing product), and
beside the exclusive times the inclusive ones of the commit, the two opens,
the layers and the circuit evaluation.

With ``--dense`` (:func:`run_dense`; depths up to 9 fit an 80 GB card): a
first and two warm calls each of ``protocol.prove`` and ``protocol.verify``,
then one of each with the timers of ``DENSE_STAGES`` (the wiring build, the
alpha/beta folds, the layer polynomial, the sumcheck rounds, the split-half
evaluations, the verifier's expected layer claims).

The stage timers wrap module attributes for the one timed prove and put
them back after it; the prover itself carries no instrumentation.  On a
CPU tensor (``run(depth, device="cpu")``) the same stages run without
synchronization and the profiler sees no device, so busy and idle are None.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import subprocess
import time

import numpy as np
import torch

from ..circuit import layered
from ..circuit.layered import tree_sum_circuit
from ..curves import msm_pippenger
from ..curves.ec_device import DeviceCurve
from ..fields import arith
from ..fields.arith import field_ctx
from ..kzg import multilinear_kzg, trusted_setup
from ..poly import univariate
from ..sumcheck import fused, gkr_sumcheck
from ..transcript import fiat_shamir
from ..utils.convert import limbs_from_numpy
from . import protocol, sparse, wiring

# (owner, attribute, stage): the functions whose exclusive time is a stage, in either prover
_COMMON_STAGES = [
    (layered.Circuit, "evaluate", "circuit evaluation"),
    (sparse, "_out_weights", "phase tables: out weights (eq tables)"),
    (sparse, "_phase1_tables", "phase tables: phase 1 gathers, products"),
    (sparse, "_phase2_tables", "phase tables: phase 2 eq table, gathers, products"),
    (arith, "mont_segment_sum", "segment sums (int64 index_add_, carry, redc_wide, K1 R^2)"),
    (fused, "_round_lazy_sums", "round evaluations (K3, K1, int64 sums)"),
    (fiat_shamir.Transcript, "append", "host transcript (Keccak absorb)"),
    (fiat_shamir.Transcript, "random_challenge_as_field_element", "host transcript (squeeze)"),
    (gkr_sumcheck, "fold", "folds (K2)"),
    (fused, "fold", "folds (K2)"),
    (sparse, "_layer_sumcheck", "layer sumcheck, rest (stacks, w(b*) + w, M' w(b*))"),
]
# the host-synced prover's (fused=False) stages
STAGES = _COMMON_STAGES + [
    (arith, "lazy_to_ints", "host copy of round sums + int reduction"),
    (univariate.DenseUnivariatePolynomial, "lagrange_interpolate", "host interpolation"),
]
# the fused prover's (the default) stages
FUSED_STAGES = _COMMON_STAGES + [
    (fused, "_interpolate_mont", "device interpolation (K1, K3)"),
    (fused, "sponge_round", "device sponge (K7)"),
    (gkr_sumcheck, "_prove_fused", "fused phase, rest (sponge seed, reduction, one copy of coefficients and digests)"),
]

# the stages of the succinct path on top of the GKR ones
SUCCINCT_STAGES = FUSED_STAGES + [
    (trusted_setup, "compute_lagrange_basis_device", "setup: Lagrange basis (K1)"),
    (trusted_setup, "host_window_table", "setup: host window table"),
    (trusted_setup, "fixed_base_msm", "setup: fixed-base G1 powers (K1, K3)"),
    (trusted_setup, "_fold_chain", "setup: fold chain of the G1 powers (K1, K3)"),
    (sparse, "_prove_layers", "prove: layers, rest"),
    (multilinear_kzg, "commit_to_polynomial", "commit, rest (from_mont)"),
    (multilinear_kzg, "open_and_prove", "open, rest (evaluate, quotients, folds)"),
    (msm_pippenger, "signed_digits", "msm: signed digits"),
    (msm_pippenger, "_bucket_entries", "msm: sort into buckets"),
    (msm_pippenger, "_unit_table", "msm: unit tables"),
    (msm_pippenger, "msm_buckets", "msm: K4a unit sums"),
    (msm_pippenger, "msm_bucket_reduce", "msm: K4b segment reduce"),
    (msm_pippenger, "_window_sums", "msm: window sums, rest"),
    (msm_pippenger, "_combine_windows", "msm: window combine (host ints)"),
    (DeviceCurve, "point_to_host", "msm: result to affine host ints"),
    (multilinear_kzg, "pairing_pairs", "verify: host G1/G2 points (Python ints)"),
    (multilinear_kzg, "pairing_product_is_one", "verify: native pairing product"),
    (sparse, "_verify_layers", "verify: layers"),
]


# the stages of the dense pipeline (gkr/protocol.py), prover and verifier, on top of the GKR ones
DENSE_STAGES = FUSED_STAGES + [
    (layered.Circuit, "wiring_table", "wiring build (zeroed pair, scatter of ones)"),
    (wiring.WiringPair, "alpha_beta_fold", "alpha/beta folds (K2 a point, K1, K3)"),
    (protocol, "_layer_wiring", "layer wiring, rest (layer 0: partial evaluation at ra, K2)"),
    (protocol, "layer_polynomial", "layer polynomial (tensor_add K3, tensor_mul K1, stacks)"),
    (gkr_sumcheck, "prove", "sumcheck rounds, rest"),
    (protocol, "split_half_evaluations", "split-half evaluations (K2)"),
    (protocol, "expected_layer_claim", "verify: expected layer claim, rest (wiring evaluation folds, K2)"),
    (gkr_sumcheck, "verify", "verify: sumcheck rounds, rest (host)"),
]


class Timers:
    """Exclusive wall time and calls per stage, the inclusive wall time of
    each call of each stage, and the wall time of each ``_layer_sumcheck``
    call by its input table's size."""

    def __init__(self, device: torch.device, stages=None):
        self.stages = FUSED_STAGES if stages is None else stages
        self.sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
        self.total: dict[str, float] = collections.defaultdict(float)  # exclusive of the stages called inside
        self.each: dict[str, list[float]] = collections.defaultdict(list)  # inclusive, call by call
        self.calls: collections.Counter = collections.Counter()
        self.layers: list[tuple[int, float]] = []
        self._stack: list[float] = []
        self._layer_fn = sparse._layer_sumcheck

    def _timed(self, fn, stage: str):
        def timed(*a, **k):
            self.sync()
            t0 = time.perf_counter()
            self._stack.append(0.0)
            try:
                return fn(*a, **k)
            finally:
                self.sync()
                dt = time.perf_counter() - t0
                self.total[stage] += dt - self._stack.pop()
                self.each[stage].append(dt)
                self.calls[stage] += 1
                if self._stack:
                    self._stack[-1] += dt
                if fn is self._layer_fn:  # (ctx, layer, w_table, ...)
                    self.layers.append((int(a[2].shape[0]), dt))

        return timed

    @contextlib.contextmanager
    def installed(self):
        """Every STAGES function wrapped while the block runs."""
        saved = [(owner, name, vars(owner)[name]) for owner, name, _ in self.stages]
        try:
            for owner, name, stage in self.stages:
                setattr(owner, name, self._timed(getattr(owner, name), stage))
            yield self
        finally:
            for owner, name, raw in saved:
                setattr(owner, name, raw)


def _timed_runs(fn, n: int, sync) -> list[float]:
    out = []
    for _ in range(n):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        out.append(time.perf_counter() - t0)
    return out


def random_inputs(ctx, depth: int, device) -> torch.Tensor:
    """2^depth random canonical BN254 Fr values in Montgomery form on
    ``device``, made from the depth as seed."""
    rng = np.random.default_rng(depth)
    limbs = rng.integers(0, 1 << 16, size=(1 << depth, ctx.L), dtype=np.uint32)
    limbs[:, -1] &= 0x2FFF  # top limb < 0x3000 < p's (0x3064): every value < p
    return arith.to_mont(ctx, limbs_from_numpy(limbs, device))


def run(depth: int, device="cuda", fused: bool = True) -> dict:
    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    ctx = field_ctx("bn254_fr")
    table = random_inputs(ctx, depth, device)
    circuit = tree_sum_circuit(ctx, depth)
    timers = Timers(device, FUSED_STAGES if fused else STAGES)
    out: dict = {"depth": depth, "fused": fused}

    def prove():
        return sparse.prove(circuit, table, fused=fused)

    proof = prove()  # warm-up
    if not sparse.verify(circuit, proof, table):
        raise AssertionError(f"depth {depth}: the warm-up proof does not verify")
    out["prove_warm_s"] = _timed_runs(prove, 3, timers.sync)
    out["verify_warm_s"] = _timed_runs(lambda: sparse.verify(circuit, proof, table), 2, timers.sync)

    with timers.installed():
        out["prove_with_timers_s"] = _timed_runs(prove, 1, timers.sync)[0]
    out["stages_s"] = dict(sorted(timers.total.items(), key=lambda kv: -kv[1]))
    out["stage_calls"] = dict(timers.calls)
    out["layer_s_by_table_size"] = timers.layers

    activities = [torch.profiler.ProfilerActivity.CPU] + ([torch.profiler.ProfilerActivity.CUDA] if on_card else [])
    with torch.profiler.profile(activities=activities) as prof:
        out["profiled_prove_s"] = _timed_runs(prove, 1, timers.sync)[0]
    by_kernel: dict[str, float] = collections.defaultdict(float)
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[evt.name[:80]] += evt.time_range.elapsed_us() / 1e6
    busy = sum(by_kernel.values())
    out["device_busy_s"] = busy if on_card else None
    out["device_idle_share"] = 1 - busy / out["profiled_prove_s"] if on_card else None
    out["top_device_ops_s"] = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:25]
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30 if on_card else None
    return out


# the stages that contain others: their inclusive times set commit, each open,
# the layers and the circuit evaluation apart
WHOLE_STAGES = ("commit, rest (from_mont)", "open, rest (evaluate, quotients, folds)", "prove: layers, rest",
                "circuit evaluation", "verify: layers")


def staged(fn, device, stages=None):
    """(fn(), exclusive seconds per stage, calls per stage, per stage the
    inclusive seconds of each call) with the stage timers installed around
    the one call."""
    timers = Timers(torch.device(device), stages)
    with timers.installed():
        out = fn()
    return out, dict(sorted(timers.total.items(), key=lambda kv: -kv[1])), dict(timers.calls), dict(timers.each)


def whole_s(each: dict) -> dict:
    """The inclusive seconds of the WHOLE_STAGES that ran, from ``staged``'s
    per-call times."""
    return {stage.split(",")[0]: sum(each[stage]) for stage in WHOLE_STAGES if stage in each}


def run_succinct(depth: int, device="cuda", seed: int = 0) -> dict:
    """Setup, ``prove_succinct`` and ``verify_succinct`` of
    ``tree_sum_circuit(depth)`` over BN254, each once under the stage timers
    after an untimed warm-up."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    ctx = field_ctx("bn254_fr")
    table = random_inputs(ctx, depth, device)
    circuit = tree_sum_circuit(ctx, depth)
    taus = trusted_setup.generate_values_for_tau("bn254", depth, seed=seed)
    out: dict = {"depth": depth}

    def make_setup():
        setup = trusted_setup.TrustedSetup.initialize_setup("bn254", taus, device=device)
        setup.folded_g1_bases()
        return setup

    setup = make_setup()  # warm-up
    proof = sparse.prove_succinct(circuit, table, setup)
    if not sparse.verify_succinct(circuit, proof, setup):
        raise AssertionError(f"depth {depth}: the warm-up succinct proof does not verify")
    del setup
    for what, fn in (("setup", make_setup), ("prove", lambda: sparse.prove_succinct(circuit, table, setup)),
                     ("verify", lambda: sparse.verify_succinct(circuit, proof, setup))):
        sync()
        t0 = time.perf_counter()
        result, stages_s, calls, each = staged(fn, device, SUCCINCT_STAGES)
        sync()
        out[f"{what}_with_timers_s"] = time.perf_counter() - t0
        out[f"{what}_stages_s"] = stages_s
        out[f"{what}_stage_calls"] = calls
        out[f"{what}_whole_s"] = whole_s(each)
        if what == "setup":
            setup = result
        elif what == "verify" and result is not True:
            raise AssertionError(f"depth {depth}: the timed succinct proof does not verify")
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30 if on_card else None
    return out


def run_dense(depth: int, device="cuda") -> dict:
    """``protocol.prove`` and ``protocol.verify`` of ``tree_sum_circuit(depth)``
    over BN254 Fr: first call, two warm calls, then one call each under the
    ``DENSE_STAGES`` timers."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    ctx = field_ctx("bn254_fr")
    table = random_inputs(ctx, depth, device)
    circuit = tree_sum_circuit(ctx, depth)
    out: dict = {"depth": depth}

    sync()
    t0 = time.perf_counter()
    proof = protocol.prove(circuit, table)
    sync()
    out["prove_first_s"] = time.perf_counter() - t0
    out["verify_first_s"] = _timed_runs(lambda: protocol.verify(circuit, proof, table), 1, sync)[0]
    out["prove_warm_s"] = _timed_runs(lambda: protocol.prove(circuit, table), 2, sync)
    out["verify_warm_s"] = _timed_runs(lambda: protocol.verify(circuit, proof, table), 2, sync)
    for what, fn in (("prove", lambda: protocol.prove(circuit, table)),
                     ("verify", lambda: protocol.verify(circuit, proof, table))):
        sync()
        t0 = time.perf_counter()
        result, stages_s, calls, _ = staged(fn, device, DENSE_STAGES)
        sync()
        out[f"{what}_with_timers_s"] = time.perf_counter() - t0
        out[f"{what}_stages_s"] = stages_s
        out[f"{what}_stage_calls"] = calls
    if result is not True:
        raise AssertionError(f"depth {depth}: the dense proof does not verify")
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30 if on_card else None
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("depths", type=int, nargs="*", default=[24])
    path = ap.add_mutually_exclusive_group()
    path.add_argument("--succinct", action="store_true", help="break down the succinct path instead of plain GKR")
    path.add_argument("--dense", action="store_true", help="break down the dense GKR pipeline (depth 9 at most)")
    ap.add_argument("--host-synced", action="store_true", help="plain GKR with fused=False (a host sync a round)")
    ap.add_argument("--out", default=os.path.join("build", "gkr_breakdown.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("breakdown: torch.cuda.is_available() is False; this measures a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip()
    print(card, flush=True)
    results = {"card": card, "runs": []}
    for depth in args.depths:
        r = (run_succinct(depth) if args.succinct else run_dense(depth) if args.dense
             else run(depth, fused=not args.host_synced))
        results["runs"].append(r)
        print(json.dumps({k: v for k, v in r.items() if k not in ("layer_s_by_table_size", "top_device_ops_s")}),
              flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
