"""Warm FRI proves of one tpu_zk_torch tree on the card: seconds, host syncs
by place, kernel launches.

    python3 scripts/fri_prove_syncs.py [--tree DIR] [--log-n 24] [--reps 5] [--seed 0]

``--tree`` is the root of a checkout whose ``tpu_zk_torch`` is measured (by
default this one); the helpers come from this checkout's ``chip_smoke.py``
(the codeword of phase 20, the sync count, the launch counts).  Two trees
compare within one call on the card by running the script once a tree, in
the order A, B, B, A: each run builds its tree's kernels, proves once
(first call), ``--reps`` times warm and once more counting host syncs
(torch's sync debug mode at "warn"), and prints one JSON line.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import sys
import time


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=None, help="checkout whose tpu_zk_torch is measured (default: this one)")
    ap.add_argument("--log-n", type=int, default=24)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tree = os.path.abspath(args.tree or here)
    sys.path.insert(0, tree)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("fri_prove_syncs: torch.cuda.is_available() is False; this script needs a CUDA card")
    # this checkout's chip_smoke.py, whatever the tree under test holds
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(here, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from tpu_zk_torch import _build
    from tpu_zk_torch.fields.arith import field_ctx
    from tpu_zk_torch.fri import fri
    from tpu_zk_torch.transcript.fiat_shamir import Transcript

    device = torch.device("cuda:0")
    t0 = time.perf_counter()
    _build.kernel_library()
    _build.keccak_library()
    build_s = time.perf_counter() - t0
    ctx = field_ctx("bn254_fr")
    cfg = fri.FriConfig("bn254_fr", args.log_n, final_size_log2=4, num_queries=20, blowup_log2=2)
    codeword = cs.fri_codeword(ctx, args.log_n, torch.Generator(device=device).manual_seed(args.seed), device)

    def prove():
        return fri.prove(cfg, codeword, Transcript())

    first, t_first = cs.sync_time(prove)
    warm = [cs.sync_time(prove)[1] for _ in range(args.reps)]
    cs.reset_launches()
    (counted, syncs), t_counted = cs.sync_time(lambda: cs.count_syncs(prove))
    launches = cs.read_launches()
    if counted != first or not fri.verify(cfg, first, Transcript()):
        raise AssertionError("the proofs differ, or the proof does not verify")
    print(json.dumps({"tree": os.path.relpath(tree, here), "fri": os.path.relpath(fri.__file__, here),
                      "log_n": args.log_n, "rounds": cfg.num_rounds, "build_s": build_s, "prove_first_s": t_first,
                      "prove_warm_s": warm, "prove_counting_syncs_s": t_counted,
                      "launches_a_prove": {k: v for k, v in launches.items() if v},
                      "proof_sha256": hashlib.sha256(repr(first).encode()).hexdigest(),
                      **cs.sync_report(prove=syncs)}), flush=True)


if __name__ == "__main__":
    main()
