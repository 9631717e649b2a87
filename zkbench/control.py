"""The control of ``correct``: the window's proofs with one guarantee broken.

    python3 zkbench/control.py --workload <name> --seeds <n> [<n> ...] --seconds <s>

Every proof of these cells is a list of canonical BN254 Fr elements (each
below p), bound together by the Fiat-Shamir transcript.  The control keeps
each proof's elements as the unreduced residues v + p, the lazy reduction
that a faster prover would be tempted to hand out; the comparison has to
count it as mismatched.  For each seed: a run of the cell as
``zkbench/run.py`` makes it (``harness.run_cell``), with a window of
``--seconds`` at the cell's own load, whose kept proofs are compared with
the reference both as they are and as the control.  Prints
one JSON line a seed and a last one with the lower reading (the most
mismatches of sound proofs) and the upper one (the fewest of the control's).
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def control_readings(workload: str, seed: int, seconds: float, device, config: dict | None = None) -> dict:
    """One run of the cell as the benchmark makes it, its kept proofs
    compared both as they are and as the control hands them out."""
    from zkbench import harness

    r = harness.run_cell(workload, seed, seconds, False, device, time.perf_counter(), config=config, control=True)
    return {"workload": workload, "seed": seed, "proofs": r["attempted"], "failed": r["failed"],
            "sound_mismatches": r["compared"]["mismatched_elements"]["value"],
            "control_mismatches": r["control"]["mismatches"], "control_rejected": r["control"]["rejected"],
            "elements": r["control"]["elements"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("zkbench control: no CUDA card", file=sys.stderr)
        return 3
    rows = []
    for seed in args.seeds:
        rows.append(control_readings(args.workload, seed, args.seconds, "cuda:0"))
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"workload": args.workload, "lower": max(r["sound_mismatches"] for r in rows),
                      "upper": min(r["control_mismatches"] for r in rows), "seeds": args.seeds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
