"""Run one cell of the benchmark once, on the CUDA cards of this machine.

    python3 zkbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON object as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` a
``breakdown``, and last ``compared``: each number that decides ``correct``
beside its limit, which also end standard error.  Exits non-zero, with no
result, where there is no card (or fewer than the cell asks for), where a
run raises outside its proofs, or where JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    import torch

    from zkbench import harness

    bench = harness.load_benchmark()
    cell, _, _ = harness.cell_parts(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"zkbench: {args.workload} needs {cell['chips']} CUDA card(s), found {found}", file=sys.stderr)
        return 3
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0", T_START, bench)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"zkbench: the run loaded {', '.join(loaded)}, which no run may load", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    for name, c in result["compared"].items():
        print(f"compared: {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
