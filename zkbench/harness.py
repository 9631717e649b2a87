"""One run of one cell: set-up, a closed-loop window of proofs, the metrics,
and the comparison of the window's proofs with the reference.

Everything a cell needs is found by name from ``BENCHMARK.json``: the
configuration's file (its ``file`` entry), the traffic mix's parameters
(``zkbench/traffic/<mix>.json``), the entry that drives the program
(``zkbench/entries/<entry>.py``, named by the mix) and each metric's reader
(``zkbench/metrics/<metric>.py``).

The window is one prover stream: each proof starts when the last one ends,
cycling through a pool of distinct statements made in set-up.  A reader's
``read(run)`` takes the metric from :class:`Run`; a reader may also keep a
context manager ``during(notes)`` active over a traced window and run
``after(notes, prove_one)`` once the traced window has closed.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import random
import sys
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path

import torch

from . import trace as tracing

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_zk")  # top-level module names that no run may load


def load_benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_parts(bench: dict, workload: str) -> tuple[dict, dict, dict]:
    """(the cell, its configuration's file, its traffic mix's parameters)."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (has {sorted(cells)})")
    cell = cells[workload]
    cfg = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((ROOT / cfg["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    return cell, config, traffic


def metrics_for(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer ones."""
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in reported)]


def reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"zkbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def entry_class(traffic: dict):
    return importlib.import_module(f"zkbench.entries.{traffic['entry']}").Entry


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


@dataclass
class Run:
    """What a window leaves for the metric readers."""

    attempted: int = 0
    raised: int = 0
    latencies_s: list[float] = field(default_factory=list)
    window_s: float = 0.0  # from the first proof's start to the last one's end
    setup_s: float = 0.0
    peak_bytes: int | None = None  # device memory's peak over the window
    device_ops: list | None = None  # traced: (name, start_ns, end_ns) of every device operation
    notes: dict = field(default_factory=dict)  # what the readers' hooks left

    @property
    def proofs(self) -> int:
        return self.attempted - self.raised

    def device_s(self, *names: str) -> float | None:
        """Device seconds of the operations whose names hold any of ``names``;
        None where the trace holds none of them."""
        spans = [(e - s) for n, s, e in self.device_ops or [] if any(k in n for k in names)]
        return sum(spans) / 1e9 if spans else None

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in tracing.merged(self.device_ops or [])) / 1e9


class Keeper:
    """The proofs of the window that are compared: all of them (``check`` 0)
    or ``check`` of them drawn uniformly from the seed (reservoir sampling)."""

    def __init__(self, check: int, seed: int):
        self.check = check
        self.rng = random.Random(f"{seed}/check")
        self.kept: list[tuple[int, int, object]] = []  # (position, statement, proof)
        self.seen = 0

    def offer(self, position: int, statement: int, proof) -> None:
        self.seen += 1
        if not self.check or len(self.kept) < self.check:
            self.kept.append((position, statement, proof))
            return
        j = self.rng.randrange(self.seen)
        if j < self.check:
            self.kept[j] = (position, statement, proof)


def _sync(device: torch.device):
    return torch.cuda.synchronize if device.type == "cuda" else (lambda: None)


def window(entry, pool: list, seconds: float, max_proofs: int, keeper: Keeper, device, run: Run) -> None:
    sync = _sync(device)
    t0 = time.perf_counter()
    t_end = t0
    while time.perf_counter() - t0 < seconds and run.attempted < max_proofs:
        k = run.attempted % len(pool)
        start = time.perf_counter()
        try:
            with torch.profiler.record_function("zkbench.proof"):
                proof = entry.prove(pool[k])
            sync()
        except Exception:  # a proof that raises is a failed proof; the stream goes on
            traceback.print_exc()
            run.raised += 1
            proof = None
        t_end = time.perf_counter()
        run.latencies_s.append(t_end - start)
        if proof is not None:
            keeper.offer(run.attempted, k, proof)
        run.attempted += 1
    run.window_s = t_end - t0


def compare(entry, keeper: Keeper, plain=None) -> dict:
    """Every kept proof against the reference of its statement; proofs equal
    to one already judged share its verdict.  ``plain`` turns a proof into
    the reference's plain data (the entry's own by default)."""
    plain_of = plain or entry.plain
    judges: dict[int, object] = {}
    verdicts: dict[tuple, tuple] = {}
    mismatches = rejected = 0
    checked = 0
    firsts: list[str] = []
    for position, k, proof in keeper.kept:
        plain = plain_of(proof)
        key = (k, repr(plain))
        if key not in verdicts:
            if k not in judges:
                judges[k] = entry.reference(k)
            try:
                tally = judges[k](plain)
                verdicts[key] = (tally.mismatches, tally.checked, tally.first)
            except Exception:  # a proof of the wrong shape
                traceback.print_exc()
                verdicts[key] = (1, 1, [f"proof {position}: the reference could not read it"])
        m, c, first = verdicts[key]
        mismatches += m
        checked += c
        rejected += bool(m)
        firsts += [f"proof {position}: {w}" for w in first][: max(0, 8 - len(firsts))]
    return {"mismatches": mismatches, "elements": checked, "proofs": len(keeper.kept), "rejected": rejected,
            "first": firsts}


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device, t_start: float,
             bench: dict | None = None, config: dict | None = None, control: bool = False) -> dict:
    """One run; returns the result line's object.  ``config`` replaces the
    configuration's file (the tests' small sizes).  With ``control`` the
    kept proofs are also compared as the control hands them out (each field
    element v + p), under the key ``control``; no run of the benchmark
    does that."""
    bench = bench or load_benchmark()
    cell, cfg_file, traffic = cell_parts(bench, workload)
    config = config or cfg_file
    device = torch.device(device)
    on_card = device.type == "cuda"
    metrics = metrics_for(bench, workload, trace)
    readers = {m["name"]: reader(m["name"]) for m in metrics}

    entry = entry_class(traffic)(config, traffic, seed, device)
    pool = [entry.inputs(k) for k in range(traffic["pool"])]
    entry.prove(pool[0])  # the cell's one shape, warmed
    _sync(device)()
    run = Run(setup_s=time.perf_counter() - t_start)
    setup_peak = 0
    if on_card:
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()

    keeper = Keeper(traffic["check"], seed)
    max_proofs = traffic["trace_proofs"] if trace else 1 << 62
    if trace:
        activities = [torch.profiler.ProfilerActivity.CPU] + ([torch.profiler.ProfilerActivity.CUDA] if on_card else [])
        with contextlib.ExitStack() as hooks:
            for r in readers.values():
                if hasattr(r, "during"):
                    hooks.enter_context(r.during(run.notes))
            with torch.profiler.profile(activities=activities) as prof:
                window(entry, pool, seconds, max_proofs, keeper, device, run)
        run.device_ops, host_ops = tracing.events(prof)
        del prof
    else:
        window(entry, pool, seconds, max_proofs, keeper, device, run)
    if on_card:
        run.peak_bytes = torch.cuda.max_memory_allocated()

    if trace:
        def prove_one():
            out = entry.prove(pool[0])
            _sync(device)()
            return out

        for r in readers.values():
            if hasattr(r, "after"):
                r.after(run.notes, prove_one)

    values = {}
    for m in metrics:
        v = readers[m["name"]].read(run)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}

    result = {"correct": False, "attempted": run.attempted, "failed": run.raised, "metrics": values,
              "device": {"platform": "gpu" if on_card else device.type,
                         "kind": torch.cuda.get_device_name(device) if on_card else device.type,
                         "count": cell["chips"],
                         "memory_peak_bytes": max(setup_peak, run.peak_bytes or 0)}}
    if trace:
        intervals = tracing.merged(run.device_ops)
        result["device"]["busy_s"] = run.busy_s
        result["device"]["window_s"] = run.window_s
        result["breakdown"] = {"device_ops": tracing.by_name(run.device_ops),
                               "idle_gaps": tracing.idle_by_host(intervals, host_ops)}
        del host_ops

    # the program's state goes before the reference runs on the same card
    entry.close()
    del pool
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    verdict = compare(entry, keeper)
    print(f"reference check: {time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    if control:
        result["control"] = compare(entry, keeper, plain=lambda proof: entry.unreduced(entry.plain(proof)))
    result["failed"] = run.raised + verdict["rejected"]
    result["correct"] = result["failed"] == 0 and verdict["mismatches"] == 0 and verdict["proofs"] > 0
    result["compared"] = {"mismatched_elements": {"value": verdict["mismatches"], "limit": 0},
                          "proofs_compared": {"value": verdict["proofs"], "limit": 1}}
    for line in verdict["first"]:
        print(f"mismatch: {line}", file=sys.stderr)
    print(f"compared {verdict['elements']} elements of {verdict['proofs']} proofs "
          f"({verdict['rejected']} rejected)", file=sys.stderr)
    return result
