"""tpu_zk_torch.parallel over a process group: two gloo processes on the CPU.

One module fixture spawns a group of two processes (the ``spawn`` start
method, a ``file://`` store under the test's temporary directory, the
group's timeout and a join timeout).  Each process runs every case over
meshes of D = 2 and D = 4 shards (one and two shards a process): each
collective of :mod:`tpu_zk_torch.parallel.mesh`, the sharded basic sumcheck
(2^6, 2^8 and N = 2D), the sharded MSM (13 and 61 points), the sharded
Merkle tree (2^8 leaves), the sharded NTT (2^10 in two and in three passes,
forward and inverse), sharded FRI (a 2^8 domain), sharded GKR
(``tree_sum_circuit`` of depth 4, ADD and MUL, BN254 Fr) and
``dryrun_multichip(4)``; then it writes its outputs back.  Meanwhile this
process computes the one-process mesh's outputs on the same inputs, with
``tests/test_torch_parallel.py``'s helpers, whose one-process outputs that
file holds against tpu_zk.  Each process's output must equal the
one-process output, and the two processes' outputs each other: integer and
byte arithmetic, tolerance zero.
"""

import datetime
import os
import pickle
import signal
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from tests import test_torch_parallel as tp
from tpu_zk_torch.circuit.layered import ADD, MUL
from tpu_zk_torch.parallel import mesh as tmesh
from tpu_zk_torch.parallel import sharded_ntt
from tpu_zk_torch.parallel.dryrun import dryrun_multichip

WORLD = 2
SHARDS = [2, 4]  # one and two shards a process
GROUP_TIMEOUT_S = 60  # a collective waiting on a process that is gone fails after this
JOIN_TIMEOUT_S = 180  # the whole group's work, with room for a loaded machine
GKR_FIELD = "bn254_fr"
CASES = [("collectives", d) for d in SHARDS] + [
    ("sumcheck", n, d) for d in SHARDS for n in [1 << log for log in tp.SUMCHECK_LOGS] + [2 * d]
] + [("msm", n, d) for d in SHARDS for n in tp.MSM_SIZES] + [("merkle", d) for d in SHARDS] + [
    ("ntt", passes, d) for d in SHARDS for passes in tp.NTT_MAX_LOGS
] + [("fri", d) for d in SHARDS] + [("gkr", op, d) for d in SHARDS for op in ("add", "mul")]


def _local(mesh: tmesh.Mesh, parts: list) -> dict:
    """This process's entries of a sharded array; the others must be None."""
    assert [i for i, p in enumerate(parts) if p is not None] == list(mesh.local)
    return {i: parts[i] for i in mesh.local}


def _sources(d: int) -> list:
    """The exchange's pieces: shard j reads 2 rows of shard j + 1, 2 of
    shard d - 1 - j and, as FRI's fold does, half of shard j // 2's 8 rows."""
    return [[((j + 1) % d, slice(0, 2)), (d - 1 - j, slice(3, 5)), (j // 2, slice((j % 2) * 4, (j % 2 + 1) * 4))]
            for j in range(d)]


def _collectives(mesh: tmesh.Mesh) -> dict:
    """Every collective of the mesh on fixed int64 tensors: the replicated
    results whole, the sharded ones as this process's shards, and the bytes
    each collective sent to the other processes."""
    d = mesh.size
    t = torch.arange(8 * d * 4, dtype=torch.int64).view(8 * d, 4)
    parts = tmesh.shard_leading(mesh, t)
    out, sent = {"local": mesh.local, "shard_leading": _local(mesh, parts)}, {}
    for name, fn in {
        "gather": lambda: tmesh.gather(mesh, parts),
        "gather dim 1": lambda: tmesh.gather(mesh, parts, dim=1),
        "all_shards": lambda: tmesh.all_shards(mesh, parts),
        "cross_shard_sum": lambda: tmesh.cross_shard_sum(mesh, parts),
        "reduce_scatter": lambda: _local(mesh, tmesh.reduce_scatter(mesh, (t * (k + 1) for k in mesh.local))),
        "all_to_all": lambda: _local(mesh, tmesh.all_to_all(mesh, parts, split_dim=0, concat_dim=1)),
        "all_to_all 1 -> 0": lambda: _local(mesh, tmesh.all_to_all(mesh, parts, split_dim=1, concat_dim=0)),
        "exchange": lambda: _local(mesh, tmesh.exchange(mesh, parts, _sources(d))),
    }.items():
        mesh.group_bytes = 0
        out[name] = fn()
        sent[name] = mesh.group_bytes
    out["replicated"] = list(tmesh.replicated(mesh, t).values())
    return {"outputs": out, "sent": sent, "seconds": mesh.group_s}


def _run_case(case: tuple):
    """One case's output over ``tp._mesh(d)``: the group's mesh in a process
    of the group, the one-process mesh here."""
    kind, *args, d = case
    if kind == "collectives":
        return _collectives(tp._mesh(d))
    if kind == "sumcheck":
        return tp._sumcheck(args[0], d)[1]
    if kind == "msm":
        return tp._msm(args[0], d)
    if kind == "merkle":
        return tp._merkle(d)
    if kind == "ntt":
        forward = tp._ntt(args[0], d)
        return forward, sharded_ntt.sharded_sixstep(tp._ntt_plans(args[0])[1], forward, tp._mesh(d))
    if kind == "fri":
        proof, snapshot = tp._fri(d)
        return tp._fri_tuples(proof), snapshot
    return tp._gkr(GKR_FIELD, {"add": ADD, "mul": MUL}[args[0]], tp.GKR_DEPTH, d)


def _group_child(rank: int, store: str, out_dir: str) -> None:
    """A process of the group: every case, then dryrun_multichip(4), its
    outputs pickled to ``out_dir/<rank>.pkl``."""
    torch.set_num_threads(1)
    assert tmesh.init_distributed(f"file://{store}", WORLD, rank, backend="gloo", timeout=GROUP_TIMEOUT_S)
    try:
        assert tp._mesh(4).local == (2 * rank, 2 * rank + 1)
        out = {case: _run_case(case) for case in CASES}
        dryrun_multichip(4, ["cpu"])  # asserts its three checks in every process
        out["dryrun"] = True
    finally:
        dist.destroy_process_group()
    with open(f"{out_dir}/{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


def _join(procs, timeout: float) -> None:
    """Wait for every process; a process that raised fails the wait at once
    (``ProcessRaisedException``, the others killed), and so does the
    deadline (TimeoutError).  No process outlives the call."""
    deadline = time.monotonic() + timeout
    try:
        while not procs.join(timeout=max(deadline - time.monotonic(), 0.01)):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"the process group did not finish within {timeout} s")
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.kill()
                p.join(10)


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """{"group": [rank 0's outputs, rank 1's], "one": the one-process
    mesh's}: the group runs while this process computes its outputs."""
    d = tmp_path_factory.mktemp("group")
    procs = mp.start_processes(_group_child, args=(str(d / "store"), str(d)), nprocs=WORLD, join=False,
                               start_method="spawn")
    try:
        one = {case: _run_case(case) for case in CASES}
    finally:
        _join(procs, JOIN_TIMEOUT_S)
    return {"one": one, "group": [pickle.loads((d / f"{rank}.pkl").read_bytes()) for rank in range(WORLD)]}


def _same(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b)
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


# ---------------------------------------------------------------------------
# init_distributed


def test_init_distributed_forms_the_init_method(monkeypatch):
    """Addresses, world size and rank as init_process_group receives them;
    no group is formed."""
    calls = []
    monkeypatch.setattr(dist, "init_process_group", lambda backend, **kw: calls.append((backend, kw)))
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert tmesh.init_distributed("localhost:29400", 2, 1, backend="gloo", timeout=5)
    assert tmesh.init_distributed("file:///tmp/store", 4, 3, backend="gloo")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("WORLD_SIZE", "3")
    monkeypatch.setenv("RANK", "2")
    assert tmesh.init_distributed(backend="gloo")
    assert calls == [
        ("gloo", {"init_method": "tcp://localhost:29400", "world_size": 2, "rank": 1,
                  "timeout": datetime.timedelta(seconds=5)}),
        ("gloo", {"init_method": "file:///tmp/store", "world_size": 4, "rank": 3, "timeout": None}),
        ("gloo", {"init_method": "env://", "world_size": 3, "rank": 2, "timeout": None}),
    ]


def test_default_backend_is_nccl(tmp_path, monkeypatch):
    """Nothing picks gloo by itself: where torch has no NCCL the default
    raises before any group forms."""
    monkeypatch.setattr(dist, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match="NCCL"):
        tmesh.init_distributed(f"file://{tmp_path}/store", 2, 0)
    assert not dist.is_initialized()


def _failing_child(rank: int, store: str) -> None:
    assert tmesh.init_distributed(f"file://{store}", WORLD, rank, backend="gloo", timeout=GROUP_TIMEOUT_S)
    if rank == 1:
        raise ValueError("rank 1 fails before its collective")
    dist.all_reduce(torch.zeros(1))  # rank 0 waits on rank 1


def _wait_all(procs, timeout: float) -> dict:
    """Wait for every process to end by itself (those alive at the deadline
    are killed); rank -> the traceback that each process that raised wrote
    to its error file."""
    deadline = time.monotonic() + timeout
    for p in procs.processes:
        p.join(max(deadline - time.monotonic(), 0.01))
    for p in procs.processes:
        if p.is_alive():
            p.kill()
            p.join(10)
    errors = {}
    for rank, path in enumerate(procs.error_files):
        if os.path.exists(path):
            with open(path, "rb") as f:
                errors[rank] = pickle.load(f)
            os.remove(path)
    return errors


def test_a_failing_process_fails_the_group_within_the_timeout(tmp_path):
    """Rank 1 raises before its collective: every process has ended, by
    itself, within the group's timeout, and rank 1's own error is among
    those the group's processes raised (rank 0 may raise too, its
    collective losing its peer)."""
    start = time.monotonic()
    procs = mp.start_processes(_failing_child, args=(str(tmp_path / "store"),), nprocs=WORLD, join=False,
                               start_method="spawn")
    errors = _wait_all(procs, JOIN_TIMEOUT_S)
    ended = time.monotonic() - start
    assert "rank 1 fails before its collective" in errors.get(1, ""), errors
    assert ended < GROUP_TIMEOUT_S, f"the group took {ended:.1f} s to end"
    assert all(p.exitcode not in (None, -signal.SIGKILL) for p in procs.processes), [p.exitcode for p in procs.processes]


# ---------------------------------------------------------------------------
# every case in two processes against the one-process mesh


def test_the_group_ran_dryrun_multichip(outputs):
    assert all(out["dryrun"] for out in outputs["group"])


@pytest.mark.parametrize("case", CASES, ids=lambda c: " ".join(map(str, c)))
def test_two_processes_equal_one_process(case, outputs):
    one, (rank0, rank1) = outputs["one"][case], (out[case] for out in outputs["group"])
    if case[0] != "collectives":
        assert _same(rank0, one) and _same(rank1, one)
        return
    d = case[1]
    one, mine, theirs = one["outputs"], rank0["outputs"], rank1["outputs"]
    assert one["local"] == tuple(range(d)) and mine["local"] + theirs["local"] == one["local"]
    for name, want in one.items():
        if name == "local":
            continue
        if isinstance(want, dict):  # a sharded result: each process holds its own shards
            assert _same({**mine[name], **theirs[name]}, want), name
        else:  # a replicated result: every process holds all of it
            assert _same(mine[name], want) and _same(theirs[name], want), name


@pytest.mark.parametrize("d", SHARDS)
def test_bytes_across_the_group(d, outputs):
    """Each collective's count of the bytes a process sends to the other:
    [8, 4] int64 shards (256 bytes), d / 2 a process; and the seconds
    inside them, none in one process."""
    one = outputs["one"][("collectives", d)]
    assert all(n == 0 for n in one["sent"].values()) and one["seconds"] == 0
    shard, local = 8 * 4 * 8, d // 2
    want = {"gather": local * shard, "gather dim 1": local * shard, "all_shards": local * shard,
            "cross_shard_sum": shard, "reduce_scatter": d * shard // 2,
            "all_to_all": local * shard // 2, "all_to_all 1 -> 0": local * shard // 2}
    for rank, out in enumerate(outputs["group"]):
        mine = range(rank * local, (rank + 1) * local)  # exchange: the rows of mine that the other's shards read
        rows = sum(idx.stop - idx.start for j in range(d) if j not in mine for k, idx in _sources(d)[j] if k in mine)
        assert out[("collectives", d)]["sent"] == {**want, "exchange": rows * 4 * 8}
        assert out[("collectives", d)]["seconds"] > 0
