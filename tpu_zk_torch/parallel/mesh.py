"""A mesh of shards over devices and processes, and the collectives between them.

Counterpart of :mod:`tpu_zk.parallel.mesh`.  ``tpu_zk`` runs one program
over a ``jax.sharding.Mesh`` and GSPMD inserts the collectives.  Here a
:class:`Mesh` has D shards and the collectives are the functions below.

**Processes.**  After :func:`init_distributed`, :func:`make_mesh` spans
every process of the ``torch.distributed`` group, as ``tpu_zk``'s mesh
spans every host's devices after ``jax.distributed.initialize``: every
process runs the same call on the same inputs and holds only its own
shards.  Of D shards over W processes, shard i belongs to rank
``i // (D / W)`` (contiguous blocks, as ``jax.devices()`` orders devices by
process); ``mesh.local`` lists this process's shards, and a process places
them on its own devices round-robin.  With one process every shard is
local.  Every process returns the same outputs, bit for bit those of a
one-process mesh.  Fiat-Shamir needs no broadcast: every process's
transcript absorbs the same bytes and squeezes the same challenges.

**Sharded arrays.**  A sharded array is a list of D entries: entry i is
shard i's tensor on its device, or None where shard i belongs to another
process.  A replicated array is a dict holding one tensor per distinct
device of this process.  Every movement of data between shards goes
through a function here: :func:`scatter` cuts a replicated input into this
process's shards; :func:`gather` and :func:`all_shards` (``tpu_zk``'s
all_gather) give every process every shard; :func:`cross_shard_sum` adds
the shards' exact integer sums; :func:`reduce_scatter` adds the shards'
tables and leaves each shard its block; :func:`exchange` and
:func:`all_to_all` move pieces of shards to other shards.

**Transport.**  Within a process the collectives are device-to-device
copies (local on one card, peer copies between cards).  Between processes
they are ``torch.distributed`` collectives.  NCCL takes card tensors
directly.  Gloo moves host tensors, so under gloo a card tensor crosses the
group through a host buffer: ``.cpu()``, the collective, ``.to(card)``.
That is the transport gloo offers, not a fallback: the data and every
kernel stay on the card.  Each collective between processes adds to
``mesh.group_bytes`` the bytes this process must send to the others by the
collective's meaning (nccl-tests' bus bytes: an all_gather of b local bytes
sends b (W - 1), a reduce_scatter or all_to_all of b bytes b (W - 1) / W,
an all_reduce twice that), whatever the backend's algorithm sends, and to
``mesh.group_s`` the host seconds from its staging to its result (with
gloo, which returns when the data has arrived, the transfer's time; with
NCCL, the time to enqueue it).

Several shards may share a device, so one card can run every shard's
launches and every cross-shard reduction of a D-shard mesh; the tests run
every shard on the CPU.  Nothing here picks the CPU by itself: the default
devices are the visible cards, and a mesh naming a card that is not there
raises.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import time

import torch
import torch.distributed as dist


class Mesh:
    """D shards over a list of this process's devices and, with a process
    ``group`` of W > 1 processes, over the group: shard i belongs to rank
    ``i // (D / W)``, and this process's j-th shard lies on ``devices[j %
    len(devices)]``."""

    def __init__(self, n_shards: int, devices, group=None):
        devices = [torch.device(d) for d in devices]
        world = 1 if group is None else dist.get_world_size(group)
        if n_shards < 1 or not devices or n_shards % world:
            raise ValueError(f"mesh: {n_shards} shards over {len(devices)} devices and {world} processes")
        self.group = group if world > 1 else None  # one process: every collective is copies
        self.world, self.rank = world, 0 if self.group is None else dist.get_rank(group)
        per = n_shards // world
        self.local = tuple(range(self.rank * per, (self.rank + 1) * per))
        self.devices = tuple(devices[(i - self.local[0]) % len(devices)] if i in self.local else None
                             for i in range(n_shards))
        self.distinct = tuple(dict.fromkeys(self.devices[i] for i in self.local))  # each device once, in shard order
        # where tensors cross the group: gloo moves host tensors, NCCL card tensors
        gloo = self.group is not None and dist.get_backend(group) == "gloo"
        self.wire = torch.device("cpu") if gloo else self.primary
        self.group_bytes, self.group_s = 0, 0.0

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def primary(self) -> torch.device:
        """This process's first shard's device: where gathered results and
        the host's copies go."""
        return self.devices[self.local[0]]

    def owner(self, shard: int) -> int:
        """The rank that holds ``shard``."""
        return shard // len(self.local)

    def map(self, fn) -> list:
        """The sharded array ``fn(i, device of shard i)`` over this
        process's shards, None at the others."""
        return [fn(i, dev) if dev is not None else None for i, dev in enumerate(self.devices)]

    def __repr__(self) -> str:
        procs = f", rank {self.rank} of {self.world} processes" if self.group is not None else ""
        return f"Mesh({self.size} shards on {', '.join(map(str, self.distinct))}{procs})"


def init_distributed(coordinator_address: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, backend: str = "nccl", timeout=None) -> bool:
    """Join the process group, if one is configured; else a no-op.

    With no coordinator, given here or in ``MASTER_ADDR``, this returns
    False, as ``tpu_zk``'s does on a single host.  Otherwise it calls
    ``torch.distributed.init_process_group`` and returns True: an address
    given as ``host:port`` becomes ``tcp://host:port``, a ``tcp://``,
    ``file://`` or ``env://`` address is passed through, and ``MASTER_ADDR``
    (with ``MASTER_PORT``, as ``torchrun`` sets them) is read as ``env://``.
    The world size and rank come from the arguments, else from
    ``WORLD_SIZE`` and ``RANK``; torch has no cluster detection, so a
    coordinator without them raises ValueError.  The backend is NCCL unless
    the caller names another (``"gloo"`` for CPU tensors, or for several
    processes on one card); where NCCL is absent the default raises.
    ``timeout``: seconds (or a ``timedelta``) before a collective that
    waits on a missing process fails.
    """
    addr = coordinator_address or os.environ.get("MASTER_ADDR")
    if not addr:
        return False
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    missing = [name for name, v in (("the world size (num_processes or WORLD_SIZE)", num_processes),
                                    ("the rank (process_id or RANK)", process_id)) if v is None]
    if missing:
        raise ValueError(f"init_distributed: coordinator {addr!r} given without {' and '.join(missing)}")
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("init_distributed: this torch has no NCCL; name another backend (backend='gloo')")
    if coordinator_address is None:
        init_method = "env://"
    else:
        init_method = addr if "://" in addr else f"tcp://{addr}"
    if timeout is not None and not isinstance(timeout, datetime.timedelta):
        timeout = datetime.timedelta(seconds=timeout)
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes, rank=process_id,
                            timeout=timeout)
    return True


def _card(device: torch.device) -> torch.device:
    """``device`` with its index: a card named without one is the current card."""
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(f"mesh: {device} named, but no CUDA device is available")
    index = torch.cuda.current_device() if device.index is None else device.index
    if index >= torch.cuda.device_count():
        raise RuntimeError(f"mesh: cuda:{index} named, but {torch.cuda.device_count()} CUDA devices are visible")
    return torch.device("cuda", index)


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A mesh of ``n_devices`` shards over ``devices`` (default: this
    process's cards, ``cuda:$LOCAL_RANK`` where ``LOCAL_RANK`` is set, else
    every visible card) and, after :func:`init_distributed`, over every
    process of the group (default: one shard a device of every process)."""
    if devices is None:
        if torch.cuda.device_count() == 0:
            raise RuntimeError("make_mesh: no CUDA device is visible; pass the devices to shard over")
        local_rank = os.environ.get("LOCAL_RANK")
        devices = ([f"cuda:{local_rank}"] if local_rank is not None
                   else [f"cuda:{i}" for i in range(torch.cuda.device_count())])
    devices = [_card(torch.device(d)) for d in devices]
    group = dist.group.WORLD if dist.is_available() and dist.is_initialized() else None
    world = 1 if group is None else dist.get_world_size(group)
    return Mesh(n_devices or len(devices) * world, devices, group)


@contextlib.contextmanager
def _crossing(mesh: Mesh, nbytes: int):
    """Count a collective between processes: ``nbytes`` sent, and its time."""
    start = time.perf_counter()
    yield
    mesh.group_s += time.perf_counter() - start
    mesh.group_bytes += nbytes


def copy_to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``: the tensor itself if it lies there, else a copy
    (asynchronous between cards; torch orders it after the source's stream
    and before the destination's)."""
    return t.to(device, non_blocking=t.device.type == "cuda" and device.type == "cuda")


def scatter(mesh: Mesh, piece) -> list:
    """The sharded array whose shard i is ``piece(i)`` (a tensor every
    process can cut from its replicated input) on shard i's device; only
    this process's shards are cut."""
    return mesh.map(lambda i, dev: copy_to(piece(i), dev))


def shard_leading(mesh: Mesh, t: torch.Tensor) -> list:
    """[N, ...] -> D shards of N/D consecutive rows, each on its shard's device."""
    if t.shape[0] % mesh.size:
        raise ValueError(f"shard_leading: {t.shape[0]} rows do not split into {mesh.size} shards")
    parts = t.chunk(mesh.size)
    return scatter(mesh, lambda i: parts[i])


def replicated(mesh: Mesh, t: torch.Tensor) -> dict[torch.device, torch.Tensor]:
    """``t`` once on each distinct device of this process's shards."""
    return {dev: copy_to(t, dev) for dev in mesh.distinct}


def all_shards(mesh: Mesh, parts: list, device=None) -> list[torch.Tensor]:
    """Every shard's tensor (all of one shape) on one device of this process
    (default: the primary), in shard order: one all_gather between processes."""
    device = mesh.primary if device is None else torch.device(device)
    if mesh.group is None:
        return [copy_to(p, device) for p in parts]
    like = parts[mesh.local[0]]
    with _crossing(mesh, like.nbytes * len(mesh.local) * (mesh.world - 1)):
        block = torch.stack([copy_to(parts[i], mesh.wire) for i in mesh.local])
        blocks = [torch.empty_like(block) for _ in range(mesh.world)]
        dist.all_gather(blocks, block, group=mesh.group)
        received = [t for b in blocks for t in b.unbind(0)]
        return [copy_to(parts[i] if i in mesh.local else received[i], device) for i in range(mesh.size)]


def gather(mesh: Mesh, parts: list, dim: int = 0, device=None) -> torch.Tensor:
    """The shards concatenated along ``dim`` on one device (default: the
    primary), in every process: ``tpu_zk``'s all_gather, replicated."""
    return torch.cat(all_shards(mesh, parts, device), dim)


def cross_shard_sum(mesh: Mesh, parts: list, device=None) -> torch.Tensor:
    """The elementwise sum of the shards' integer tensors (int64 lazy limb
    sums: exact in any order) on one device (default: the primary), in
    every process: the local sum, then one all_reduce between processes."""
    device = mesh.primary if device is None else torch.device(device)
    total = None
    for i in mesh.local:
        part = copy_to(parts[i], device)
        total = part.clone() if total is None else total.add_(part)
    if mesh.group is None:
        return total
    with _crossing(mesh, 2 * total.nbytes * (mesh.world - 1) // mesh.world):
        wire = copy_to(total, mesh.wire)
        dist.all_reduce(wire, op=dist.ReduceOp.SUM, group=mesh.group)
        return copy_to(wire, device)


def reduce_scatter(mesh: Mesh, parts) -> list:
    """Each shard's integer table [S, ...] (S = D M) summed over the shards,
    shard d keeping rows d M .. d M + M - 1 of the sum, on its device.

    ``parts``: this process's shards' tables in ``mesh.local`` order, any
    iterable.  A generator that drops each table once it is handed over
    keeps one table alive at a time.  The tables are consumed: the sum may
    be made in the first one."""
    D = mesh.size
    acc: list = [None] * D
    total = None
    for table in parts:
        if mesh.group is None:  # each shard's block of it, added on the block's device
            for d, block in enumerate(table.chunk(D)):
                block = copy_to(block, mesh.devices[d])
                acc[d] = block.clone() if acc[d] is None else acc[d].add_(block)
            del block
        else:
            table = copy_to(table, mesh.primary)
            total = table if total is None else total.add_(table)
        del table
    if mesh.group is None:
        return acc
    with _crossing(mesh, total.nbytes * (mesh.world - 1) // mesh.world):
        wire = copy_to(total, mesh.wire)
        del total
        mine = torch.empty((wire.shape[0] // mesh.world,) + wire.shape[1:], dtype=wire.dtype, device=mesh.wire)
        dist.reduce_scatter_tensor(mine, wire, op=dist.ReduceOp.SUM, group=mesh.group)
        del wire
        for d, block in zip(mesh.local, mine.chunk(len(mesh.local))):
            acc[d] = copy_to(block, mesh.devices[d])
    return acc


def exchange(mesh: Mesh, parts: list, sources) -> list:
    """Pieces of shards moved to other shards.  ``sources[j]`` lists the
    pieces shard j receives, each ``(k, index)``: ``parts[k][index]``.
    Returns the sharded array whose entry j is the list of shard j's pieces,
    in that order, on its device.  Every shard's tensor has one shape, so
    a process knows the shape of a piece it receives; the pieces that cross
    processes go as one message a pair of processes (send and receive
    posted together)."""
    out = mesh.map(lambda j, dev: [copy_to(parts[k][index], dev) if k in mesh.local else None
                                   for k, index in sources[j]])
    if mesh.group is None:
        return out
    like = parts[mesh.local[0]]
    peers = [peer for peer in range(mesh.world) if peer != mesh.rank]
    to_peer = {peer: [parts[k][index].reshape(-1) for j in range(mesh.size) if mesh.owner(j) == peer
                      for k, index in sources[j] if k in mesh.local] for peer in peers}
    wanted = {peer: [(j, n) for j in mesh.local for n, (k, _) in enumerate(sources[j]) if mesh.owner(k) == peer]
              for peer in peers}
    with _crossing(mesh, sum(p.nbytes for pieces in to_peer.values() for p in pieces)):
        ops, recvs = [], []
        for peer in peers:
            if to_peer[peer]:
                message = copy_to(torch.cat(to_peer[peer]), mesh.wire)
                ops.append(dist.P2POp(dist.isend, message, peer, group=mesh.group))
            if wanted[peer]:
                shapes = [like[sources[j][n][1]].shape for j, n in wanted[peer]]
                buf = torch.empty(sum(s.numel() for s in shapes), dtype=like.dtype, device=mesh.wire)
                ops.append(dist.P2POp(dist.irecv, buf, peer, group=mesh.group))
                recvs.append((buf, wanted[peer], shapes))
        for request in dist.batch_isend_irecv(ops) if ops else ():
            request.wait()
        for buf, pieces, shapes in recvs:
            for (j, n), shape, piece in zip(pieces, shapes, buf.split([s.numel() for s in shapes])):
                out[j][n] = copy_to(piece.view(shape), mesh.devices[j])
    return out


def all_to_all(mesh: Mesh, parts: list, split_dim: int, concat_dim: int) -> list:
    """Shard s receives piece s of every shard's ``split_dim`` (cut in D
    equal pieces), concatenated along ``concat_dim`` in shard order."""
    D = mesh.size
    width = parts[mesh.local[0]].shape[split_dim] // D
    lead = (slice(None),) * split_dim
    pieces = exchange(mesh, parts, [[(k, lead + (slice(s * width, (s + 1) * width),)) for k in range(D)]
                                    for s in range(D)])
    return [None if p is None else torch.cat(p, concat_dim) for p in pieces]
