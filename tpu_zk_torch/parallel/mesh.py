"""A mesh of shards over devices, and the collectives between them.

Counterpart of :mod:`tpu_zk.parallel.mesh`.  ``tpu_zk`` runs one program
over a ``jax.sharding.Mesh`` and GSPMD inserts the collectives.  Here one
Python process drives the shards: a :class:`Mesh` has D shards, shard i on
``devices[i % len(devices)]``; a sharded array is a list of D tensors, one
per shard on its shard's device; a replicated one is a dict holding one
tensor per distinct device.  The collectives are the functions below, made
of device-to-device copies (local on one card, peer copies between cards):
exact cross-shard sums, the gather of the shards (``tpu_zk``'s all_gather,
onto the device that reads it) and the NTT's all_to_all.  Fiat-Shamir needs
no broadcast: every replica of the transcript absorbs the same bytes and
squeezes the same challenges.

Several shards may share a device, so one card can run every shard's
launches and every cross-shard reduction of a D-shard mesh; the tests run
every shard on the CPU.  Nothing here picks the CPU by itself: the default
devices are the visible cards, and a mesh naming a card that is not there
raises.
"""

from __future__ import annotations

import os

import torch


class Mesh:
    """D shards over a list of devices: shard i on ``devices[i % len(devices)]``."""

    def __init__(self, n_shards: int, devices):
        devices = [torch.device(d) for d in devices]
        if n_shards < 1 or not devices:
            raise ValueError(f"mesh: {n_shards} shards over {len(devices)} devices")
        self.devices = tuple(devices[i % len(devices)] for i in range(n_shards))
        self.distinct = tuple(dict.fromkeys(self.devices))  # each device once, in shard order

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def primary(self) -> torch.device:
        """Shard 0's device: where gathered results and the host's copies go."""
        return self.devices[0]

    def __repr__(self) -> str:
        return f"Mesh({self.size} shards on {', '.join(map(str, self.distinct))})"


def init_distributed(coordinator_address: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """The multi-host runtime, if one is configured; else a no-op.

    With no coordinator, given here or in ``MASTER_ADDR`` (the variable of
    ``torch.distributed``'s environment initialization), this returns False,
    as ``tpu_zk``'s does on a single host.  A mesh across hosts is not
    ported: with a coordinator it raises.
    """
    if not (coordinator_address or os.environ.get("MASTER_ADDR")):
        return False
    raise NotImplementedError(
        "tpu_zk_torch.parallel runs one process over the cards of one host; a mesh across hosts "
        "(torch.distributed with NCCL) is ROADMAP.md's queued item A15, multi-host")


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
    """A mesh of ``n_devices`` shards (default: one a device) over
    ``devices`` (default: every visible card)."""
    if devices is None:
        if torch.cuda.device_count() == 0:
            raise RuntimeError("make_mesh: no CUDA device is visible; pass the devices to shard over")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [_card(torch.device(d)) for d in devices]
    return Mesh(n_devices or len(devices), devices)


def copy_to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``: the tensor itself if it lies there, else a copy
    (asynchronous between cards; torch orders it after the source's stream
    and before the destination's)."""
    return t.to(device, non_blocking=t.device.type == "cuda" and device.type == "cuda")


def shard_leading(mesh: Mesh, t: torch.Tensor) -> list[torch.Tensor]:
    """[N, ...] -> D shards of N/D consecutive rows, each on its shard's device."""
    if t.shape[0] % mesh.size:
        raise ValueError(f"shard_leading: {t.shape[0]} rows do not split into {mesh.size} shards")
    return [copy_to(part, dev) for part, dev in zip(t.chunk(mesh.size), mesh.devices)]


def replicated(mesh: Mesh, t: torch.Tensor) -> dict[torch.device, torch.Tensor]:
    """``t`` once on each distinct device of the mesh."""
    return {dev: copy_to(t, dev) for dev in mesh.distinct}


def gather(mesh: Mesh, parts: list[torch.Tensor], dim: int = 0, device=None) -> torch.Tensor:
    """The shards concatenated along ``dim`` on one device (default: the
    primary): ``tpu_zk``'s all_gather, taken where the one controller reads
    the gathered rows."""
    device = mesh.primary if device is None else torch.device(device)
    return torch.cat([copy_to(p, device) for p in parts], dim)


def cross_shard_sum(mesh: Mesh, parts: list[torch.Tensor], device=None) -> torch.Tensor:
    """The elementwise sum of the shards' integer tensors (int64 lazy limb
    sums: exact in any order) on one device (default: the primary)."""
    device = mesh.primary if device is None else torch.device(device)
    total = copy_to(parts[0], device).clone()
    for p in parts[1:]:
        total += copy_to(p, device)
    return total


def all_to_all(mesh: Mesh, parts: list[torch.Tensor], split_dim: int, concat_dim: int) -> list[torch.Tensor]:
    """Shard s receives piece s of every shard's ``split_dim`` (cut in D
    equal pieces), concatenated along ``concat_dim`` in shard order."""
    pieces = [p.chunk(mesh.size, split_dim) for p in parts]
    return [torch.cat([copy_to(pieces[k][s], dev) for k in range(mesh.size)], concat_dim)
            for s, dev in enumerate(mesh.devices)]
