"""Device-resident Keccak-256 Merkle tree over field elements; its digests
are bit-identical to :mod:`tpu_zk.merkle.device_merkle`'s and to the host
tree's (:class:`.merkle.MerkleTree`).

A leaf is a field element's 32 big-endian canonical bytes and a node the
64 bytes of its two children's digests: both fit one Keccak block, so every
level is one launch of K5 (:func:`.kernels.keccak_rows`) at every width.
``tpu_zk``'s narrow-batch route and its ``N % 2048`` rule answered a TPU
miscompile and the TPU's tiling and are not carried over.  Digests are
``uint8 [N, 32]`` (``tpu_zk`` holds byte values in ``uint32``), so a level's
node input is the level below viewed as ``[N/2, 64]``, with no copy, and
all levels of a tree are views of one ``[2N - 1, 32]`` buffer that the query
phase of FRI gathers from.
"""

from __future__ import annotations

import torch

from ..fields import arith
from ..fields.arith import FieldCtx
from .kernels import keccak_rows


def keccak_fixed_batch(data: torch.Tensor) -> torch.Tensor:
    """[N, k] uint8 rows (k <= 135) -> [N, 32] digests, one block each."""
    return keccak_rows(data.contiguous())


def field_leaf_bytes(ctx: FieldCtx, table: torch.Tensor) -> torch.Tensor:
    """[N, L] Montgomery -> [N, nbytes] uint8 big-endian canonical bytes
    (``from_mont`` through K1, then the byte order of ``to_bytes_be``)."""
    rev = arith.from_mont(ctx, table).flip(-1)  # big-endian limb order
    b = torch.stack([(rev >> 8) & 0xFF, rev & 0xFF], dim=-1)
    return b.reshape(table.shape[0], ctx.nbytes).to(torch.uint8)


def merkle_tree_flat(leaf_bytes: torch.Tensor) -> torch.Tensor:
    """[N, leaf_width] uint8 leaves (N a power of two) -> [2N - 1, 32] uint8:
    the N leaf digests, then each level above them, the root last."""
    n = leaf_bytes.shape[0]
    if n <= 0 or n & (n - 1):
        raise ValueError(f"merkle tree: leaf count {n} is not a power of two")
    flat = torch.empty((2 * n - 1, 32), dtype=torch.uint8, device=leaf_bytes.device)
    keccak_rows(leaf_bytes.contiguous(), out=flat[:n])
    off, width = 0, n
    while width > 1:
        keccak_rows(flat[off : off + width].view(width // 2, 64), out=flat[off + width : off + width + width // 2])
        off, width = off + width, width // 2
    return flat


def merkle_levels_device(leaf_bytes: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """[N, leaf_width] uint8 -> digest levels ([N, 32], ..., [1, 32]), views
    of one flat tree."""
    flat = merkle_tree_flat(leaf_bytes)
    levels, off, n = [], 0, leaf_bytes.shape[0]
    while n >= 1:
        levels.append(flat[off : off + n])
        off, n = off + n, n // 2
    return tuple(levels)


def merkle_field_tree(ctx: FieldCtx, table, device=None) -> tuple[torch.Tensor, ...]:
    """The tree over field-element leaves: ``table`` a [N, L] Montgomery
    tensor (its device), or host ints (on ``device``, by default the card)."""
    if not isinstance(table, torch.Tensor):
        table = ctx.array(list(table), device=device)
    return merkle_levels_device(field_leaf_bytes(ctx, table))
