"""Keccak-256 Merkle tree over byte leaves, on the host; bit-identical to
:mod:`tpu_zk.merkle.merkle`.

Every level is built by one call to the native Keccak library
(:func:`tpu_zk_torch.transcript.keccak.merkle_levels`); paths are checked
with single hashes.  The device tree over field elements is
:mod:`.device_merkle`.
"""

from __future__ import annotations

import numpy as np

from ..transcript.keccak import keccak256_batch, merkle_levels


class MerkleTree:
    """levels[0] = leaf hashes ... levels[-1] = [root]."""

    def __init__(self, leaves: np.ndarray):
        """leaves: [N, leaf_bytes] uint8, N a power of two."""
        n = leaves.shape[0]
        assert n > 0 and (n & (n - 1)) == 0, "leaf count must be a power of 2"
        flat = merkle_levels(leaves)
        self.levels, off, width = [], 0, n
        while width >= 1:
            self.levels.append(flat[off : off + width])
            off += width
            width //= 2

    @property
    def root(self) -> bytes:
        return self.levels[-1][0].tobytes()

    @property
    def num_leaves(self) -> int:
        return self.levels[0].shape[0]

    def open(self, index: int) -> list[bytes]:
        """Authentication path: sibling hash per level, leaf level first."""
        path = []
        for level in self.levels[:-1]:
            path.append(level[index ^ 1].tobytes())
            index >>= 1
        return path


def _hash(data: bytes) -> bytes:
    return keccak256_batch(np.frombuffer(data, np.uint8)[None, :])[0].tobytes()


def verify_path(root: bytes, leaf: bytes, index: int, path: list[bytes]) -> bool:
    current = _hash(leaf)
    for sibling in path:
        current = _hash(current + sibling if index % 2 == 0 else sibling + current)
        index >>= 1
    return current == root
