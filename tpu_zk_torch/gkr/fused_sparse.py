"""``prove`` and ``prove_succinct`` under :mod:`tpu_zk.gkr.fused_sparse`'s
module name.

``tpu_zk``'s fused prover keeps each layer's rounds in a pool of compiled
TPU programs with a device sponge, and emits the same bytes as its plain
linear-time prover.  The port has one linear-time prover, :mod:`.sparse`,
whose default ``fused=True`` runs each layer's rounds on the device sponge
(K7); both names here are that prover, with its ``fused=`` and ``device=``.
"""

from __future__ import annotations

from .sparse import prove, prove_succinct

__all__ = ["prove", "prove_succinct"]
