"""``prove`` and ``prove_succinct`` under :mod:`tpu_zk.gkr.fused_sparse`'s
module name.

``tpu_zk``'s fused prover keeps each layer's rounds in a pool of compiled
TPU programs with a device sponge, and emits the same bytes as its plain
linear-time prover.  The port has one linear-time prover, :mod:`.sparse`,
whose per-round host sync costs microseconds on a local card; both names
here are that prover.
"""

from __future__ import annotations

from .sparse import prove, prove_succinct

__all__ = ["prove", "prove_succinct"]
