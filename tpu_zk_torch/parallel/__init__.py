"""Sharded provers over a mesh of devices: the counterpart of :mod:`tpu_zk.parallel`.

One Python process drives D shards (:mod:`.mesh`); a sharded array is a list
of D tensors, one per shard, and the collectives are device-to-device copies.
Each sharded function gives the same integers, proof bytes and group
elements as its one-device counterpart in this package.
"""
