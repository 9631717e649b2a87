"""Sharded provers over a mesh of devices and processes: the counterpart of :mod:`tpu_zk.parallel`.

A mesh has D shards over this process's devices and, after
:func:`.mesh.init_distributed`, over every process of the
``torch.distributed`` group (:mod:`.mesh`); a sharded array is a list of D
entries, None where a shard belongs to another process, and every movement
between shards is a collective of :mod:`.mesh`.  Each sharded function gives
every process the same integers, proof bytes and group elements as its
one-device counterpart in this package.
"""
