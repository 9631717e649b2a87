"""Field-operation counters.

The reference workspace instruments its tests with the ``field-tracker``
crate (``sumcheck_protocol/src/basic_sumcheck/protocol.rs:6-7`` wraps ``Fr``
in ``Ft!`` and calls ``print_summary!()``).  This module is the counterpart
of :mod:`tpu_zk.utils.counters`, with the same API: the field layer reports
each vectorized operation with the number of elements it touched
(:mod:`tpu_zk_torch.fields.arith`'s ``add``, ``sub``, ``mont_mul`` and
``sum_mod``, and the K2 ``fold`` wrapper, which does a sub, a product and an
add per output element in one launch), so protocol-level operation counts
can be compared with the reference's field-tracker numbers.

``tpu_zk`` counts while JAX traces, once per compilation.  Torch runs
eagerly, so here every call counts when it runs: the totals of a section are
those of the work it did.  Disabled (the default), a count costs one branch.
"""

from __future__ import annotations

import math
from collections import defaultdict

_counts: dict[str, dict[str, int]] = defaultdict(lambda: defaultdict(int))
_enabled = False


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = on


def reset() -> None:
    _counts.clear()


def bump(field_name: str, op: str, *arrays) -> None:
    """Count one operation over the largest of ``arrays``' element counts
    (their shapes without the limb axis)."""
    if not _enabled:
        return
    n = 1
    shapes = [a.shape[:-1] for a in arrays if hasattr(a, "shape")]
    if shapes:
        n = max(math.prod(s) for s in shapes)
    _counts[field_name][op] += n


def summary() -> dict[str, dict[str, int]]:
    return {k: dict(v) for k, v in _counts.items()}


def print_summary() -> None:
    for fname, ops in summary().items():
        total = sum(ops.values())
        print(f"[{fname}] " + ", ".join(f"{k}: {v}" for k, v in sorted(ops.items())) + f" (total {total})")
