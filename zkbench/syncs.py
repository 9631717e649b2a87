"""Host syncs during a call: torch's sync debug mode set to "warn" while it
runs and its warnings counted (a copy of ``count_syncs`` in ``chip_smoke.py``
and ``scripts/fri_prove_syncs.py``)."""

from __future__ import annotations

import collections
import os
import warnings

import torch


def count_syncs(fn):
    """(fn(), Counter of the places that synced: file and line of the Python
    call, the repo's files relative to its root)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    places = collections.Counter()
    for w in caught:
        if "synchroniz" in str(w.message):
            rel = os.path.relpath(w.filename, root)
            places[f"{os.path.basename(w.filename) if rel.startswith('..') else rel}:{w.lineno}"] += 1
    return out, places
