"""Host syncs of one proof after the traced window, counted by torch's sync
debug mode (exact); the places that synced go to standard error."""

import sys

import torch

from zkbench.syncs import count_syncs


def after(notes, prove_one):
    if not torch.cuda.is_available():  # the debug mode exists only with a card
        return
    _, places = count_syncs(prove_one)
    notes["host_syncs"] = sum(places.values())
    print(f"host syncs of one proof by place: {dict(places.most_common())}", file=sys.stderr)


def read(run):
    return run.notes.get("host_syncs")
