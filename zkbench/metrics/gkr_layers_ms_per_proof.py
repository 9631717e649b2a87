"""Milliseconds of one proof after the traced window spent in the GKR layer
sumchecks: the inclusive time of every ``gkr.sparse._layer_sumcheck`` call,
from the program's stage timers (``gkr/breakdown.py``'s ``Timers``, which
synchronize the card at each call's start and end and are put back after
the proof)."""

import sys

STAGE = "GKR layer sumchecks"


def after(notes, prove_one):
    import torch

    from tpu_zk_torch.gkr import breakdown, sparse

    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    timers = breakdown.Timers(device, [(sparse, "_layer_sumcheck", STAGE)])
    with timers.installed():
        prove_one()
    if timers.each[STAGE]:
        notes["gkr_layers_s"] = sum(timers.each[STAGE])
        print(f"GKR layers, s by table size: {timers.layers}", file=sys.stderr)


def read(run):
    s = run.notes.get("gkr_layers_s")
    return 1e3 * s if s is not None else None
