"""The device of a tensor made from host values when the caller names none.

The default is the CUDA card.  A caller that wants the CPU says so: for the
process with :func:`set_default_device`, for a scope with :func:`using`, or
for one call with a ``device=`` argument.  Nothing here asks whether a card
is present: with the default left alone on a machine without one, making the
tensor raises, as ``torch.tensor(..., device="cuda")`` does.

Tensors that a caller hands in keep their device; only host values (Python
ints, numpy arrays) are placed by this rule.
"""

from __future__ import annotations

import contextlib

import torch

_default = torch.device("cuda")


def default_device() -> torch.device:
    return _default


def set_default_device(device) -> torch.device:
    """Set the process-wide default; returns the one it replaces."""
    global _default
    previous, _default = _default, torch.device(device)
    return previous


@contextlib.contextmanager
def using(device):
    """The default device inside a ``with`` block."""
    previous = set_default_device(device)
    try:
        yield
    finally:
        set_default_device(previous)


def resolve(device=None) -> torch.device:
    """``device`` if the caller gave one, else the default."""
    return _default if device is None else torch.device(device)
