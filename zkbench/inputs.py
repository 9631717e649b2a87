"""Inputs made from the seed: the same seed gives the same values on every
device.  Statement k of a run comes from its own generator, so the reference
can make it again after the window from (seed, k) alone."""

from __future__ import annotations

import random

import torch

LIMBS = 16


def _mix(seed: int, k: int) -> int:
    return (seed * 1_000_003 + k * 7_919 + 1) % (1 << 63)


def uniform_rows(p: int, n: int, seed: int, k: int, device) -> torch.Tensor:
    """[n, 16] int32 limbs (16 bits each, least significant first) of values
    below p: every limb uniform, the top one below p's top limb."""
    gen = torch.Generator(device=device)
    gen.manual_seed(_mix(seed, k))
    rows = torch.randint(0, 1 << 16, (n, LIMBS), generator=gen, device=device, dtype=torch.int32)
    rows[:, -1] = torch.randint(0, p >> (16 * (LIMBS - 1)), (n,), generator=gen, device=device, dtype=torch.int32)
    return rows


def field_values(p: int, count: int, seed: int, salt: str) -> list[int]:
    """Host field elements below p (a setup's taus)."""
    rng = random.Random(f"{seed}/{salt}")
    return [rng.randrange(p) for _ in range(count)]
