"""The control at small sizes: the window's sound proofs read no mismatch,
and their unreduced copies (each field element v + p) read some, in every
cell."""

import pytest

from zkbench.control import control_readings

from .conftest import SMALL


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_the_control_fails_and_sound_proofs_pass(cell, on_cpu):
    r = control_readings(cell, 2**31 + 5, 0.5, "cpu", SMALL[cell])
    assert r["failed"] == 0 and r["proofs"] >= 1
    assert r["sound_mismatches"] == 0
    assert r["control_mismatches"] > 0 and r["control_rejected"] >= 1
