"""On the card only: each cell's short run is correct, and its control fails.

    python3 -m pytest zkbench/tests/test_zkbench_card.py -p no:cacheprovider -n 0
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = ("succinct_gkr.bn254_d24", "fri.bn254_2p18", "gkr.bn254_d24_public")


def _need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card_is_correct(cell):
    _need_card()
    done = subprocess.run([sys.executable, "zkbench/run.py", "--workload", cell, "--seed", str(2**31 + 3),
                           "--seconds", "3", "--trace", "0"], capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert done.returncode == 0, done.stderr[-3000:]
    result = json.loads(done.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_at_the_cells_size(cell):
    _need_card()
    done = subprocess.run([sys.executable, "zkbench/control.py", "--workload", cell, "--seeds", str(2**31 + 4),
                           "--seconds", "3"], capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert done.returncode == 0, done.stderr[-3000:]
    summary = json.loads(done.stdout.strip().splitlines()[-1])
    assert summary["lower"] == 0 and summary["upper"] > 0
