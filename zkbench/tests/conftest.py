"""The benchmark's tests: the CPU at small sizes, except those marked
``card``, which skip without a CUDA card (decided inside each test)."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

SMALL = {  # the cells' configurations at sizes the CPU runs in seconds
    "succinct_gkr.bn254_d24": {"circuit": "tree_sum", "gate": "add", "field": "bn254_fr", "curve": "bn254", "depth": 4},
    "gkr.bn254_d24_public": {"circuit": "tree_sum", "gate": "add", "field": "bn254_fr", "curve": "bn254", "depth": 4},
    "fri.bn254_2p18": {"field": "bn254_fr", "domain_log2": 10, "blowup_log2": 2, "final_size_log2": 4,
                       "num_queries": 20},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def on_cpu():
    """The program's default device set to the CPU for the test."""
    from tpu_zk_torch import device

    with device.using("cpu"):
        yield "cpu"
