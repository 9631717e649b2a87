"""Suite-wide test configuration: keep every test process under the kernel's
limit on memory mappings, and start the longest test files first.

Each XLA:CPU program that a process compiles stays loaded as three memory
mappings (code, constants, data), and Linux lets a process hold 65,530 of
them (the default ``vm.max_map_count``).  Single tests of this suite compile
up to about 10,000 programs (30,000 mappings), whole files up to 16,000, and a
test worker runs several files in a row: a worker that has passed the limit
dies in its next compile, with a segmentation fault or an abort inside XLA,
whichever test happens to be running.  Before each test the fixture below
counts the process's mappings and, above ``MAPPINGS_BEFORE_RELEASE``, drops
the compiled programs (``jax.clear_caches``).  What a later test needs again
is compiled again, or read from the persistent cache.

Under ``pytest-xdist --dist loadfile`` a file is one unit of work, and xdist
hands the units out largest first by number of tests.  The files that take
longest have few tests each (one JAX program compiles for minutes), so they
came last and the run waited on them; ``SLOWEST_FILES`` (seconds per file in
a whole run with six workers) go out first instead, the others after them
largest first as before, each file's tests in their own order.
"""

import gc
import sys

import pytest

MAPPINGS_BEFORE_RELEASE = 24_000  # leaves room for the largest single test under the limit of 65,530
# 707, 597, 581, 577, 423, 367 and 346 s in a whole run under -n 6 on an 8-core box; nothing checks
# this ranking, so re-rank it from a whole run's --durations=0 when these files change
SLOWEST_FILES = ("test_fused_sparse.py", "test_parallel_gkr.py", "test_sparse_gkr.py", "test_parallel_ntt.py",
                 "test_kzg.py", "test_sixstep.py", "test_utils.py")


def pytest_configure(config):
    if hasattr(config.option, "loadscopereorder"):  # xdist: keep the order pytest_collection_modifyitems makes
        config.option.loadscopereorder = False


def pytest_collection_modifyitems(config, items):
    per_file = {}
    for item in items:
        per_file[item.path] = per_file.get(item.path, 0) + 1
    rank = {name: i for i, name in enumerate(SLOWEST_FILES)}
    items.sort(key=lambda item: (rank.get(item.path.name, len(rank)), -per_file[item.path], str(item.path)))


def _mappings() -> int:
    try:
        with open("/proc/self/maps", "rb") as f:
            return sum(1 for _ in f)
    except OSError:  # not Linux: no such limit to watch
        return 0


@pytest.fixture(autouse=True)
def release_compiled_programs_when_many():
    if "jax" in sys.modules and _mappings() > MAPPINGS_BEFORE_RELEASE:
        sys.modules["jax"].clear_caches()
        gc.collect()
    yield
