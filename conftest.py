"""Suite-wide test configuration: keep every test process under the kernel's
limit on memory mappings.

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
"""

import gc
import sys

import pytest

MAPPINGS_BEFORE_RELEASE = 24_000  # leaves room for the largest single test under the limit of 65,530


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
