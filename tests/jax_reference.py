"""Run tpu_zk (JAX) reference computations in a fresh Python process.

Every XLA:CPU program a process compiles stays loaded in it, and a test
worker that holds too many dies in a later compile (see the ``conftest.py``
at the root of the repo).  The port's comparison tests compile many reference
programs (a whole GKR prove compiles dozens); running those in a child
process that exits afterwards leaves the test worker's own count where it
was.
"""

from __future__ import annotations

import pickle
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_CHILD = (
    "import importlib, pickle, sys\n"
    "import tests.conftest  # the suite's JAX settings: CPU backend, XLA flags\n"
    "module, function, src, dst = sys.argv[1:]\n"
    "fn = getattr(importlib.import_module(module), function)\n"
    "with open(src, 'rb') as f:\n"
    "    args = pickle.load(f)\n"
    "with open(dst, 'wb') as f:\n"
    "    pickle.dump(fn(*args), f)\n"
)


def call(module: str, function: str, *args, timeout: float = 600):
    """``module.function(*args)`` computed in a child process with the test
    suite's JAX settings.  Arguments and result cross as pickles written by
    this process and its child only."""
    with tempfile.TemporaryDirectory() as d:
        src, dst = Path(d, "args.pkl"), Path(d, "result.pkl")
        src.write_bytes(pickle.dumps(args))
        done = subprocess.run(
            [sys.executable, "-c", _CHILD, module, function, str(src), str(dst)],
            cwd=ROOT, capture_output=True, text=True, timeout=timeout,
        )
        if done.returncode != 0:
            raise RuntimeError(f"reference process {module}.{function} failed:\n{done.stderr[-4000:]}")
        return pickle.loads(dst.read_bytes())
