"""Nothing under zkbench/ loads JAX or the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), and the
reference loads nothing of the program."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BLOCKER = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in {blocked!r}:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, {root!r})
"""


def _run(blocked: set, body: str) -> subprocess.CompletedProcess:
    code = BLOCKER.format(blocked=sorted(blocked), root=str(ROOT)) + body
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=ROOT)


def _modules(sub: str) -> list[str]:
    base = ROOT / "zkbench"
    return [".".join(p.relative_to(ROOT).with_suffix("").parts) for p in sorted((base / sub).rglob("*.py"))
            if "tests" not in p.parts and p.name != "__init__.py"]


def test_the_harness_loads_no_jax():
    body = f"""
import importlib
from zkbench import harness
for m in {_modules("")!r}:
    if not m.startswith("zkbench.metrics"):
        importlib.import_module(m)
bench = harness.load_benchmark()
for m in bench["end_to_end"] + bench["per_layer"]:
    harness.reader(m["name"])
for c in bench["workloads"]:
    harness.entry_class(harness.cell_parts(bench, c["name"])[2])
loaded = {{n.split(".")[0] for n in sys.modules}}
assert not loaded & {{"jax", "jaxlib", "flax", "tpu_zk"}}, loaded
assert "tpu_zk_torch" in loaded
print("ok")
"""
    done = _run({"jax", "jaxlib", "flax", "tpu_zk"}, body)
    assert done.returncode == 0 and "ok" in done.stdout, done.stderr[-3000:]


def test_the_reference_loads_nothing_of_the_program():
    body = f"""
import importlib
for m in {_modules("reference")!r}:
    importlib.import_module(m)
loaded = {{n.split(".")[0] for n in sys.modules}}
assert not loaded & {{"jax", "tpu_zk", "tpu_zk_torch"}}, loaded
print("ok")
"""
    done = _run({"jax", "jaxlib", "flax", "tpu_zk", "tpu_zk_torch"}, body)
    assert done.returncode == 0 and "ok" in done.stdout, done.stderr[-3000:]


def test_the_forbidden_names_are_whole_top_level_names():
    from zkbench import harness

    saved = dict(sys.modules)
    try:
        sys.modules["tpu_zk_torch_like"] = sys
        assert "tpu_zk" not in harness.forbidden_modules()
        sys.modules["tpu_zk.fields"] = sys
        assert harness.forbidden_modules() == ["tpu_zk"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_run_refuses_without_a_card():
    done = subprocess.run([sys.executable, "zkbench/run.py", "--workload", "fri.bn254_2p18", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], capture_output=True, text=True, timeout=300, cwd=ROOT,
                          env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert done.returncode != 0 and done.stdout.strip() == ""
    assert "CUDA card" in done.stderr
