"""Nothing under ``benchmark/`` imports JAX, flax or the JAX package, and
the plain reference imports nothing of the program either. Module names
are compared by their top-level name as a whole: ``applecider_tpu_torch``
begins with ``applecider_tpu`` and is a different package."""

from __future__ import annotations

import ast
import subprocess
import sys

from benchmark.harness import execute, spec

BLOCKER = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def __init__(self, names):
        self.names = set(names)
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in self.names:
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block({blocked!r}))
sys.path.insert(0, {root!r})
"""

BENCH_MODULES = sorted(
    ".".join(p.relative_to(spec.ROOT).with_suffix("").parts)
    for p in spec.HERE.rglob("*.py")
    if "metrics" not in p.parts and "__pycache__" not in p.parts)


def run_blocked(blocked, body: str) -> subprocess.CompletedProcess:
    code = BLOCKER.format(blocked=list(blocked), root=str(spec.ROOT)) + body
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=240)


def test_every_module_imports_with_jax_blocked():
    body = f"""
import importlib, importlib.util, pathlib
for m in {BENCH_MODULES!r}:
    importlib.import_module(m)
for p in sorted(pathlib.Path({str(spec.HERE / "metrics")!r}).glob("*.py")):
    s = importlib.util.spec_from_file_location("m_" + p.stem.replace(".", "_"), p)
    s.loader.exec_module(importlib.util.module_from_spec(s))
import applecider_tpu_torch.infer.stream, applecider_tpu_torch.train.trainer
bad = sorted({{n.split(".")[0] for n in sys.modules}} & {{"jax", "jaxlib", "flax", "applecider_tpu"}})
assert not bad, bad
print("ok", len(sys.modules))
"""
    out = run_blocked(("jax", "jaxlib", "flax", "applecider_tpu"), body)
    assert out.returncode == 0 and out.stdout.startswith("ok"), out.stderr[-2000:]


def test_the_reference_imports_nothing_of_the_program():
    body = """
import benchmark.reference.applecider_fusion, benchmark.reference.spectranet
import benchmark.reference.preprocess, benchmark.reference.dropout, benchmark.reference.optim
print("ok")
"""
    out = run_blocked(("jax", "jaxlib", "flax", "applecider_tpu", "applecider_tpu_torch"), body)
    assert out.returncode == 0 and out.stdout.startswith("ok"), out.stderr[-2000:]
    allowed = {"__future__", "contextlib", "math", "numpy", "torch", "benchmark"}
    for path in (spec.HERE / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] in allowed, (path.name, n)
                if n.startswith("benchmark"):
                    assert n.startswith("benchmark.reference"), (path.name, n)


def test_the_run_guard_compares_whole_top_level_names(monkeypatch):
    for name in [m for m in sys.modules if m.split(".")[0] in execute.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "applecider_tpu_torch.probe", object())
    monkeypatch.setitem(sys.modules, "applecider_tpuX", object())
    assert execute.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "flax.linen", object())
    monkeypatch.setitem(sys.modules, "applecider_tpu.ops", object())
    assert execute.forbidden_modules() == ["applecider_tpu", "flax"]
