"""No module of JAX or of the JAX package in a run, compared by whole
top-level names; the plain reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

import pytest

from benchmark import harness

BENCH = os.path.join(harness.ROOT, "benchmark")


@pytest.mark.parametrize("name,flagged", [
    ("tpu_asr_torch", False), ("tpu_asr_torch.models.encoder", False),
    ("tpu_asr", True), ("tpu_asr.models", True), ("jax", True),
    ("jax._src.core", True), ("jaxlib", True), ("flax.linen", True),
    ("jax_like", False), ("tpu_asr_tools", False)])
def test_whole_top_level_names(monkeypatch, name, flagged):
    for n in [m for m in sys.modules
              if m.split(".")[0] in harness.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, n)
    monkeypatch.setitem(sys.modules, name, object())
    assert (name in harness.forbidden_modules()) is flagged


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _sources(folder):
    for d, _, files in os.walk(folder):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_benchmark_sources_import_no_jax():
    for path in _sources(BENCH):
        for mod in _imports(path):
            assert mod.split(".")[0] not in harness.FORBIDDEN, (path, mod)


def test_reference_imports_nothing_of_the_program():
    for path in _sources(os.path.join(BENCH, "reference")):
        for mod in _imports(path):
            assert mod.split(".")[0] in ("__future__", "math", "numpy",
                                         "torch"), (path, mod)


def test_a_run_loads_no_jax_module():
    """What a run imports (the harness, both drivers, the port's modules
    that they build) leaves no forbidden module in sys.modules."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark import harness\n"
        "for w in ('st_train_b128k', 'st_serve_joint_c64'):\n"
        "    c = harness.Cell(w); c.driver; c.reference\n"
        "    [c.module('metrics', m['name']) for m in c.per_layer()]\n"
        "import tpu_asr_torch.train.loop, tpu_asr_torch.serve\n"
        "import tpu_asr_torch.decode.recognizer, tpu_asr_torch.models\n"
        "print(harness.forbidden_modules())\n" % harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
