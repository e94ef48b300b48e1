"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names (the port's name begins with the JAX
package's), and the reference imports nothing of the program."""

import ast
import json
import subprocess
import sys

from conftest import ROOT
from perfbench.core import FORBIDDEN

LOAD_ALL = """
import json, sys, importlib, importlib.util
sys.path[0] = {root!r}
from perfbench import core
spec = json.load(open({root!r} + '/BENCHMARK.json'))
kinds = {{core.load_cell(w['name'])['traffic']['kind'] for w in spec['workloads']}}
for k in kinds:
    importlib.import_module('perfbench.kinds.' + k)
for m in spec['end_to_end'] + spec['per_layer']:
    p = core.HERE / 'metrics' / (m['name'] + '.py')
    s = importlib.util.spec_from_file_location('m_' + m['name'].replace('.', '_'), p)
    s.loader.exec_module(importlib.util.module_from_spec(s))
import perfbench.inputs, perfbench.trace, perfbench.counts.model
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def test_run_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", LOAD_ALL.format(
        root=str(ROOT))], capture_output=True, text=True, timeout=300,
        cwd=ROOT, check=True)
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "spnet_tpu_torch" in top and "perfbench" in top
    assert not top & set(FORBIDDEN)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_no_program():
    files = sorted((ROOT / "perfbench" / "reference").glob("*.py"))
    assert files
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in ("spnet_tpu_torch",) + FORBIDDEN, (f, name)


def test_no_benchmark_file_names_the_jax_package():
    for f in (ROOT / "perfbench").rglob("*.py"):
        for name in _imports(f):
            assert name.split(".")[0] not in FORBIDDEN, (f, name)
