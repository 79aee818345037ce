"""Nothing the benchmark runs imports JAX or the JAX package, checked by
each module's whole top-level name (the port's ``watsor_tpu_torch`` is
not ``watsor_tpu``); the reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

from benchmark.lib import cell
from benchmark.tests.cpu import REPO

BENCH = os.path.join(REPO, 'benchmark')
REFERENCE = ['lib/plain.py', 'lib/post.py', 'lib/check.py', 'lib/work.py',
             'lib/stats.py',
             'configs/efficientdet_lite4.py']


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split('.')[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split('.')[0])
    return names


def sources():
    for directory, _, files in os.walk(BENCH):
        for name in files:
            if name.endswith('.py'):
                yield os.path.join(directory, name)


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    for name in ('watsor_tpu_torch', 'watsor_tpu_torch.models',
                 'jaxtyping', 'flaxen'):
        monkeypatch.setitem(sys.modules, name, sys)
    assert cell.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, 'watsor_tpu.ops', sys)
    monkeypatch.setitem(sys.modules, 'jax.numpy', sys)
    assert cell.forbidden_modules() == ['jax', 'watsor_tpu']


def test_no_benchmark_source_imports_jax_or_the_jax_package():
    for path in sources():
        found = top_level_imports(path) & set(cell.FORBIDDEN)
        assert not found, (path, found)


def test_the_reference_imports_nothing_of_the_program():
    for rel in REFERENCE:
        names = top_level_imports(os.path.join(BENCH, rel))
        assert 'watsor_tpu_torch' not in names, rel
        assert not names & set(cell.FORBIDDEN), rel


def test_a_run_s_modules_hold_no_jax():
    """Import what a run imports, the program's built path included, in a
    fresh interpreter, and list its top-level modules."""
    code = ('import sys, torch\n'
            'from benchmark.lib import cell, control, program, faults\n'
            'import watsor_tpu_torch.detection.backend\n'
            'import watsor_tpu_torch.models.zoo, '
            'watsor_tpu_torch.models.efficientdet\n'
            'print(cell.forbidden_modules())\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == '[]'
