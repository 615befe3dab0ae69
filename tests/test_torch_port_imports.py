"""The port stands alone: no file of hvpr_tpu_torch/ or chip_smoke.py
imports jax, flax or the JAX package."""

import ast
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'hvpr_tpu')
FILES = sorted((REPO / 'hvpr_tpu_torch').rglob('*.py')) + [REPO / 'chip_smoke.py']


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ''


@pytest.mark.parametrize('path', FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported(tree) if m.split('.')[0] in FORBIDDEN]
    assert not bad, f'{path}: imports {bad}'


def test_port_package_imports_without_jax():
    """Importing every module of the port loads no JAX module."""
    import subprocess
    import sys
    code = ('import sys, pkgutil, importlib, hvpr_tpu_torch\n'
            'for m in pkgutil.walk_packages(hvpr_tpu_torch.__path__, "hvpr_tpu_torch."):\n'
            '    importlib.import_module(m.name)\n'
            'bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "hvpr_tpu")]\n'
            'assert not bad, bad\n')
    subprocess.run([sys.executable, '-c', code], cwd=REPO, check=True, timeout=120)
