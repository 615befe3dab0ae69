"""Nothing the harness loads is JAX or the JAX package, by whole top-level
name: ``hvpr_tpu_torch`` is the program, ``hvpr_tpu`` is not allowed."""

import subprocess
import sys

from harness.run_cell import FORBIDDEN, forbidden_modules
from harness.spec import BENCH_DIR, REPO_ROOT

SCRIPT = f"""
import sys, time
sys.path[:0] = [{str(BENCH_DIR)!r}, {str(REPO_ROOT)!r}, {str(BENCH_DIR / 'tests')!r}]
import tempfile
from pathlib import Path
import torch
torch.set_num_threads(2)
from harness.run_cell import run_cell, forbidden_modules
from harness.spec import Cell
from harness.control import Control
import harness.trace, harness.stats, modes.infer
from tiny import write_search_dir
d = Path(tempfile.mkdtemp())
cell = Cell('tiny_hvpr.infer', bench_json=write_search_dir(d), search=[d])
run_cell(cell, 1, 0.1, False, 'cpu', time.perf_counter(), lambda m: None)
for m in cell.readers(True) + cell.readers(False):
    pass
print('LOADED', ' '.join(sorted(sys.modules)))
print('FORBIDDEN', forbidden_modules())
"""


def test_names_are_compared_whole():
    sys.modules.setdefault('hvpr_tpu_torch_fake_probe', type(sys)('hvpr_tpu_torch_fake_probe'))
    assert 'hvpr_tpu_torch' not in FORBIDDEN
    assert all(not n.startswith('hvpr_tpu_torch') for n in forbidden_modules())


def test_no_module_the_harness_loads_is_jax_or_the_jax_package():
    out = subprocess.run([sys.executable, '-c', SCRIPT], capture_output=True, text=True,
                         timeout=600, cwd=REPO_ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = {ln.split(' ', 1)[0]: ln for ln in out.stdout.splitlines()}
    loaded = lines['LOADED'].split()[1:]
    assert 'hvpr_tpu_torch' in loaded
    assert not [m for m in loaded if m.split('.')[0] in FORBIDDEN]
    assert lines['FORBIDDEN'] == 'FORBIDDEN []'
