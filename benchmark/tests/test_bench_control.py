"""On the card: the control fails each cell's check, and the program passes
it, at the cell's own widths and sizes (a detection cell on two sampled
scans).

The control is the reference in the program's place, computed in the
nearest precision below the configuration's (``Reference(lowp=True)``). Its
readings on three seeds or more, and the program's on a dozen, are made by
``benchmark/tools/readings.py``; ``PERF.md`` keeps them and the limits set
between them. ``python -m pytest benchmark/tests -q -m cuda`` on the card."""

import json

import pytest

from harness.run_cell import cli_flags
from harness.spec import REPO_ROOT, Cell

CELLS = [w['name'] for w in json.loads((REPO_ROOT / 'BENCHMARK.json').read_text())['workloads']]
SEEDS = (2 ** 31 + 301, 2 ** 31 + 302, 2 ** 31 + 303)


def _readings(name, seed, side):
    from tools.readings import readings
    cell = Cell(name)
    cell.file['compare_scans'] = 2
    return cell, readings(cell, seed, 'cuda', side)


@pytest.mark.cuda
@pytest.mark.parametrize('seed', SEEDS)
@pytest.mark.parametrize('name', CELLS)
def test_the_control_fails_the_check(card, name, seed):
    cli_flags()
    cell, numbers = _readings(name, seed, 'control')
    limits = cell.file['limits']
    assert any(numbers[k] > float(limits[k]) for k in limits), numbers


@pytest.mark.cuda
@pytest.mark.parametrize('name', CELLS)
def test_the_program_passes_the_check(card, name):
    cli_flags()
    cell, numbers = _readings(name, SEEDS[0], 'program')
    limits = cell.file['limits']
    assert all(numbers[k] <= float(limits[k]) for k in limits), numbers
