"""Every cell and metric is found by name from its files, BENCHMARK.json
keeps to the benchmark's contract, and a cell, a configuration and a metric
are added by adding files only."""

import json
import re
import time
from pathlib import Path

import pytest

from harness.run_cell import run_cell
from harness.spec import BENCH_DIR, REPO_ROOT, Cell
from tiny import tiny_config, write_search_dir

BENCH = json.loads((REPO_ROOT / 'BENCHMARK.json').read_text())
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
CELLS = [w['name'] for w in BENCH['workloads']]


@pytest.mark.parametrize('name', CELLS)
def test_every_cell_is_found_by_name(name):
    cell = Cell(name)
    assert (BENCH_DIR / 'modes' / f'{cell.mode}.py').exists()
    keys = {'cls_gap', 'box_gap', 'dir_flips', 'det_mismatch', 'det_unmatched'}
    assert cell.file['limits'] and set(cell.file['limits']) <= keys
    for trace in (False, True):
        for entry, read in cell.readers(trace):
            assert callable(read), entry['name']
    names = {m['name'] for m in cell.end_to_end}
    assert 'setup_s' in names and len(names) >= 2
    assert cell.per_layer


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs', 'workloads',
                          'end_to_end', 'per_layer'}
    assert BENCH['paths'] == ['benchmark'] and BENCH['command'][1].startswith('benchmark/')
    assert 1 <= BENCH['run_seconds'] <= 51
    cells = 24
    assert (2 + 14 * cells) * (BENCH['run_seconds'] + 60) + cells * 180 + 1200 <= 43200
    configs = {c['name'] for c in BENCH['configs']}
    for c in BENCH['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert NAME.match(c['name']) and (REPO_ROOT / c['file']).exists()
        assert c['file'].startswith('benchmark/') and len(c['reduced']) <= 16
        assert all(NAME.match(k) for k in c['reduced'])
        assert any(w['config'] == c['name'] for w in BENCH['workloads'])
    pairs = set()
    for w in BENCH['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert w['config'] in configs and w['chips'] in (1, 4) and len(w['why']) <= 200
        assert NAME.match(w['name']) and NAME.match(w['traffic'])
        assert (w['config'], w['traffic']) not in pairs
        pairs.add((w['config'], w['traffic']))
    metrics = BENCH['end_to_end'] + BENCH['per_layer']
    assert len({m['name'] for m in metrics}) == len(metrics)
    e2e = {m['name'] for m in BENCH['end_to_end']}
    assert 'setup_s' in e2e
    for m in BENCH['end_to_end']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'bound', 'source'}
        assert 0.01 <= m['bound'] <= 0.25 and m['source'] in ('host_clock', 'device_trace')
    for m in BENCH['per_layer']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'source', 'layer', 'moves'}
        assert m['moves'] in e2e and m['source'] in ('device_trace', 'program_span',
                                                      'program_counter', 'host_clock')
        reporting = {w for w in CELLS if any(
            e['name'] == m['moves'] and ('workloads' not in e or w in e['workloads'])
            for e in BENCH['end_to_end'])}
        assert set(m.get('workloads', CELLS)) <= reporting
    for m in metrics:
        assert NAME.match(m['name']) and UNIT.match(m['unit']) and m['better'] in ('lower', 'higher')
        assert (BENCH_DIR / 'metrics' / f'{m["name"]}.py').exists()
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_a_cell_config_and_metric_are_added_by_files_alone(tmp_path):
    """A dummy cell with its own configuration, traffic and per-layer metric,
    all in a temporary directory searched before the benchmark's own."""
    bench_json = write_search_dir(tmp_path, bench_cells=())
    cfg = tiny_config()
    cfg['name'] = 'dummy_hvpr'
    cfg['MODEL']['MAP_TO_BEV']['NUM_K'] = 8
    (tmp_path / 'configs' / 'dummy_hvpr.json').write_text(json.dumps(cfg))
    (tmp_path / 'traffic' / 'dummy_b1.json').write_text(json.dumps(
        {'mode': 'infer', 'generator': 'realistic_scans', 'batch': 1,
         'points_per_scan': 10000, 'pool_batches': 2}))
    (tmp_path / 'workloads' / 'dummy.infer.json').write_text(json.dumps(
        {'config': 'dummy_hvpr', 'compare_scans': 2,
         'limits': {'cls_gap': 0.05, 'det_unmatched': 0}}))
    (tmp_path / 'metrics' / 'dummy_requests.py').write_text(
        'def read(rec):\n    return len(rec.requests)\n')
    bench = json.loads(Path(bench_json).read_text())
    bench['configs'].append({'name': 'dummy_hvpr', 'source': 'a CPU test',
                             'file': 'configs/dummy_hvpr.json', 'reduced': [], 'why': 'a test'})
    bench['workloads'].append({'name': 'dummy.infer', 'config': 'dummy_hvpr',
                               'traffic': 'dummy_b1', 'chips': 1, 'why': 'a CPU test'})
    bench['per_layer'].append({'name': 'dummy_requests', 'unit': 'requests', 'better': 'higher',
                               'source': 'host_clock', 'layer': 'device', 'moves': 'setup_s',
                               'workloads': ['dummy.infer']})
    Path(bench_json).write_text(json.dumps(bench))
    cell = Cell('dummy.infer', bench_json=bench_json, search=[tmp_path])
    assert cell.config['name'] == 'dummy_hvpr' and cell.traffic['batch'] == 1
    assert 'dummy_requests' in [m['name'] for m in cell.per_layer]
    result = run_cell(cell, 7, 0.2, True, 'cpu', time.perf_counter(), lambda m: None)
    assert result['metrics']['dummy_requests']['value'] >= 1
    assert result['correct'], result['checks']


def test_a_configuration_on_a_base_is_the_base_with_its_own_keys():
    from harness.spec import load_config, load_json
    own = load_json('configs', 'hvpr_prior', [BENCH_DIR])
    prior = load_config('hvpr_prior', [BENCH_DIR])
    hvpr = load_config('hvpr', [BENCH_DIR])
    assert own['base'] == 'hvpr' and 'base' not in prior
    assert set(prior) == set(hvpr) | (set(own) - {'base'})
    assert {k for k in hvpr if prior[k] != hvpr[k]} == {'name', 'weights'}
    assert prior['weights']['cls_bias'] == 'prior' and hvpr['weights']['cls_bias'] == 0
