"""SECOND's configuration, reference, work module and sparse metrics on the
CPU, at a tiny range of ``configs/second.json`` (its published widths, 256
x 128 x 40 voxels, 512 NMS candidates: the CPU's plain rotated IoU of
4,096 takes ~15 s a scan): a run is correct; the work module's site lists
count the same pairs and sites as the reference's masks and as the
program's counters; the readers read those counters, and nothing where the
program recorded none."""

import copy
import json
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from harness.program import Program
from harness.run_cell import run_cell
from harness.spec import BENCH_DIR, Cell, load_reader
from reference.second import Reference
from traffic.scans import pool
from work import second as work
from work.flops import H100
from tiny import write_search_dir

SEED = 2 ** 31 + 2207
READERS = ('backbone_3d_ms.infer', 'sparse_lookup_ms.infer', 'sparse_product_ms.infer',
           'sparse_site_fill.infer', 'sparse_conv_roofline.infer')


def tiny_second():
    cfg = copy.deepcopy(json.loads((BENCH_DIR / 'configs' / 'second.json').read_text()))
    cfg['name'] = 'tiny_second'
    cfg['DATA_CONFIG']['POINT_CLOUD_RANGE'] = [0, -3.2, -3, 12.8, 3.2, 1]
    for p in cfg['DATA_CONFIG']['DATA_PROCESSOR']:
        if p['NAME'] == 'transform_points_to_voxels':
            p['MAX_NUMBER_OF_VOXELS'] = {'train': 4000, 'test': 4000}
    cfg['MODEL']['POST_PROCESSING']['NMS_CONFIG']['NMS_PRE_MAXSIZE'] = 512
    cfg['weights']['draws'] = 2            # one a batch of the tiny pool
    return cfg


@pytest.fixture(scope='module')
def cell(tmp_path_factory):
    root = tmp_path_factory.mktemp('second')
    bench_json = write_search_dir(root, bench_cells=())
    (root / 'configs' / 'tiny_second.json').write_text(json.dumps(tiny_second()))
    limits = json.loads((BENCH_DIR / 'workloads' / 'second.infer.b4.json').read_text())['limits']
    (root / 'workloads' / 'tiny_second.infer.json').write_text(json.dumps(
        {'config': 'tiny_second', 'compare_scans': 3, 'limits': limits}))
    bench = json.loads(bench_json.read_text())
    bench['workloads'] = [{'name': 'tiny_second.infer', 'config': 'tiny_second',
                           'traffic': 'tiny_b2', 'chips': 1, 'why': 'a CPU test'}]
    bench_json.write_text(json.dumps(bench))
    return Cell('tiny_second.infer', bench_json=bench_json, search=[root])


def test_the_configuration_is_upstreams_at_its_widths():
    cell = Cell('second.infer.b4')
    cfg = cell.config
    assert cfg['reduced'] == [] and cfg['MODEL']['NAME'] == 'SECONDNet'
    assert cfg['port_keys']['MODEL.BACKBONE_3D.UPSTREAM_GEOMETRY'] is True
    assert cfg['MODEL']['BACKBONE_3D']['UPSTREAM_GEOMETRY'] is True
    assert [s[4:] for s in work.conv_specs(cfg)] == [
        (4, 16), (16, 16), (16, 32), (32, 32), (32, 32), (32, 64), (64, 64), (64, 64),
        (64, 64), (64, 64), (64, 64), (64, 128)]
    assert cell.traffic['batch'] == 4 and cell.traffic['points_per_scan'] == 20000
    assert {m['name'] for m in cell.per_layer} >= set(READERS)


def test_a_tiny_second_run_is_correct(cell):
    result = run_cell(cell, SEED, 0.0, False, 'cpu', time.perf_counter(), lambda m: None)
    assert result['correct'], result['checks']
    assert result['checks']['cls_gap']['value'] < 1e-4


def test_the_site_lists_count_the_reference_masks(cell):
    """:func:`work.second.conv_sites` on the reference's voxelization gives
    each conv's pairs and output sites as the reference's masks count them."""
    pts, _ = pool(cell.traffic, SEED, cell.config['DATA_CONFIG']['POINT_CLOUD_RANGE'])
    weights = Program(cell, SEED, 'cpu').weights[0]
    reference = Reference(cell.config, weights, 'cpu', count=True)
    reference.forward(pts[0, 0])
    sites = work.scan_sites(cell.config, pts[0, 0])
    assert [(p, o) for p, _, o in sites] == reference.conv_counts
    assert sites[2][2] > sites[2][1]        # a strided conv dilates the active set


def _recorded(cell):
    """The program's record of one request of pool batch 0 and the scans."""
    from hvpr_tpu_torch.utils import profiler
    pts, _ = pool(cell.traffic, SEED, cell.config['DATA_CONFIG']['POINT_CLOUD_RANGE'])
    program = Program(cell, SEED, 'cpu')
    profiler.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        program.detect(torch.from_numpy(pts[0]), torch.ones(pts.shape[1:3], dtype=torch.bool),
                       key=0)
    profiler.record()
    return pts[0]


def test_the_program_counts_what_the_work_module_counts(cell):
    scans = _recorded(cell)
    from harness.spans import program_spans
    convs = [s for s in program_spans() if s['name'] == 'sparse.conv']
    want = np.sum([work.scan_sites(cell.config, s) for s in scans], axis=0)
    got = [(s['counters']['sparse.pairs'], s['counters']['sparse.sites']) for s in convs]
    np.testing.assert_array_equal(np.asarray(got), want[:, [0, 2]])
    assert [(s['attrs']['c_in'], s['attrs']['c_out']) for s in convs] == [
        spec[4:] for spec in work.conv_specs(cell.config)]

    rec = SimpleNamespace(spans={'backbone_3d': [10.0]}, rates=H100)
    values = {name: load_reader(name, [BENCH_DIR])(rec) for name in READERS}
    assert values['backbone_3d_ms.infer'] == 10.0
    assert values['sparse_lookup_ms.infer'] is None        # no device time off the card
    assert values['sparse_product_ms.infer'] is None
    slots = sum(s['counters']['sparse.slots'] for s in convs)
    assert values['sparse_site_fill.infer'] == pytest.approx(100.0 * want[:, 2].sum() / slots)
    bound = sum(work.bound_s(*work.conv_work(p, i, o, 27 if spec[0] == (3, 3, 3) else 3,
                                             *spec[4:]), H100)
                for (p, i, o), spec in zip(want, work.conv_specs(cell.config)))
    assert values['sparse_conv_roofline.infer'] == pytest.approx(100.0 * bound / 10e-3)


def test_nothing_to_read_without_the_programs_sparse_spans(monkeypatch):
    import harness.spans
    rec = SimpleNamespace(spans={}, rates=H100)
    for record in (None, [{'name': 'pipeline', 'id': 0, 'parent': None, 'request': 0,
                           'device_ms': 1.0, 'attrs': {}, 'counters': {}}]):
        monkeypatch.setattr(harness.spans, 'program_spans', lambda record=record: record)
        for name in READERS:
            assert load_reader(name, [BENCH_DIR])(rec) is None, name
