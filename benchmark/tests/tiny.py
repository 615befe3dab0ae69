"""A tiny HVPR for the CPU tests, written as a search directory of the
benchmark (configs/, traffic/, workloads/) and a BENCHMARK.json that names
its cells."""

import copy
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
TINY_CELLS = ('tiny_hvpr.infer',)


def tiny_config(name='hvpr'):
    cfg = json.loads((BENCH / 'configs' / f'{name}.json').read_text())
    cfg = copy.deepcopy(cfg)
    cfg['name'] = f'tiny_{name}'
    cfg['DATA_CONFIG']['POINT_CLOUD_RANGE'] = [0, -5.12, -2.5, 10.24, 5.12, 0.5]
    for p in cfg['DATA_CONFIG']['DATA_PROCESSOR']:
        if p['NAME'] == 'transform_points_to_voxels':
            p['MAX_NUMBER_OF_VOXELS'] = {'train': 1500, 'test': 1500}
    model = cfg['MODEL']
    bb = model['BACKBONE_2D']
    bb['NUM_FILTERS'] = [16, 32, 64]
    bb['NUM_UPSAMPLE_FILTERS'] = [16, 16, 16]
    bb['LAYER_NUMS'] = [1, 1, 1]
    bb['NUM_SCALE_FILTERS'] = [8, 16, 32]
    bb['SFM_LAYER_NUMS'] = [2, 2, 2]
    model['MAP_TO_BEV']['NUM_M'] = 256
    if 'draws' in cfg['weights']:
        cfg['weights']['draws'] = 2        # one a batch of the tiny pool
    return cfg


def write_search_dir(root, bench_cells=TINY_CELLS):
    """Write the tiny cells under ``root``; returns the BENCHMARK.json path."""
    root = Path(root)
    for kind in ('configs', 'traffic', 'workloads', 'metrics'):
        (root / kind).mkdir(parents=True, exist_ok=True)
    (root / 'configs' / 'tiny_hvpr.json').write_text(json.dumps(tiny_config()))
    (root / 'traffic' / 'tiny_b2.json').write_text(json.dumps(
        {'mode': 'infer', 'generator': 'realistic_scans', 'batch': 2,
         'points_per_scan': 12000, 'pool_batches': 2}))
    # float32 against the float32 reference, the memory's output rounded to
    # bf16 by the program's exact lookup: far under these limits at this size
    limits = {'cls_gap': 0.05, 'box_gap': 0.05, 'dir_flips': 0.02, 'det_mismatch': 0.05,
              'det_unmatched': 0}
    cells = {'tiny_hvpr.infer': ('tiny_hvpr', 'tiny_b2')}
    for name, (cfg, _) in cells.items():
        (root / 'workloads' / f'{name}.json').write_text(json.dumps(
            {'config': cfg, 'compare_scans': 3, 'limits': limits}))
    bench = json.loads((BENCH.parent / 'BENCHMARK.json').read_text())
    bench['workloads'] = [{'name': n, 'config': cells[n][0], 'traffic': cells[n][1],
                           'chips': 1, 'why': 'a CPU test'} for n in bench_cells]
    for m in bench['end_to_end'] + bench['per_layer']:
        m.pop('workloads', None)
    path = root / 'BENCHMARK.json'
    path.write_text(json.dumps(bench))
    return path
