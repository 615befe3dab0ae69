"""The reference against the program at a tiny size on the CPU, and the
check's verdict on a run whose timed path is broken underneath.

A run here skips the harness's look for a card and drives the rest of it:
the program's set-up, the mode's window, the comparison with the
reference. Unbroken it comes out correct; with half of each batch left out,
or with one detection altered where post-processing produces it, it does
not. The reference computes only what the configuration states: float32
and the exact top-k. At one class the check's numbers are those of the
single-class check of commit d1c9d2b, bit for bit, and the configuration's
work module counts what ``pipeline_flops`` counts."""

import time

import numpy as np
import pytest
import torch

from harness import faults
from harness.run_cell import run_cell
from harness.spec import Cell
from reference.nms import overlapping_pairs
from tiny import write_search_dir

SEED = 2 ** 31 + 101
# the numbers of the single-class check (benchmark/ at commit d1c9d2b) at
# one seed, for the tiny HVPR on the CPU
SINGLE_CLASS_SEED = 2147483952
SINGLE_CLASS = {
    'program': {'cls_gap': 3.239575584188588e-05, 'box_gap': 2.846014734609241e-05,
                'dir_flips': 0.0, 'det_mismatch': 0.0, 'det_unmatched': 0.0},
    'control': {'cls_gap': 0.007429335032683936, 'box_gap': 0.16904263985998386,
                'dir_flips': 0.0029296875, 'det_mismatch': 0.8333333333333334,
                'det_unmatched': 0.0},
}


def _run(tmp_path, name, seconds=0.5, program_factory=None):
    bench = write_search_dir(tmp_path)
    cell = Cell(name, bench_json=bench, search=[tmp_path])
    return run_cell(cell, SEED, seconds, False, 'cpu', time.perf_counter(), lambda m: None,
                    program_factory=program_factory)


@pytest.mark.parametrize('name', ['tiny_hvpr.infer'])
def test_reference_agrees_with_the_program_at_a_tiny_size(tmp_path, name):
    result = _run(tmp_path, name)
    assert result['correct'], result['checks']
    assert result['checks']['det_unmatched']['value'] == 0


@pytest.mark.parametrize('fault', [faults.half_batch, faults.altered_answer])
def test_a_broken_timed_path_is_not_correct(tmp_path, fault):
    result = _run(tmp_path, 'tiny_hvpr.infer', program_factory=fault)
    assert not result['correct'], result['checks']


@pytest.mark.parametrize('side', sorted(SINGLE_CLASS))
def test_one_class_reads_as_the_single_class_check(tmp_path, side):
    from tools.readings import readings
    cell = Cell('tiny_hvpr.infer', bench_json=write_search_dir(tmp_path), search=[tmp_path])
    cell.config['weights'].pop('draws')     # that check drew the weights from the run's seed
    assert readings(cell, SINGLE_CLASS_SEED, 'cpu', side) == SINGLE_CLASS[side]


def test_every_seed_runs_the_same_weight_draws(tmp_path):
    from harness.program import Program
    from reference.weights import make_weights
    cell = Cell('tiny_hvpr.infer', bench_json=write_search_dir(tmp_path), search=[tmp_path])
    progs = [Program(cell, seed, 'cpu') for seed in (SEED, SEED + 1)]
    assert [len(p.weights) for p in progs] == [2, 2] and len(progs[0].nets) == 2
    shapes = {k: tuple(v.shape) for k, v in progs[0].weights[1].items()}
    scheme = cell.config['weights']
    want = make_weights(shapes, 1, 'cpu', cls_bias=scheme['cls_bias'], box_std=scheme['box_std'])
    for p in progs:
        assert all(torch.equal(p.weights[1][k], want[k]) for k in want)
        state = p.net_of(3).module.state_dict()
        assert all(torch.equal(state[k], want[k]) for k in want)
        p.close()


def test_hvprs_work_is_pipeline_flops_over_the_references_voxelization(tmp_path):
    from reference.model import point_and_pillar_counts
    from traffic.scans import pool
    from work.flops import pipeline_flops
    cell = Cell('tiny_hvpr.infer', bench_json=write_search_dir(tmp_path), search=[tmp_path])
    cfg = cell.config
    pcr = cfg['DATA_CONFIG']['POINT_CLOUD_RANGE']
    scans = pool(cell.traffic, SEED, pcr)[0][0]
    counts = [point_and_pillar_counts(s, pcr, [0.16, 0.16, 3], [64, 64, 1], 1500, 32)
              for s in scans]
    assert all(points > 0 and pillars > 0 for points, pillars in counts)
    assert cell.work().batch_flops(cfg, scans) == pipeline_flops(cfg, counts)


def test_polygon_iou_against_the_programs_rotated_iou():
    from hvpr_tpu_torch.ops.rotated_iou import boxes_iou_bev
    rng = np.random.default_rng(3)
    n = 64
    boxes = np.zeros((n, 7), np.float32)
    boxes[:, :2] = rng.uniform(0, 6, (n, 2))
    boxes[:, 3:5] = rng.uniform(0.5, 4, (n, 2))
    boxes[:, 5] = 1.5
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, n)
    boxes[1] = boxes[0]                          # identical boxes: IoU 1
    t = torch.from_numpy(boxes)
    i, j, iou = overlapping_pairs(t)
    want = boxes_iou_bev(t, t).double()
    np.testing.assert_allclose(iou.numpy(), want[i, j].numpy(), atol=2e-5)
    assert float(iou[(i == 0) & (j == 1)]) == pytest.approx(1.0)
    far = torch.ones(n, n, dtype=torch.bool)
    far[i, j] = False
    far &= torch.triu(torch.ones(n, n, dtype=torch.bool), 1)
    assert float(want[far].max()) == 0.0          # every pair left out has no overlap


@pytest.mark.parametrize('key, value', [('MODEL.BACKBONE_2D.COMPUTE_DTYPE', 'bf16'),
                                        ('MODEL.MAP_TO_BEV.CANVAS_DTYPE', 'bf16'),
                                        ('MODEL.MAP_TO_BEV.TOPK_MODE', 'fused')])
def test_the_reference_refuses_a_configuration_it_does_not_compute(key, value):
    from reference.model import Reference
    from tiny import tiny_config
    cfg = tiny_config()
    *path, last = key.split('.')
    node = cfg
    for k in path:
        node = node[k]
    node[last] = value
    with pytest.raises(ValueError):
        Reference(cfg, {}, 'cpu')
