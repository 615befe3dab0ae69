"""The reference against the program at a tiny size on the CPU, and the
check's verdict on a run whose timed path is broken underneath.

A run here skips the harness's look for a card and drives the rest of it:
the program's set-up, the mode's window, the comparison with the
reference. Unbroken it comes out correct; with half of each batch left out,
or with one detection altered where post-processing produces it, it does
not. The reference computes only what the configuration states: float32
and the exact top-k."""

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
