"""The port's official KITTI evaluator against the JAX package's.

The GT annos are the infos of the synthetic fixture tree (4 scenes); the
detections are those GTs perturbed in position, size, heading and image
box, with extra false positives and random scores. Both evaluators run
once with the native C++ library (each package's own build of the same
sources) and once on their numpy paths.

Tolerance: the result string and every value of the result dict are
equal. The matching is integer bookkeeping over the overlaps; the numpy
paths are the same arithmetic, and the native libraries are the same C++
sources, built with other flags (the JAX package's with -march=native, so
its products may contract to FMAs), which moves an overlap by f32 rounding
at most, far from the 0.5 / 0.7 IoU thresholds on these boxes. The host
geometry helpers are compared directly to that rounding (rtol 1e-5, atol
1e-5 of areas of a few m^2).
"""

import copy
import pickle

import numpy as np
import pytest

from kitti_fixture import build_kitti_root

from hvpr_tpu.datasets.kitti.kitti_dataset import create_kitti_infos as jax_create_infos
from hvpr_tpu.datasets.kitti.kitti_object_eval_python import eval as jax_eval
from hvpr_tpu.native import geometry as jax_geometry
from hvpr_tpu.ops import points_in_boxes as jax_pib
from hvpr_tpu.ops import rotated_iou as jax_iou

from hvpr_tpu_torch.datasets.kitti.kitti_object_eval_python import eval as port_eval
from hvpr_tpu_torch.native import geometry as port_geometry
from hvpr_tpu_torch.ops import points_in_boxes as port_pib
from hvpr_tpu_torch.ops import rotated_iou as port_iou


@pytest.fixture(scope='module')
def gt_annos(tmp_path_factory):
    root, _ = build_kitti_root(tmp_path_factory.mktemp('kitti_eval') / 'kitti', n_scenes=4)
    jax_create_infos(None, ['Car'], root, root, workers=2)
    with open(root / 'kitti_infos_trainval.pkl', 'rb') as f:
        return [info['annos'] for info in pickle.load(f)]


def perturbed_detections(gt_annos, seed=0):
    rng = np.random.default_rng(seed)
    dets = []
    for gt in gt_annos:
        keep = gt['name'] != 'DontCare'
        n = int(keep.sum())
        d = {k: np.array(gt[k][keep], dtype=np.float64) for k in
             ('alpha', 'bbox', 'dimensions', 'location', 'rotation_y')}
        d['location'] += rng.normal(0, 0.25, d['location'].shape)
        d['dimensions'] *= rng.uniform(0.85, 1.15, d['dimensions'].shape)
        d['rotation_y'] += rng.normal(0, 0.2, n)
        d['alpha'] += rng.normal(0, 0.2, n)
        d['bbox'] += rng.normal(0, 4.0, d['bbox'].shape)
        # a few false positives far from any car
        m = 5
        d['location'] = np.concatenate([d['location'],
                                        rng.uniform([-10, 1, 10], [10, 2, 40], (m, 3))])
        d['dimensions'] = np.concatenate([d['dimensions'], np.tile([3.9, 1.56, 1.6], (m, 1))])
        d['bbox'] = np.concatenate([d['bbox'], rng.uniform(0, 300, (m, 4)).cumsum(axis=1)])
        for k in ('rotation_y', 'alpha'):
            d[k] = np.concatenate([d[k], rng.uniform(-np.pi, np.pi, m)])
        d['name'] = np.array(['Car'] * (n + m))
        d['score'] = rng.uniform(0.1, 1.0, n + m)
        order = rng.permutation(n + m)
        dets.append({k: v[order] for k, v in d.items()})
    return dets


@pytest.fixture(params=['native', 'numpy'])
def path(request, monkeypatch):
    if request.param == 'native':
        if not (jax_geometry.available() and port_geometry.available()):
            pytest.skip('no C++ compiler for the native geometry library')
    else:
        monkeypatch.setattr(jax_geometry, 'available', lambda: False)
        monkeypatch.setattr(port_geometry, 'available', lambda: False)
    return request.param


@pytest.mark.parametrize('seed', [0, 1])
def test_official_result_matches_jax(gt_annos, path, seed):
    dets = perturbed_detections(gt_annos, seed)
    want_str, want = jax_eval.get_official_eval_result(
        copy.deepcopy(gt_annos), copy.deepcopy(dets), ['Car'])
    got_str, got = port_eval.get_official_eval_result(
        copy.deepcopy(gt_annos), copy.deepcopy(dets), ['Car'])
    assert got_str == want_str
    assert got.keys() == want.keys()
    for k in want:
        assert float(got[k]) == float(want[k]), k
    # the perturbation leaves some but not all matches at 0.7 IoU
    assert 0.0 < float(got['Car_bev/moderate']) < 100.0, got_str


def test_host_geometry_matches_jax(gt_annos, path):
    rng = np.random.default_rng(4)
    a = np.concatenate([gt_annos[0]['gt_boxes_lidar'],
                        rng.uniform([0, -10, -2, 1, 1, 1, -3], [40, 10, 0, 5, 3, 2, 3], (20, 7))])
    b = a + rng.normal(0, 0.3, a.shape)
    for fn in ('boxes_overlap_bev_cpu', 'boxes_bev_iou_cpu'):
        want, got = getattr(jax_iou, fn)(a, b), getattr(port_iou, fn)(a, b)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=fn)
    pts = rng.uniform([0, -10, -2], [40, 10, 0], (2000, 3)).astype(np.float32)
    np.testing.assert_array_equal(port_pib.points_in_boxes_cpu(pts, a),
                                  jax_pib.points_in_boxes_cpu(pts, a))
