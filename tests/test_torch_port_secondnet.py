"""SECOND on the port's normal path against the benchmark's plain reference,
on the CPU: the registered ``SECONDNet`` built by ``build_network(...,
train=False)`` from ``benchmark/configs/second.json``'s MODEL and run by
``Network.pipeline`` (the device voxelizer's flat layout, MeanVFE, the
sparse VoxelBackBone8x in upstream's geometry, HeightCompression,
BaseBEVBackbone, AnchorHeadSingle over three classes), held to
``benchmark/reference/second.py`` (dense ``conv3d`` on the grid by the
convs' definitions) on seeded weights (``benchmark/reference/weights.py``).

The configuration is the benchmark's at its published widths on a 3.2 x
1.6 m range (64 x 32 x 40 voxels of 0.05 x 0.05 x 0.1 m, so that conv_out
leaves D = 2 and the geometry shows), 2 scans of clustered points.

Tolerances and why: the head's logits and residuals within 1e-4 of the
reference's standard deviation (rms, the benchmark's ``cls_gap`` and
``box_gap``): both sides are float32 and sum the same products in other
orders (gathered rows @ a tap's weight against ``conv3d``), errors of
~1e-6; the reference in bfloat16 (the control) misses it by more than ten
times, and the JAX package's geometry (40 z cells, conv4 padding 1) by
more than a hundred. No
heading is on the other direction bin. MeanVFE's flat form equals the
padded one bit for bit, and the counters equal the reference's counts
exactly: they are integers.
"""

import copy
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_port_helpers import torch_threads

from hvpr_tpu_torch.config import ConfigDict
from hvpr_tpu_torch.models import DatasetMeta, build_network
from hvpr_tpu_torch.models.backbones_3d.vfe.pillar_vfe import MeanVFE
from hvpr_tpu_torch.ops.voxelizer import voxelize_batch_flat
from hvpr_tpu_torch.utils import profiler

BENCH = Path(__file__).resolve().parents[1] / 'benchmark'
if str(BENCH) not in sys.path:
    sys.path.append(str(BENCH))

from reference.compare import head_gaps  # noqa: E402
from reference.second import Reference, voxelize3d  # noqa: E402
from reference.weights import make_weights  # noqa: E402

B, N = 2, 1500
GAP = 1e-4


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    with torch_threads(1):
        yield


def tiny_cfg(upstream=True):
    cfg = copy.deepcopy(json.loads((BENCH / 'configs' / 'second.json').read_text()))
    cfg['DATA_CONFIG']['POINT_CLOUD_RANGE'] = [0, -0.8, -3, 3.2, 0.8, 1]
    for p in cfg['DATA_CONFIG']['DATA_PROCESSOR']:
        if p['NAME'] == 'transform_points_to_voxels':
            p['MAX_NUMBER_OF_VOXELS'] = {'train': 3000, 'test': 3000}
    cfg['MODEL']['BACKBONE_3D']['UPSTREAM_GEOMETRY'] = upstream
    return cfg


def scans(seed=0):
    """(B, N, 4) points around 3 objects a scan, a few outside the range;
    a sixth of them in a 10 cm knot at the first object, so that some
    voxels hold more points than MeanVFE keeps."""
    rng = np.random.default_rng(seed)
    pts = np.zeros((B, N, 4), np.float32)
    centres = rng.uniform([0.5, -0.5, -2.0], [2.7, 0.5, 0.0], (B, 3, 3))
    pick = rng.integers(0, 3, (B, N))
    pts[..., :3] = (np.take_along_axis(centres, pick[..., None], 1)
                    + rng.normal(0, [0.3, 0.2, 0.3], (B, N, 3)))
    pts[:, :N // 6, :3] = centres[:, :1] + rng.normal(0, 0.03, (B, N // 6, 3))
    pts[..., 3] = rng.uniform(0, 1, (B, N))
    return pts


class Second:
    """The port's network on the CPU with seeded weights, and what one
    pipeline call gave."""

    def __init__(self, cfg, weights=None):
        self.cfg = cfg
        self.meta = DatasetMeta(ConfigDict(cfg['DATA_CONFIG']), cfg['CLASS_NAMES'], mode='test')
        self.net = build_network(ConfigDict(cfg['MODEL']), len(cfg['CLASS_NAMES']), self.meta,
                                 device='cpu', train=False)
        state = self.net.module.state_dict()
        if weights is None:
            shapes = {k: tuple(v.shape) for k, v in state.items() if v.is_floating_point()}
            weights = make_weights(shapes, 3, 'cpu', cls_bias=0, box_std=0.001)
        self.weights = weights
        state.update(weights)
        self.net.load_state_dict(state)
        self.head = {}
        self.net.module.dense_head.register_forward_hook(
            lambda _m, _a, out: self.head.update(cls=out['batch_cls_preds'],
                                                 boxes=out['batch_box_preds']))

    def run(self, points):
        pts = torch.from_numpy(points)
        return self.net.pipeline(pts, torch.ones(pts.shape[:2], dtype=torch.bool))


@pytest.fixture(scope='module')
def upstream():
    port = Second(tiny_cfg())
    points = scans()
    det = port.run(points)
    return port, points, det


def gaps(port, points, reference):
    out = []
    for b in range(B):
        ref = reference.forward(points[b])
        out.append(head_gaps(port.head['cls'][b], port.head['boxes'][b, :, :7], ref,
                             reference.anchors))
    return np.max(out, axis=0)


def test_secondnet_pipeline_matches_the_reference(upstream):
    port, points, det = upstream
    assert type(port.net.module).__name__ == 'SECONDNet'
    assert port.net.module.backbone_3d is not None
    assert port.head['cls'].shape == (B, 8 * 4 * 6, 3)
    cls_gap, box_gap, dir_flips = gaps(port, points, Reference(port.cfg, port.weights, 'cpu'))
    assert cls_gap <= GAP and box_gap <= GAP, (cls_gap, box_gap)
    assert dir_flips == 0
    assert det['pred_mask'].sum() > 0
    assert set(det['pred_labels'][det['pred_mask']].tolist()) <= {1, 2, 3}


def test_the_bf16_control_fails_the_tolerance(upstream):
    port, points, _ = upstream
    cls_gap, box_gap, _ = gaps(port, points, Reference(port.cfg, port.weights, 'cpu', lowp=True))
    assert max(cls_gap, box_gap) > 10 * GAP, (cls_gap, box_gap)


def test_the_jax_geometry_fails_the_upstream_reference(upstream):
    port, points, _ = upstream
    jax_geometry = Second(tiny_cfg(upstream=False), weights=port.weights)
    assert not jax_geometry.net.module.backbone_3d.upstream_geometry
    jax_geometry.run(points)
    cls_gap, box_gap, _ = gaps(jax_geometry, points, Reference(port.cfg, port.weights, 'cpu'))
    assert max(cls_gap, box_gap) > 100 * GAP, (cls_gap, box_gap)


def test_flat_mean_vfe_equals_the_padded_one(upstream):
    """The device voxelizer's flat batch and the padded voxels of the same
    scans (the reference's voxelization: linear cell order, the first 5
    points of a voxel in input order) give the same features bit for bit."""
    port, points, _ = upstream
    meta = port.meta
    flat = voxelize_batch_flat(torch.from_numpy(points), torch.ones(B, N, dtype=torch.bool),
                               tuple(float(v) for v in meta.point_cloud_range),
                               tuple(float(v) for v in meta.voxel_size), meta.max_voxels,
                               meta.max_points_per_voxel,
                               tuple(int(g) for g in meta.grid_size))
    v, p = meta.max_voxels, meta.max_points_per_voxel
    padded = {'voxels': np.zeros((B, v, p, 4), np.float32),
              'voxel_num_points': np.zeros((B, v), np.int32)}
    for b in range(B):
        vox, num, coords = voxelize3d(points[b], meta.point_cloud_range, meta.voxel_size,
                                      meta.grid_size, v, p)
        padded['voxels'][b, :len(num)] = vox
        padded['voxel_num_points'][b, :len(num)] = num
        np.testing.assert_array_equal(flat['voxel_coords'][b, :len(num)].numpy(), coords)
    assert (padded['voxel_num_points'] == 5).any() and (padded['voxel_num_points'] < 5).any()
    vfe = MeanVFE({}, 4, max_points_per_voxel=p)
    got = vfe(dict(flat))['pillar_features']
    want = vfe({k: torch.from_numpy(a) for k, a in padded.items()})['pillar_features']
    assert torch.equal(got, want)


def test_sparse_counters_equal_the_reference_counts(upstream):
    """Each conv's ``sparse.pairs`` and ``sparse.sites`` (summed over the
    batch) equal the counts of the reference's masks, in the convs' order;
    ``sparse.slots`` is the batch times the site slots."""
    port, points, _ = upstream
    profiler.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        port.run(points)
    spans = profiler.record()
    profiler.clear()
    convs = [s for s in spans if s['name'] == 'sparse.conv']
    names = {s['name'] for s in spans}
    assert {'sparse', 'sparse.lookup', 'sparse.product', 'sparse.densify'} <= names
    reference = Reference(port.cfg, port.weights, 'cpu', count=True)
    want = np.zeros((len(reference.convs), 2), np.int64)
    for b in range(B):
        reference.conv_counts = []
        reference.forward(points[b])
        want += np.asarray(reference.conv_counts)
    got = [(s['counters']['sparse.pairs'], s['counters']['sparse.sites']) for s in convs]
    np.testing.assert_array_equal(np.asarray(got), want)
    slots = [s['counters']['sparse.slots'] for s in convs]
    v = port.meta.max_voxels
    assert slots == [B * v] * 2 + [B * 2 * v] * (len(convs) - 2)
    assert [(s['attrs']['c_in'], s['attrs']['c_out']) for s in convs][:3] == [
        (4, 16), (16, 16), (16, 32)]
