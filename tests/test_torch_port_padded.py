"""The padded (host-voxelized) layout of the port against the JAX package's
padded branches, and against the port's own flat layout.

The padded batch is the data layer's: each scan voxelized by
``VoxelGeneratorNumpy`` (spconv order: pillars first-seen, the first P
points of each), padded to hvpr_mini.yaml's 256 pillars of 8 points.

Tolerances: against the JAX package those of ``test_torch_port_mini.py``
(f32; the stages repeat the JAX arithmetic up to summation order, rtol 1e-4
with atol 1e-5 of the largest value, and map_to_bev's bf16 memory weights
rtol 1e-2, atol 1e-3 of the largest). Within the port none: the padded
branch sums along P in the flat branch's order and writes the centres of
``voxel_coords`` in its expression, so the detections of the two layouts
on the same points are equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import Pair, check_stage, mini_cfg, to_np

from hvpr_tpu.models.detectors.detector3d_template import post_processing as jax_post

from hvpr_tpu_torch.models.backbones_3d.vfe.pillar_vfe import _sums_along_p
from hvpr_tpu_torch.ops.scatter import segment_sums_t
from hvpr_tpu_torch.ops.voxelizer import VoxelGeneratorNumpy

TOL = {'vfe': (1e-4, 1e-5), 'map_to_bev': (1e-2, 1e-3),
       'backbone_2d': (1e-4, 1e-5), 'dense_head': (1e-4, 1e-5)}


@pytest.fixture(scope='module')
def pair():
    return Pair(mini_cfg(), batch=2, n_points=256)


def padded_batch(pair):
    """The scans of ``pair`` host-voxelized into a padded numpy batch."""
    m = pair.meta
    gen = VoxelGeneratorNumpy(m.voxel_size, m.point_cloud_range,
                              m.max_points_per_voxel, m.max_voxels)
    b, v, p = pair.points.shape[0], m.max_voxels, m.max_points_per_voxel
    batch = {'voxels': np.zeros((b, v, p, 4), np.float32),
             'voxel_coords': np.zeros((b, v, 3), np.int32),
             'voxel_num_points': np.zeros((b, v), np.int32)}
    for i in range(b):
        vox, coords, cnt = gen.generate(pair.points[i][pair.mask[i]])
        batch['voxels'][i, :len(vox)] = vox
        batch['voxel_coords'][i, :len(vox)] = coords
        batch['voxel_num_points'][i, :len(vox)] = cnt
    batch['voxel_mask'] = batch['voxel_num_points'] > 0
    return batch


@pytest.fixture(scope='module')
def padded(pair):
    return padded_batch(pair)


@pytest.fixture(scope='module')
def jout(pair, padded):
    return pair.jnet.module.apply(pair.jnet.variables,
                                  {k: jnp.asarray(v) for k, v in padded.items()},
                                  train=False)


@pytest.mark.parametrize('p', [8, 20, 32])
def test_sums_along_p_equal_the_flat_sweep(p):
    """The padded branch's pillar sums along P equal, bit for bit, the flat
    branch's segment sums over the same points (the plain sweep that K1
    equals), for full, ragged and empty pillars and P not a power of 2."""
    rng = np.random.default_rng(p)
    b, v = 2, 16
    counts = rng.integers(0, p + 1, (b, v))
    counts[0, :3] = (0, 1, p)
    x = rng.normal(0.0, 30.0, (b, v, p, 3)).astype(np.float32)
    x[np.arange(p)[None, None, :] >= counts[..., None]] = 0.0
    got = _sums_along_p(torch.from_numpy(x)).reshape(-1, 3).t()
    mask = torch.from_numpy((np.arange(p)[None, None, :] < counts[..., None]).reshape(-1))
    slot = torch.arange(b * v, dtype=torch.int32).repeat_interleave(p)
    safe_slot = torch.where(mask, slot, b * v).to(torch.int32)
    want = segment_sums_t(torch.from_numpy(x).reshape(-1, 3).t().contiguous(), safe_slot, p)
    assert torch.equal(got[:, mask], want[:, mask])


def test_padded_batch_fills_the_pillar_cap(padded):
    cnt = padded['voxel_num_points']
    assert cnt.max() == 8 and (cnt > 0).sum(axis=1).min() > 100


def test_padded_vfe_matches_flax(pair, padded, jout):
    with torch.no_grad():
        out = pair.tnet.module.vfe({k: torch.from_numpy(v) for k, v in padded.items()})
    rtol, atol_frac = TOL['vfe']
    for k in ('pillar_features', 'pillar_scale_features'):
        want, got = to_np(jout[k]), to_np(out[k])
        assert got.shape == want.shape, k
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_frac * np.abs(want).max(),
                                   err_msg=k)


@pytest.mark.parametrize('stage', ['map_to_bev', 'backbone_2d', 'dense_head'])
def test_padded_stages_match_flax(pair, jout, stage):
    """The eval map_to_bev on unsorted (first-seen) pillars takes the plain
    scatter; it and the stages after it match the JAX padded run."""
    check_stage(pair, jout, stage, TOL[stage])


def test_padded_detections_match_jax(pair, padded, jout):
    post_cfg = pair.cfg.MODEL.POST_PROCESSING
    want = jax_post(jout, post_cfg, 1)
    got = pair.tnet.eval_forward({k: torch.from_numpy(v) for k, v in padded.items()})
    mask = np.asarray(want['pred_mask'])
    np.testing.assert_array_equal(got['pred_mask'].numpy(), mask)
    assert mask.sum() > 0
    for k in ('pred_boxes', 'pred_scores'):
        np.testing.assert_allclose(got[k].numpy()[mask], np.asarray(want[k])[mask],
                                   rtol=1e-4, atol=1e-4, err_msg=k)


def test_padded_and_flat_layouts_agree(pair, padded):
    """Same points, same weights: the host-voxelized padded batch and the
    device voxelizer's flat one give the same canvases and detections."""
    net = pair.tnet
    pts, mask = torch.from_numpy(pair.points), torch.from_numpy(pair.mask)
    with torch.no_grad():
        pout = net.module({k: torch.from_numpy(v) for k, v in padded.items()})
        fout = net.module(net.voxelize(pts, mask))
    for k in ('spatial_features', 'spatial_scale_features', 'batch_cls_preds',
              'batch_box_preds'):
        assert torch.equal(pout[k], fout[k]), k
    a = net.eval_forward({k: torch.from_numpy(v) for k, v in padded.items()})
    b = net.pipeline(pts, mask)
    for k in ('pred_mask', 'pred_boxes', 'pred_scores', 'pred_labels'):
        assert torch.equal(a[k], b[k]), k
