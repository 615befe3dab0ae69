"""The port's PointPillar detector (pointpillar.yaml's modules) against the
JAX package on the CPU: PillarVFE in the flat and padded layouts with 4 and
5 point channels, PointPillarScatter, BaseBEVBackbone with a fractional
upsampling stride and the extra deblock, the eval detections, and a train
step's loss terms and gradients leaf by leaf.

The configuration is pointpillar.yaml's MODEL on a 5.12 x 5.12 m range (a
32 x 32 pillar grid with a slot for each of its pillars, so that both
layouts keep the same ones) with a narrow two-level backbone,
UPSAMPLE_STRIDES [0.5, 1, 2] (a strided-conv upsampling, a transpose conv
and the extra deblock after the concat); the 5-channel variant adds the
nuScenes time-lag channel (11 decorated channels) at
pointpillar_nuscenes.yaml's 20 points a pillar. Weights: the JAX package's
initialization with BN statistics and affine terms perturbed from a seed
and the cls bias at 0 (so that the NMS has candidates), carried over by
``from_flax_variables``.

Tolerances (f32 everywhere) and why: the stages repeat the JAX arithmetic
and differ in summation order only, so rtol 1e-4 with atol 1e-5 of the
largest value; detections: the same kept sets and labels, boxes and scores
within 1e-4. Within the port none: the padded layout sums along P in the
flat sweep's order, so both layouts give the same canvas bit for bit.
Gradients leaf by leaf within 1e-4 of the leaf (L2 and max) plus 1e-7 of
the global norm, and one step's loss terms rtol 1e-4, as
``test_torch_port_train_step.py`` holds the VFE, backbone and head.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_train_step import TrainPair, assert_close, check_gradients, check_steps
from torch_port_helpers import load_cfg, to_np, to_torch, torch_threads

from hvpr_tpu.models.detectors.detector3d_template import post_processing as jax_post

from hvpr_tpu_torch.models.backbones_2d.base_bev_backbone import BaseBEVBackbone
from hvpr_tpu_torch.ops.voxelizer import VoxelGeneratorNumpy
from hvpr_tpu_torch.utils.weights import from_flax_variables

TOL = (1e-4, 1e-5)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    with torch_threads(1):
        yield


def pp_cfg(channels=4):
    cfg = load_cfg('pointpillar.yaml')
    cfg.DATA_CONFIG.POINT_CLOUD_RANGE = [0, -2.56, -2.5, 5.12, 2.56, 0.5]
    for p in cfg.DATA_CONFIG.DATA_PROCESSOR:
        if p['NAME'] == 'transform_points_to_voxels':
            p['MAX_NUMBER_OF_VOXELS'] = {'train': 1024, 'test': 1024}
            p['MAX_POINTS_PER_VOXEL'] = 32 if channels == 4 else 20
    if channels == 5:
        enc = cfg.DATA_CONFIG.POINT_FEATURE_ENCODING
        enc['used_feature_list'] = ['x', 'y', 'z', 'intensity', 'timestamp']
        enc['src_feature_list'] = ['x', 'y', 'z', 'intensity', 'timestamp']
    b2d = cfg.MODEL.BACKBONE_2D
    b2d.LAYER_NUMS, b2d.LAYER_STRIDES, b2d.NUM_FILTERS = [1, 1], [2, 2], [16, 32]
    b2d.UPSAMPLE_STRIDES, b2d.NUM_UPSAMPLE_FILTERS = [0.5, 1, 2], [16, 16]
    nms = cfg.MODEL.POST_PROCESSING.NMS_CONFIG
    nms.NMS_PRE_MAXSIZE, nms.NMS_POST_MAXSIZE = 256, 64
    return cfg


def padded_batch(pair):
    """The pair's scans host-voxelized into a padded batch (first-seen
    pillars, the first P points of each), with the pair's gt boxes."""
    m = pair.meta
    gen = VoxelGeneratorNumpy(m.voxel_size, m.point_cloud_range,
                              m.max_points_per_voxel, m.max_voxels)
    b, c = pair.points.shape[0], pair.points.shape[2]
    v, p = m.max_voxels, m.max_points_per_voxel
    batch = {'voxels': np.zeros((b, v, p, c), np.float32),
             'voxel_coords': np.zeros((b, v, 3), np.int32),
             'voxel_num_points': np.zeros((b, v), np.int32)}
    for i in range(b):
        vox, coords, cnt = gen.generate(pair.points[i][pair.mask[i]])
        batch['voxels'][i, :len(vox)] = vox
        batch['voxel_coords'][i, :len(vox)] = coords
        batch['voxel_num_points'][i, :len(vox)] = cnt
    batch['voxel_mask'] = batch['voxel_num_points'] > 0
    batch['gt_boxes'] = pair.gt
    return batch


@pytest.fixture(scope='module', params=[4, 5], ids=['4ch', '5ch'])
def pair(request):
    return TrainPair(pp_cfg(request.param), n_points=512, cls_bias=0.0)


@pytest.fixture(scope='module')
def padded(pair):
    return padded_batch(pair)


def jax_eval(pair, batch):
    out = pair.jnet.module.apply(pair.variables,
                                 {k: jnp.asarray(v) for k, v in batch.items()
                                  if k != 'gt_boxes'}, train=False)
    return out


def port_eval(pair, batch):
    pair.reset()
    pair.tnet.module.eval()
    with torch.no_grad():
        return pair.tnet.module({k: torch.from_numpy(np.array(v)) for k, v in batch.items()
                                 if k != 'gt_boxes'})


@pytest.mark.parametrize('layout', ['flat', 'padded'])
def test_pillar_vfe_matches_jax(pair, padded, layout):
    batch = dict(pair.jbatch) if layout == 'flat' else padded
    want, got = jax_eval(pair, batch), port_eval(pair, batch)
    c_dec = pair.tnet.module.vfe.pfn_layers[0].linear.in_features
    assert c_dec == pair.meta.num_point_features + 6          # 10 or 11
    assert_close(got['pillar_features'], want['pillar_features'], *TOL, 'pillar_features')
    assert float(np.abs(to_np(want['pillar_features'])).max()) > 0


def test_flat_and_padded_layouts_give_the_same_canvas_and_boxes(pair, padded):
    """The same points through both layouts: the pillar canvas (the flat one
    in cell order through the canvas kernel's plain version, the padded one
    in first-seen order through the scatter) and the head's outputs are
    equal bit for bit."""
    flat_out, pad_out = port_eval(pair, dict(pair.jbatch)), port_eval(pair, padded)
    for k in ('spatial_features', 'batch_cls_preds', 'batch_box_preds'):
        assert torch.equal(flat_out[k], pad_out[k]), k


@pytest.mark.parametrize('stage', ['map_to_bev_module', 'backbone_2d', 'dense_head'])
def test_stages_match_jax(pair, stage):
    jout = jax_eval(pair, dict(pair.jbatch))
    keys_in, keys_out = {
        'map_to_bev_module': (('pillar_features', 'voxel_coords', 'voxel_mask',
                               'flat_points'), ('spatial_features',)),
        'backbone_2d': (('spatial_features',), ('spatial_features_2d',)),
        'dense_head': (('spatial_features_2d',), ('batch_cls_preds', 'batch_box_preds')),
    }[stage]
    pair.reset()
    module = getattr(pair.tnet.module, stage).eval()
    with torch.no_grad():
        out = module({k: to_torch(jout[k]) for k in keys_in})
    for k in keys_out:
        assert_close(out[k], jout[k], *TOL, f'{stage}: {k}')


def test_backbone_levels_and_output_channels():
    """A fractional stride's level is a strided conv, a stride of 1 or more
    a transpose conv, and the extra deblock follows the concat."""
    cfg = pp_cfg().MODEL.BACKBONE_2D
    bb = BaseBEVBackbone(cfg, 64)
    assert [type(d[0]).__name__ for d in bb.deblocks] == \
        ['Conv2d', 'ConvTranspose2d', 'ConvTranspose2d']
    assert bb.deblocks[0][0].stride == (2, 2) and bb.deblocks[2][0].stride == (2, 2)
    assert bb.num_bev_features == 32
    out = bb.eval()({'spatial_features': torch.zeros(1, 32, 32, 64)})
    assert out['spatial_features_2d'].shape == (1, 16, 16, 32)


@pytest.mark.parametrize('layout', ['flat', 'padded'])
def test_eval_detections_match_jax(pair, padded, layout):
    batch = dict(pair.jbatch) if layout == 'flat' else padded
    post_cfg = pair.cfg.MODEL.POST_PROCESSING
    want = jax_post(jax_eval(pair, batch), post_cfg, len(pair.cfg.CLASS_NAMES))
    pair.reset()
    got = pair.tnet.eval_forward({k: torch.from_numpy(np.array(v)) for k, v in batch.items()
                                  if k != 'gt_boxes'})
    mask = np.asarray(want['pred_mask'])
    assert mask.sum() > 0
    np.testing.assert_array_equal(got['pred_mask'].numpy(), mask)
    np.testing.assert_array_equal(got['pred_labels'].numpy()[mask],
                                  np.asarray(want['pred_labels'])[mask])
    for k in ('pred_boxes', 'pred_scores'):
        np.testing.assert_allclose(got[k].numpy()[mask], np.asarray(want[k])[mask],
                                   rtol=1e-4, atol=1e-4, err_msg=k)


def test_from_flax_variables_maps_every_leaf(pair):
    """Each flax leaf lands on its own port key and every key of the
    port's module is fed (``Network.load_state_dict`` is strict too)."""
    state = from_flax_variables(pair.flat)
    keys = [k for k in state if not k.endswith('num_batches_tracked')]
    assert len(keys) == len(pair.flat)
    assert set(state) == set(pair.tnet.module.state_dict())
    assert any(k.startswith('backbone_2d.deblocks.2.') for k in keys)


def test_gradients_match_jax_leaf_by_leaf(pair):
    check_gradients(pair, grad_tol=lambda name: 1e-4)


def test_train_step_matches_jax(pair):
    """One step on the flat batch: the JAX head's tb keys, the point path's
    terms and the memory term zero (no point stream, no memory)."""
    tm = check_steps(pair, 1)
    for k in ('rpn_loss_cls_pt', 'rpn_loss_loc_pt', 'rpn_loss_dir_pt', 'mem_loss',
              'rpn_loss_point'):
        assert tm[0][k] == 0.0, k
    assert tm[0]['rpn_loss_cls'] > 0 and tm[0]['rpn_loss_loc'] > 0


def test_padded_train_step_matches_jax(pair, padded):
    """The train CLI's layout: one step on the padded batch."""
    padded_pair = TrainPair(pair.cfg, host_batch=padded, cls_bias=0.0)
    check_steps(padded_pair, 1)
