"""The port's sparse voxel path against the JAX package on the CPU: MeanVFE,
the sparse VoxelBackBone8x, HeightCompression, the three dense 3D backbones
and the SECOND composition end to end (the port's registered ``SECONDNet``
against the SecondNet of ``tests/test_second_style.py``: MeanVFE -> sparse
VoxelBackBone8x -> HeightCompression -> BaseBEVBackbone -> AnchorHeadSingle,
in the JAX package's geometry), in eval and in training (the loss and
gradient leaves against ``jax.grad``).

The grid is 64 x 32 x 40 cells (0.16 x 0.16 x 0.1 m, KITTI's 40 z cells),
so that conv_out leaves D = 2 and HeightCompression's channel order
(d*C + c, the JAX package's) is seen. Scans are seeded numpy points,
voxelized by the port's ``VoxelGeneratorNumpy`` into a padded batch of 2
(first-seen voxels, 5 points each); the dense backbones take unique random
voxels on the JAX test's grids (8, 8, 8) and (9, 11, 5)
(``tests/test_spconv_dense_backbones.py``). Weights: the JAX package's
initialization, BN statistics and affine terms perturbed from a seed,
carried over by ``from_flax_variables``, which must land every leaf
exactly once.

Tolerances (f32) and why: sites, masks and ``sparse_sites_dropped`` exactly
equal; features within 1e-5 of the output's largest magnitude plus rtol
1e-4 (the products sum in another order; the BN statistics are reductions
in another order, and flax's BatchNorm takes the variance as E[x^2] -
E[x]^2); detections: the same kept sets and labels, boxes and scores
within 1e-4; loss terms rtol 1e-4; gradient leaves within 1e-4 of the leaf
(L2 and max) plus 1e-7 of the global norm, as the other train tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from torch_port_helpers import torch_threads

from hvpr_tpu.config import ConfigDict
from hvpr_tpu.models.backbones_3d import spconv_backbone as jax_spconv
from hvpr_tpu.models.backbones_3d.sparse_backbone import VoxelBackBone8xSparse as JaxSparse
from hvpr_tpu.models.backbones_3d.vfe.pillar_vfe import MeanVFE as JaxMeanVFE
from hvpr_tpu.models.backbones_2d.map_to_bev.height_compression import (
    HeightCompression as JaxHeightCompression)
from hvpr_tpu.models.detectors.detector3d_template import post_processing as jax_post
from hvpr_tpu.models.detectors.pointpillar import PointPillar as JaxPointPillar

from hvpr_tpu_torch.models.backbones_2d.map_to_bev.height_compression import HeightCompression
from hvpr_tpu_torch.models.backbones_3d import spconv_backbone
from hvpr_tpu_torch.models.backbones_3d.sparse_backbone import VoxelBackBone8xSparse
from hvpr_tpu_torch.models.backbones_3d.vfe.pillar_vfe import MeanVFE
from hvpr_tpu_torch.models.detectors.detector3d_template import post_processing
from hvpr_tpu_torch.models.detectors.pointpillar import SECONDNet
from hvpr_tpu_torch.ops.voxelizer import VoxelGeneratorNumpy
from hvpr_tpu_torch.utils.weights import from_flax_variables

PCR = (0.0, -2.56, -3.0, 10.24, 2.56, 1.0)
VOXEL = (0.16, 0.16, 0.1)
GRID = (64, 32, 40)                        # nx, ny, nz
V, P, B = 256, 5, 2
TOL = (1e-4, 1e-5)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    with torch_threads(1):
        yield


def second_cfg(head='AnchorHeadSingle'):
    anchors = [{'class_name': 'Car', 'anchor_sizes': [[3.9, 1.6, 1.56]],
                'anchor_rotations': [0, 1.57], 'anchor_bottom_heights': [-1.78],
                'align_center': False, 'feature_map_stride': 8,
                'matched_threshold': 0.6, 'unmatched_threshold': 0.45}]
    return ConfigDict({
        'NAME': 'PointPillar',
        'VFE': {'NAME': 'MeanVFE'},
        'BACKBONE_3D': {'NAME': 'VoxelBackBone8x', 'NUM_FILTERS': [16, 32, 32],
                        'OUT_CHANNELS': 32},
        'MAP_TO_BEV': {'NAME': 'HeightCompression', 'NUM_BEV_FEATURES': 64},
        'BACKBONE_2D': {'NAME': 'BaseBEVBackbone', 'LAYER_NUMS': [1, 1],
                        'LAYER_STRIDES': [1, 2], 'NUM_FILTERS': [32, 64],
                        'UPSAMPLE_STRIDES': [1, 2], 'NUM_UPSAMPLE_FILTERS': [32, 32]},
        'DENSE_HEAD': {
            'NAME': head, 'CLASS_AGNOSTIC': False, 'USE_DIRECTION_CLASSIFIER': True,
            'DIR_OFFSET': 0.78539, 'DIR_LIMIT_OFFSET': 0.0, 'NUM_DIR_BINS': 2,
            'ANCHOR_GENERATOR_CONFIG': anchors,
            'TARGET_ASSIGNER_CONFIG': {'NAME': 'AxisAlignedTargetAssigner',
                                       'POS_FRACTION': -1.0, 'SAMPLE_SIZE': 512,
                                       'NORM_BY_NUM_EXAMPLES': False,
                                       'MATCH_HEIGHT': False, 'BOX_CODER': 'ResidualCoder'},
            'LOSS_CONFIG': {'LOSS_WEIGHTS': {'cls_weight': 1.0, 'loc_weight': 2.0,
                                             'dir_weight': 0.2,
                                             'code_weights': [1.0] * 7}}},
        'POST_PROCESSING': {'RECALL_THRESH_LIST': [0.3, 0.5, 0.7], 'SCORE_THRESH': 0.1,
                            'OUTPUT_RAW_SCORE': False, 'EVAL_METRIC': 'kitti',
                            'NMS_CONFIG': {'MULTI_CLASSES_NMS': False, 'NMS_TYPE': 'nms_gpu',
                                           'NMS_THRESH': 0.01, 'NMS_PRE_MAXSIZE': 256,
                                           'NMS_POST_MAXSIZE': 32}},
    })


class JaxSecondNet(JaxPointPillar):
    """tests/test_second_style.py's composition."""

    def __call__(self, batch_dict, train: bool = False):
        batch_dict = dict(batch_dict)
        for stage in (self.vfe, self.backbone_3d, self.map_to_bev, self.backbone_2d,
                      self.dense_head):
            batch_dict = stage(batch_dict, train)
        return batch_dict


def scans(rng, b=B, n=600):
    """Points in the range (a few outside), clustered around 4 objects."""
    lo, hi = np.asarray(PCR[:3]), np.asarray(PCR[3:])
    pts = np.zeros((b, n, 4), np.float32)
    pts[..., :3] = lo - 0.02 * (hi - lo) + rng.uniform(0, 1.04, (b, n, 3)) * (hi - lo)
    centres = lo + rng.uniform(0.2, 0.8, (b, 4, 3)) * (hi - lo)
    k = n // 2
    pick = rng.integers(0, 4, (b, k))
    pts[:, :k, :3] = (np.take_along_axis(centres, pick[..., None], 1)
                      + rng.normal(0, 0.3, (b, k, 3)))
    pts[..., 3] = rng.uniform(0, 1, (b, n))
    return pts


def padded_batch(points):
    gen = VoxelGeneratorNumpy(VOXEL, PCR, P, V)
    b, _, c = points.shape
    batch = {'voxels': np.zeros((b, V, P, c), np.float32),
             'voxel_coords': np.zeros((b, V, 3), np.int32),
             'voxel_num_points': np.zeros((b, V), np.int32)}
    for i in range(b):
        vox, coords, cnt = gen.generate(points[i])
        batch['voxels'][i, :len(vox)] = vox
        batch['voxel_coords'][i, :len(vox)] = coords
        batch['voxel_num_points'][i, :len(vox)] = cnt
    batch['voxel_mask'] = batch['voxel_num_points'] > 0
    return batch


def gt_boxes():
    gt = np.zeros((B, 4, 8), np.float32)
    gt[:, 0] = [3.0, 0.5, -1.0, 3.9, 1.6, 1.56, 0.3, 1]
    gt[:, 1] = [7.5, -1.0, -0.9, 4.2, 1.7, 1.5, -1.2, 1]
    gt[1, 2] = [5.0, 1.2, -1.1, 3.6, 1.5, 1.5, 1.4, 1]
    return gt


def perturbed(variables, rng):
    """Flat numpy variables with the BN statistics and affine terms moved."""
    flat = {'/'.join(k): np.asarray(v)
            for k, v in traverse_util.flatten_dict(variables).items()}
    for key in flat:
        if key.startswith('batch_stats/') and key.endswith('/mean'):
            flat[key] = rng.normal(0, 0.1, flat[key].shape).astype(np.float32)
        elif key.startswith('batch_stats/') and key.endswith('/var'):
            flat[key] = rng.uniform(0.5, 2.0, flat[key].shape).astype(np.float32)
        elif key.endswith('/scale') or (key.endswith('/bias') and 'BatchNorm' in key):
            flat[key] = (flat[key] + rng.normal(0, 0.1, flat[key].shape)).astype(np.float32)
    return flat


def unflatten(flat):
    return traverse_util.unflatten_dict({tuple(k.split('/')): jnp.asarray(v)
                                         for k, v in flat.items()})


def to_t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def close(got, want, what, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol[0],
                               atol=tol[1] * max(float(np.abs(want).max()), 1e-30),
                               err_msg=what)


class SecondPair:
    """The JAX SecondNet and the port's SECONDNet with the same weights."""

    def __init__(self, cfg, seed=0):
        self.cfg = cfg
        rng = np.random.default_rng(seed)
        self.batch = padded_batch(scans(rng))
        self.gt = gt_boxes()
        kw = dict(model_cfg=cfg, num_class=1, class_names=['Car'], grid_size=GRID,
                  point_cloud_range=PCR, voxel_size=VOXEL, num_point_features=4)
        self.jmod = JaxSecondNet(**kw)
        variables = self.jmod.init(jax.random.PRNGKey(seed), self.jbatch(), train=False)
        self.flat = perturbed(variables, rng)
        self.flat['params/dense_head/conv_cls/bias'] = np.zeros_like(
            self.flat['params/dense_head/conv_cls/bias'])     # candidates reach NMS
        self.variables = unflatten(self.flat)
        self.tmod = SECONDNet(**kw, max_points_per_voxel=P)
        self.state = from_flax_variables(self.flat)
        self.tmod.load_state_dict(self.state, strict=True)

    def jbatch(self, train=False):
        out = {k: jnp.asarray(v) for k, v in self.batch.items()}
        if train:
            out['gt_boxes'] = jnp.asarray(self.gt)
        return out

    def tbatch(self, train=False):
        out = to_t(self.batch)
        if train:
            out['gt_boxes'] = torch.from_numpy(self.gt)
        return out

    def jax_eval(self):
        return self.jmod.apply(self.variables, self.jbatch(), train=False)

    def port_eval(self):
        self.tmod.load_state_dict(self.state, strict=True)
        self.tmod.eval()
        with torch.no_grad():
            return self.tmod(self.tbatch())


@pytest.fixture(scope='module')
def pair():
    return SecondPair(second_cfg())


@pytest.fixture(scope='module')
def evals(pair):
    return pair.jax_eval(), pair.port_eval()


def test_mean_vfe_matches_jax(pair):
    want = JaxMeanVFE(model_cfg={}, num_point_features=4).apply({}, pair.jbatch())
    mod = MeanVFE({}, 4)
    got = mod(pair.tbatch())
    assert mod.get_output_feature_dim() == 4
    close(got['pillar_features'], want['pillar_features'], 'pillar_features')


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
def test_sparse_backbone_matches_jax(pair, train):
    """The sparse backbone alone at the default cap (sites kept exactly)
    and at MAX_SITES 40, which drops sites: the same count in both."""
    for cap in (None, 40):
        cfg = {'NUM_FILTERS': [16, 32, 32], 'OUT_CHANNELS': 32}
        if cap is not None:
            cfg['MAX_SITES'] = cap
        jmod = JaxSparse(model_cfg=cfg, input_channels=4, grid_size=GRID)
        jin = JaxMeanVFE(model_cfg={}, num_point_features=4).apply({}, pair.jbatch())
        variables = jmod.init(jax.random.PRNGKey(1), jin, train=False)
        flat = perturbed(variables, np.random.default_rng(1))
        state = from_flax_variables({'/'.join(k.split('/')[:1] + ['backbone_3d']
                                              + k.split('/')[1:]): v
                                     for k, v in flat.items()})
        state = {k[len('backbone_3d.'):]: v for k, v in state.items()}
        mod = VoxelBackBone8xSparse(cfg, 4, GRID)
        mod.load_state_dict(state, strict=True)
        if train:
            want, upd = jmod.apply(unflatten(flat), jin, train=True, mutable=['batch_stats'])
        else:
            want = jmod.apply(unflatten(flat), jin, train=False)
        got = mod.train(train)(MeanVFE({}, 4)(pair.tbatch()))
        np.testing.assert_array_equal(got['sparse_sites_dropped'].numpy(),
                                      np.asarray(want['sparse_sites_dropped']))
        assert (got['sparse_sites_dropped'].numpy() > 0).all() == (cap is not None)
        assert got['encoded_spconv_tensor'].shape == (B, 2, 4, 8, 32)
        close(got['encoded_spconv_tensor'], want['encoded_spconv_tensor'],
              f'encoded_spconv_tensor cap={cap}')
        assert float(np.abs(np.asarray(want['encoded_spconv_tensor'])).max()) > 0
        if train:
            stats = from_flax_variables({'batch_stats/backbone_3d/' + '/'.join(k): np.asarray(v)
                                         for k, v in traverse_util.flatten_dict(
                                             upd['batch_stats']).items()})
            port = mod.state_dict()
            for k, v in stats.items():
                if 'running' in k:
                    close(port[k[len('backbone_3d.'):]], v.numpy(), k)


def test_height_compression_matches_jax(pair, evals):
    """D = 2: the channel of (d, c) is d*C + c, the JAX package's order."""
    jout, _ = evals
    x = np.asarray(jout['encoded_spconv_tensor'])
    want = JaxHeightCompression(model_cfg={'NUM_BEV_FEATURES': 64}).apply(
        {}, {'encoded_spconv_tensor': jnp.asarray(x)})
    got = HeightCompression({'NUM_BEV_FEATURES': 64})({
        'encoded_spconv_tensor': torch.from_numpy(x.copy())})
    assert x.shape[1] == 2
    np.testing.assert_array_equal(got['spatial_features'].numpy(),
                                  np.asarray(want['spatial_features']))
    assert got['spatial_features_stride'] == 8
    c = x.shape[-1]
    np.testing.assert_array_equal(got['spatial_features'].numpy()[..., c:2 * c],
                                  x[:, 1])


def _dense_batch(rng, grid, b=1, v=32, p=4, c=4):
    nx, ny, nz = grid
    cells = np.stack([rng.choice(nx * ny * nz, v, replace=False) for _ in range(b)])
    coords = np.stack([cells // (ny * nx), (cells // nx) % ny, cells % nx], -1)
    return {'voxels': rng.normal(size=(b, v, p, c)).astype(np.float32),
            'voxel_num_points': rng.integers(1, p + 1, (b, v)).astype(np.int32),
            'voxel_coords': coords.astype(np.int32),
            'voxel_mask': np.ones((b, v), bool)}


@pytest.mark.parametrize('grid', [(8, 8, 8), (9, 11, 5)])
@pytest.mark.parametrize('name', ['VoxelBackBone8x', 'VoxelResBackBone8x', 'UNetV2'])
def test_dense_backbones_match_jax(name, grid):
    """Eval (perturbed running statistics) and one training forward (batch
    statistics, the running statistics after it)."""
    rng = np.random.default_rng(4)
    batch = _dense_batch(rng, grid)
    jmod = getattr(jax_spconv, name)(model_cfg={}, input_channels=4, grid_size=grid)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    flat = perturbed(jmod.init(jax.random.PRNGKey(0), jb, train=False), rng)
    state = from_flax_variables({'/'.join(k.split('/')[:1] + ['backbone_3d']
                                          + k.split('/')[1:]): v for k, v in flat.items()})
    state = {k[len('backbone_3d.'):]: v for k, v in state.items()}
    mod = getattr(spconv_backbone, name)({}, 4, grid)
    assert set(mod.state_dict()) == set(state)
    keys = ['encoded_spconv_tensor'] + (['voxel_unet_features'] if name == 'UNetV2' else [])
    for train in (False, True):
        mod.load_state_dict(state, strict=True)
        if train:
            want, upd = jmod.apply(unflatten(flat), jb, train=True, mutable=['batch_stats'])
        else:
            want = jmod.apply(unflatten(flat), jb, train=False)
        got = mod.train(train)(to_t(batch))
        assert got['encoded_spconv_tensor_stride'] == 8
        for k in keys:
            close(got[k], want[k], f'{name} {grid} train={train}: {k}')
        if train:
            stats = from_flax_variables({'batch_stats/backbone_3d/' + '/'.join(k): np.asarray(v)
                                         for k, v in traverse_util.flatten_dict(
                                             upd['batch_stats']).items()})
            for k, v in stats.items():
                if 'running' in k:
                    close(mod.state_dict()[k[len('backbone_3d.'):]], v.numpy(), k)
    if name == 'UNetV2':
        assert got['voxel_unet_features'].shape[1:4] == (grid[2], grid[1], grid[0])


def test_second_stages_match_jax(pair, evals):
    jout, tout = evals
    np.testing.assert_array_equal(tout['sparse_sites_dropped'].numpy(), 0)
    np.testing.assert_array_equal(np.asarray(jout['sparse_sites_dropped']), 0)
    for k in ('pillar_features', 'encoded_spconv_tensor', 'spatial_features',
              'spatial_features_2d', 'batch_cls_preds', 'batch_box_preds'):
        close(tout[k], jout[k], k)


def test_second_detections_match_jax(pair, evals):
    jout, tout = evals
    post = pair.cfg.POST_PROCESSING
    want = jax_post(dict(jout, gt_boxes=jnp.asarray(pair.gt)), post, 1)
    got = post_processing(dict(tout, gt_boxes=torch.from_numpy(pair.gt)), post, 1)
    mask = np.asarray(want['pred_mask'])
    assert mask.sum() > 0
    np.testing.assert_array_equal(got['pred_mask'].numpy(), mask)
    np.testing.assert_array_equal(got['pred_labels'].numpy()[mask],
                                  np.asarray(want['pred_labels'])[mask])
    for k in ('pred_boxes', 'pred_scores'):
        np.testing.assert_allclose(got[k].numpy()[mask], np.asarray(want[k])[mask],
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    for k, v in want['recall'].items():
        assert int(got['recall'][k]) == int(v), k


def test_from_flax_variables_maps_every_leaf(pair):
    keys = [k for k in pair.state if not k.endswith('num_batches_tracked')]
    assert len(keys) == len(pair.flat)
    assert set(pair.state) == set(pair.tmod.state_dict())
    assert {k.split('.')[1] for k in keys if k.startswith('backbone_3d.')} == {
        'conv_input', 'conv1', 'conv2', 'conv3', 'conv4', 'conv_out'}


def test_second_train_loss_and_gradients_match_jax(pair):
    """One training forward: the loss terms, the running statistics after
    it and every gradient leaf against ``jax.grad``."""
    def loss_fn(params):
        out, upd = pair.jmod.apply({'params': params,
                                    'batch_stats': pair.variables['batch_stats']},
                                   pair.jbatch(train=True), train=True,
                                   mutable=['batch_stats'])
        return out['loss'], (out['tb_dict'], upd)

    (jloss, (jtb, jupd)), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        pair.variables['params'])
    pair.tmod.load_state_dict(pair.state, strict=True)
    pair.tmod.train()
    out = pair.tmod(pair.tbatch(train=True))
    params = dict(pair.tmod.named_parameters())
    grads = torch.autograd.grad(out['loss'], list(params.values()))
    np.testing.assert_allclose(float(out['loss'].detach()), float(jloss), rtol=1e-4)
    for k in ('rpn_loss_cls', 'rpn_loss_loc', 'rpn_loss_dir'):
        np.testing.assert_allclose(float(out['tb_dict'][k].detach()), float(jtb[k]), rtol=1e-4,
                                   err_msg=k)
    assert float(jtb['rpn_loss_loc']) > 0
    stats = from_flax_variables({'batch_stats/' + '/'.join(k): np.asarray(v) for k, v in
                                 traverse_util.flatten_dict(jupd['batch_stats']).items()})
    port = pair.tmod.state_dict()
    for k, v in stats.items():
        if 'running' in k:
            close(port[k], v.numpy(), k, tol=(1e-4, 1e-5))
    want = from_flax_variables({'params/' + '/'.join(k): np.asarray(v) for k, v in
                                traverse_util.flatten_dict(jgrads).items()})
    assert set(params) == set(want)
    atol = 1e-7 * np.sqrt(sum(float((w.double() ** 2).sum()) for w in want.values()))
    for name, g in zip(params, grads):
        g, w = g.numpy(), want[name].numpy()
        diff = g - w
        assert np.linalg.norm(diff) <= 1e-4 * np.linalg.norm(w) + atol, \
            (name, np.linalg.norm(diff), np.linalg.norm(w))
        assert np.abs(diff).max() <= 1e-4 * np.abs(w).max() + atol, name
    pair.tmod.load_state_dict(pair.state, strict=True)


@pytest.mark.parametrize('kind', ['backbones_3d', 'vfe', 'map_to_bev', 'dense_heads'])
def test_registries_hold_every_jax_name(kind):
    """Every name of the JAX package's registry maps to the same kind of
    module in the port (aliases alike)."""
    import importlib
    from hvpr_tpu_torch.models.detectors import detector3d_template as t
    jax_reg = importlib.import_module({
        'backbones_3d': 'hvpr_tpu.models.backbones_3d',
        'vfe': 'hvpr_tpu.models.backbones_3d.vfe',
        'map_to_bev': 'hvpr_tpu.models.backbones_2d.map_to_bev',
        'dense_heads': 'hvpr_tpu.models.dense_heads'}[kind]).__all__
    port_reg = {'backbones_3d': t._BACKBONES_3D, 'vfe': t._VFES,
                'map_to_bev': t._MAP_TO_BEV, 'dense_heads': t._DENSE_HEADS}[kind]
    assert set(jax_reg) <= set(port_reg)
    for name, cls in jax_reg.items():
        assert port_reg[name].__name__ == cls.__name__ or \
            (name, port_reg[name].__name__) == ('VoxelBackBone8xDense', 'VoxelBackBone8x'), name


@pytest.mark.parametrize('name', ['VoxelBackBone8x', 'VoxelBackBone8xDense',
                                  'VoxelResBackBone8x', 'VoxelBackBone8x_voxelrcnn', 'UNetV2',
                                  'PointNet2Backbone'])
def test_voxel_backbones_build_in_the_template(name):
    """A detector with each 3D backbone builds: the VFE's output channels
    feed it, NUM_BEV_FEATURES the BEV backbone; the stack variant of
    PointNet++ raises, as the JAX package's does."""
    cfg = second_cfg()
    cfg['BACKBONE_3D'] = {'NAME': name}
    kw = dict(model_cfg=cfg, num_class=1, class_names=['Car'], grid_size=GRID,
              point_cloud_range=PCR, voxel_size=VOXEL, num_point_features=4)
    if name == 'PointNet2Backbone':
        with pytest.raises(NotImplementedError, match='disabled upstream'):
            SECONDNet(**kw)
        return
    net = SECONDNet(**kw)
    first = next(p for n, p in net.backbone_3d.named_parameters())
    assert 4 in first.shape
    assert net.backbone_2d.blocks[0][1].in_channels == 64
