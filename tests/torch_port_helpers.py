"""Shared builders for the port's parity tests (JAX package vs hvpr_tpu_torch).

Both networks are built from one config, the flax variables are initialized
from a seed, BatchNorm running statistics are overwritten with seeded random
values (fresh init leaves them at 0/1, which would not test BN), and the same
numbers are carried into the port with ``from_flax_variables``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import traverse_util

from hvpr_tpu.config import ConfigDict as JaxConfigDict
from hvpr_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml
from hvpr_tpu.models import build_network as jax_build_network
from hvpr_tpu.ops.voxelizer import voxelize_batch_flat as jax_voxelize

from hvpr_tpu_torch.models import DatasetMeta
from hvpr_tpu_torch.models import build_network as port_build_network
from hvpr_tpu_torch.utils.weights import from_flax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_cfg(name):
    """A kitti_models config as a plain nested dict (both packages read it)."""
    cwd = os.getcwd()
    os.chdir(REPO)           # _BASE_CONFIG_ paths are relative to the repo
    try:
        cfg = JaxConfigDict()
        jax_cfg_from_yaml(os.path.join('tools/cfgs/kitti_models', name), cfg)
    finally:
        os.chdir(cwd)
    return cfg


def cropped_flagship_cfg(compute='fp32'):
    """hvpr.yaml's MODEL at full channel widths (128/256/512, M=2000, k=20)
    on a 5.12 x 5.12 m range (a 32 x 32 pillar grid) so it runs in seconds
    on the CPU. ``compute='fp32'`` sets COMPUTE_DTYPE/CANVAS_DTYPE to fp32."""
    cfg = load_cfg('hvpr.yaml')
    cfg.DATA_CONFIG.POINT_CLOUD_RANGE = [0, -2.56, -2.5, 5.12, 2.56, 0.5]
    for p in cfg.DATA_CONFIG.DATA_PROCESSOR:
        if p['NAME'] == 'transform_points_to_voxels':
            p['MAX_NUMBER_OF_VOXELS'] = {'train': 768, 'test': 768}
    if compute == 'fp32':
        cfg.MODEL.MAP_TO_BEV.CANVAS_DTYPE = 'fp32'
        cfg.MODEL.BACKBONE_2D.COMPUTE_DTYPE = 'fp32'
        cfg.MODEL.DENSE_HEAD.COMPUTE_DTYPE = 'fp32'
    return cfg


def mini_cfg():
    return load_cfg('hvpr_mini.yaml')


def scan_points(rng, b, n, pcr):
    """(B, N, 4) points over the range, 10% outside it (dropped)."""
    pts = np.zeros((b, n, 4), np.float32)
    span = np.asarray(pcr[3:6]) - np.asarray(pcr[0:3])
    lo = np.asarray(pcr[0:3]) - 0.05 * span
    pts[..., :3] = lo + rng.uniform(0, 1.1, (b, n, 3)) * span
    # clusters: a third of the points land in a few pillars, so segments
    # reach the per-pillar cap
    k = n // 3
    centers = np.asarray(pcr[0:3]) + rng.uniform(0.2, 0.8, (b, 4, 3)) * span
    pick = rng.integers(0, 4, (b, k))
    pts[:, :k, :3] = (np.take_along_axis(centers, pick[..., None], 1)
                      + rng.normal(0, 0.05, (b, k, 3)))
    pts[..., 3] = rng.uniform(0, 1, (b, n))
    return pts


class Pair:
    """The JAX network and the port's network with the same weights."""

    def __init__(self, cfg, batch=1, n_points=2048, seed=0, cls_bias=0.0):
        self.cfg = cfg
        self.meta = DatasetMeta(cfg.DATA_CONFIG, cfg.CLASS_NAMES)
        self.jnet = jax_build_network(cfg.MODEL, len(cfg.CLASS_NAMES), self.meta)
        rng = np.random.default_rng(seed)
        self.points = scan_points(rng, batch, n_points, self.meta.point_cloud_range)
        self.mask = np.ones((batch, n_points), bool)
        self.mask[:, -7:] = False
        jbatch = self.jax_batch()
        self.jnet.init(jax.random.PRNGKey(seed), jbatch, train=False)

        flat = {'/'.join(k): np.asarray(v) for k, v in
                traverse_util.flatten_dict(self.jnet.variables).items()}
        for key in flat:
            if key.startswith('batch_stats/') and key.endswith('/mean'):
                flat[key] = rng.normal(0, 0.1, flat[key].shape).astype(np.float32)
            elif key.startswith('batch_stats/') and key.endswith('/var'):
                flat[key] = rng.uniform(0.5, 2.0, flat[key].shape).astype(np.float32)
            elif key.endswith('/scale') or (key.endswith('/bias') and 'BatchNorm' in key):
                flat[key] = (flat[key] + rng.normal(0, 0.1, flat[key].shape)
                             ).astype(np.float32)
        if cls_bias is not None:
            # fresh init puts sigmoid(cls) at 0.01, below SCORE_THRESH: with
            # bias 0 hundreds of candidates reach NMS
            flat['params/dense_head/conv_cls/bias'] = np.full_like(
                flat['params/dense_head/conv_cls/bias'], cls_bias)
        self.flat = flat
        self.jnet.variables = traverse_util.unflatten_dict(
            {tuple(k.split('/')): jnp.asarray(v) for k, v in flat.items()})

        self.tnet = port_build_network(cfg.MODEL, len(cfg.CLASS_NAMES),
                                       self.meta, device='cpu')
        self.tnet.load_state_dict(from_flax_variables(flat))

    def vox_args(self):
        m = self.meta
        return dict(point_cloud_range=tuple(float(v) for v in m.point_cloud_range),
                    voxel_size=tuple(float(v) for v in m.voxel_size),
                    max_voxels=m.max_voxels,
                    max_points_per_voxel=m.max_points_per_voxel,
                    grid_size_static=tuple(int(g) for g in m.grid_size))

    def jax_batch(self):
        a = self.vox_args()
        pts, mask = jnp.asarray(self.points), jnp.asarray(self.mask)
        vox = jax_voxelize(pts, mask, a['point_cloud_range'], a['voxel_size'],
                           max_voxels=a['max_voxels'],
                           max_points_per_voxel=a['max_points_per_voxel'],
                           grid_size_static=a['grid_size_static'])
        return {'points': pts, 'point_valid_mask': mask, **vox}

    def torch_batch(self, jbatch):
        """The JAX batch's arrays as CPU tensors (exact same inputs)."""
        return {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.is_floating_point() else x.numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def to_torch(x):
    """A JAX array as a CPU tensor of the same dtype (bf16 kept)."""
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    return torch.from_numpy(np.array(x))


def check_stage(pair, jout, stage, tol):
    """Feed one port stage the JAX stage's inputs and compare its outputs.

    ``tol`` (rtol, atol_frac): atol is atol_frac times the largest |value|.
    """
    keys_in, keys_out, module = {
        'vfe': (('flat_points', 'flat_slot', 'flat_write', 'voxel_num_points'),
                ('pillar_features', 'pillar_scale_features'), pair.tnet.module.vfe),
        'map_to_bev': (('pillar_features', 'pillar_scale_features',
                        'voxel_coords', 'voxel_mask'),
                       ('spatial_features', 'spatial_scale_features'),
                       pair.tnet.module.map_to_bev_module),
        'backbone_2d': (('spatial_features', 'spatial_scale_features'),
                        ('spatial_features_2d',), pair.tnet.module.backbone_2d),
        'dense_head': (('spatial_features_2d',),
                       ('batch_cls_preds', 'batch_box_preds'),
                       pair.tnet.module.dense_head),
    }[stage]
    with torch.no_grad():
        out = module({k: to_torch(jout[k]) for k in keys_in})
    rtol, atol_frac = tol
    for k in keys_out:
        want, got = to_np(jout[k]), to_np(out[k])
        assert got.shape == want.shape, (k, got.shape, want.shape)
        assert out[k].dtype == to_torch(jout[k][:1]).dtype, k
        np.testing.assert_allclose(got, want, rtol=rtol,
                                   atol=atol_frac * np.abs(want).max(),
                                   err_msg=f'{stage}: {k}')


def check_pipeline(pair, box_tol, gt_boxes=None):
    """``Network.pipeline`` on the raw points vs the JAX voxelize -> eval
    forward -> post_processing chain: kept sets and labels exactly, boxes
    and scores to ``box_tol`` (rtol = atol)."""
    from hvpr_tpu.models.detectors.detector3d_template import (
        post_processing as jax_post)
    jb = pair.jax_batch()
    post_cfg = pair.cfg.MODEL.POST_PROCESSING
    jout = pair.jnet.module.apply(pair.jnet.variables, jb, train=False)
    n_live = int((jax.nn.sigmoid(jout['batch_cls_preds'])
                  >= post_cfg.SCORE_THRESH).sum())
    if gt_boxes is not None:
        jout = dict(jout, gt_boxes=jnp.asarray(gt_boxes))
    want = jax_post(jout, post_cfg, len(pair.cfg.CLASS_NAMES))

    got = pair.tnet.pipeline(torch.from_numpy(pair.points),
                             torch.from_numpy(pair.mask))
    if gt_boxes is not None:
        with torch.no_grad():
            tout = pair.tnet.module(pair.torch_batch(jb))
            tout['gt_boxes'] = torch.from_numpy(gt_boxes)
            from hvpr_tpu_torch.models.detectors.detector3d_template import (
                post_processing)
            got = post_processing(tout, post_cfg, len(pair.cfg.CLASS_NAMES))
    mask = np.asarray(want['pred_mask'])
    np.testing.assert_array_equal(got['pred_mask'].numpy(), mask)
    np.testing.assert_array_equal(got['pred_labels'].numpy()[mask],
                                  np.asarray(want['pred_labels'])[mask])
    np.testing.assert_array_equal(got['num_capped'].numpy(),
                                  np.asarray(want['num_capped']))
    for k in ('pred_boxes', 'pred_scores'):
        np.testing.assert_allclose(got[k].numpy()[mask], np.asarray(want[k])[mask],
                                   rtol=box_tol, atol=box_tol, err_msg=k)
    if gt_boxes is not None:
        for k, v in want['recall'].items():
            assert int(got['recall'][k]) == int(v), k
    return n_live, int(mask.sum())
