"""The port's AnchorHeadMulti, ATSS target assigner and PointNet2MSG_NOFP
against the JAX package on the CPU.

- AnchorHeadMulti: ``tests/test_multiclass.py``'s three classes (Car |
  Pedestrian, Cyclist) with SHARED_CONV_NUM_FILTER and a head conv trunk on
  the second head, on a seeded (2, 8, 16, 24) BEV map: the eval logits and
  decoded boxes, and in training the loss terms, the shared conv's running
  statistics and every gradient leaf against ``jax.grad``.
- ATSS: the three cases of ``tests/test_atss.py`` and a seeded scene of
  rotated gts over two anchor sets with padded gt rows; also through
  AnchorHeadSingle (TARGET_ASSIGNER_CONFIG.NAME ``ATSS``), whose loss must
  equal the JAX head's.
- PointNet2MSG_NOFP: the SA stack without FP at a narrow SA_CONFIG with
  hvpr.yaml's FPS_CHUNKS and radii and BALL_QUERY bucket (the rule of the
  TPU kernel and of the port's 'auto'), through the plain versions of K4
  (ball query) and K5 (FPS), which run because the tensors lie on the CPU
  (no kernel launch is counted).

Tolerances: labels, assignments, masks, the -1e9 logits of the classes a
head does not own and the NOFP sampled coordinates exactly equal; f32
values (logits, boxes, targets, features) within 1e-5 of their largest
magnitude plus rtol 1e-4; loss terms rtol 1e-4; gradient leaves within
1e-4 of the leaf (L2 and max) plus 1e-7 of the global norm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from test_torch_port_second import close, perturbed, unflatten
from torch_port_helpers import load_cfg, torch_threads

from hvpr_tpu.config import ConfigDict
from hvpr_tpu.models.backbones_3d.pointnet2_backbone import PointNet2MSG_NOFP as JaxNOFP
from hvpr_tpu.models.dense_heads.anchor_head_multi import AnchorHeadMulti as JaxMulti
from hvpr_tpu.models.dense_heads.anchor_head_single import AnchorHeadSingle as JaxSingle
from hvpr_tpu.models.dense_heads.target_assigner.atss_target_assigner import (
    ATSSTargetAssigner as JaxATSS)
from hvpr_tpu.utils.box_coder_utils import ResidualCoder as JaxCoder

from hvpr_tpu_torch.models.backbones_3d.pointnet2_backbone import PointNet2MSG_NOFP
from hvpr_tpu_torch.models.dense_heads.anchor_head_multi import AnchorHeadMulti
from hvpr_tpu_torch.models.dense_heads.anchor_head_single import AnchorHeadSingle
from hvpr_tpu_torch.models.dense_heads.target_assigner.atss_target_assigner import (
    ATSSTargetAssigner)
from hvpr_tpu_torch.ops import _kernels
from hvpr_tpu_torch.utils.box_coder_utils import ResidualCoder
from hvpr_tpu_torch.utils.weights import from_flax_variables

CLASSES = ['Car', 'Pedestrian', 'Cyclist']
GRID = (32, 16, 1)                                  # nx, ny, nz
PCR = (0.0, -2.56, -2.5, 5.12, 2.56, 0.5)
C_IN = 24


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    with torch_threads(1):
        yield


def head_cfg(name='AnchorHeadMulti', assigner='AxisAlignedTargetAssigner'):
    def anchor(cls, size, z, matched, unmatched):
        return {'class_name': cls, 'anchor_sizes': [size], 'anchor_rotations': [0, 1.57],
                'anchor_bottom_heights': [z], 'align_center': False,
                'feature_map_stride': 2, 'matched_threshold': matched,
                'unmatched_threshold': unmatched}
    cfg = {
        'NAME': name, 'CLASS_AGNOSTIC': False, 'USE_DIRECTION_CLASSIFIER': True,
        'DIR_OFFSET': 0.78539, 'DIR_LIMIT_OFFSET': 0.0, 'NUM_DIR_BINS': 2,
        'ANCHOR_GENERATOR_CONFIG': [anchor('Car', [3.9, 1.6, 1.56], -1.78, 0.6, 0.45),
                                    anchor('Pedestrian', [0.8, 0.6, 1.73], -0.6, 0.5, 0.35),
                                    anchor('Cyclist', [1.76, 0.6, 1.73], -0.6, 0.5, 0.35)],
        'TARGET_ASSIGNER_CONFIG': {'NAME': assigner, 'POS_FRACTION': -1.0, 'SAMPLE_SIZE': 512,
                                   'NORM_BY_NUM_EXAMPLES': False, 'MATCH_HEIGHT': False,
                                   'BOX_CODER': 'ResidualCoder', 'TOPK': 9},
        'LOSS_CONFIG': {'LOSS_WEIGHTS': {'cls_weight': 1.0, 'loc_weight': 2.0,
                                         'dir_weight': 0.2, 'code_weights': [1.0] * 7}},
    }
    if name == 'AnchorHeadMulti':
        cfg['SHARED_CONV_NUM_FILTER'] = 32
        cfg['RPN_HEAD_CFGS'] = [{'HEAD_CLS_NAME': ['Car']},
                                {'HEAD_CLS_NAME': ['Pedestrian', 'Cyclist'],
                                 'HEAD_CONV_FILTERS': [16]}]
    return ConfigDict(cfg)


def mc_gt(b=2):
    gt = np.zeros((b, 4, 8), np.float32)
    gt[:, 0] = [2.5, 0.0, -1.0, 3.9, 1.6, 1.56, 0.3, 1]       # Car
    gt[:, 1] = [4.0, 1.0, -0.8, 0.8, 0.6, 1.73, 0.0, 2]       # Pedestrian
    gt[:, 2] = [1.5, -1.0, -0.8, 1.76, 0.6, 1.73, -0.5, 3]    # Cyclist
    return gt


class HeadPair:
    """A JAX dense head and the port's with the same weights, on a seeded
    BEV map."""

    def __init__(self, cfg, jax_cls, port_cls, seed=0):
        rng = np.random.default_rng(seed)
        self.feat = rng.normal(size=(2, GRID[1] // 2, GRID[0] // 2, C_IN)).astype(np.float32)
        self.gt = mc_gt()
        kw = dict(input_channels=C_IN, num_class=3, class_names=CLASSES, grid_size=GRID,
                  point_cloud_range=PCR)
        self.jmod = jax_cls(model_cfg=cfg, **kw)
        variables = self.jmod.init(jax.random.PRNGKey(seed), self.jbatch(), train=False)
        self.flat = perturbed(variables, rng)
        self.variables = unflatten(self.flat)
        self.state = {k[len('dense_head.'):]: v for k, v in from_flax_variables(
            {'/'.join(k.split('/')[:1] + ['dense_head'] + k.split('/')[1:]): v
             for k, v in self.flat.items()}).items()}
        self.tmod = port_cls(cfg, **kw)
        self.tmod.load_state_dict(self.state, strict=True)

    def jbatch(self, train=False):
        out = {'spatial_features_2d': jnp.asarray(self.feat)}
        if train:
            out['gt_boxes'] = jnp.asarray(self.gt)
        return out

    def tbatch(self, train=False):
        out = {'spatial_features_2d': torch.from_numpy(self.feat.copy())}
        if train:
            out['gt_boxes'] = torch.from_numpy(self.gt)
        return out

    def train_both(self):
        """JAX loss, tb terms, stats update and gradients; the port's."""
        def loss_fn(params):
            out, upd = self.jmod.apply({**self.variables, 'params': params},
                                       self.jbatch(train=True), train=True,
                                       mutable=['batch_stats'])
            return out['loss'], (out['tb_dict'], upd)
        (jloss, (jtb, jupd)), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
            self.variables['params'])
        self.tmod.load_state_dict(self.state, strict=True)
        self.tmod.train()
        out = self.tmod(self.tbatch(train=True))
        params = dict(self.tmod.named_parameters())
        grads = dict(zip(params, torch.autograd.grad(out['loss'], list(params.values()))))
        return (jloss, jtb, jupd, jgrads), (out, grads)


def check_grads(jgrads, grads):
    want = {k[len('dense_head.'):]: v for k, v in from_flax_variables(
        {'params/dense_head/' + '/'.join(k): np.asarray(v)
         for k, v in traverse_util.flatten_dict(jgrads).items()}).items()}
    assert set(grads) == set(want)
    atol = 1e-7 * np.sqrt(sum(float((w.double() ** 2).sum()) for w in want.values()))
    for name, g in grads.items():
        g, w = g.numpy(), want[name].numpy()
        diff = g - w
        assert np.linalg.norm(diff) <= 1e-4 * np.linalg.norm(w) + atol, name
        assert np.abs(diff).max() <= 1e-4 * np.abs(w).max() + atol, name


@pytest.fixture(scope='module')
def multi():
    return HeadPair(head_cfg(), JaxMulti, AnchorHeadMulti)


def test_anchor_head_multi_eval_matches_jax(multi):
    want = multi.jmod.apply(multi.variables, multi.jbatch(), train=False)
    multi.tmod.eval()
    with torch.no_grad():
        got = multi.tmod(multi.tbatch())
    wc, gc = np.asarray(want['batch_cls_preds']), got['batch_cls_preds'].numpy()
    assert gc.shape == wc.shape == (2, 8 * 16 * 6, 3)
    own = wc > -1e8                       # each anchor's own class column
    np.testing.assert_array_equal(gc > -1e8, own)
    assert (own.sum(-1) == 1).all()
    np.testing.assert_array_equal(gc[~own], wc[~own])
    close(gc[own], wc[own], 'own logits')
    close(got['batch_box_preds'], want['batch_box_preds'], 'decoded boxes')
    assert got['cls_preds_normalized'] is False


def test_anchor_head_multi_loss_and_gradients_match_jax(multi):
    (jloss, jtb, jupd, jgrads), (out, grads) = multi.train_both()
    np.testing.assert_allclose(float(out['loss'].detach()), float(jloss), rtol=1e-4)
    for k in ('rpn_loss_cls', 'rpn_loss_loc', 'rpn_loss_dir', 'rpn_loss'):
        np.testing.assert_allclose(float(out['tb_dict'][k].detach()), float(jtb[k]),
                                   rtol=1e-4, err_msg=k)
    assert float(jtb['rpn_loss_loc']) > 0
    stats = from_flax_variables({'batch_stats/dense_head/' + '/'.join(k): np.asarray(v)
                                 for k, v in traverse_util.flatten_dict(
                                     jupd['batch_stats']).items()})
    port = multi.tmod.state_dict()
    for k, v in stats.items():
        if 'running' in k:
            close(port[k[len('dense_head.'):]], v.numpy(), k)
    check_grads(jgrads, grads)
    multi.tmod.load_state_dict(multi.state, strict=True)


def test_anchor_head_multi_keys_and_class_order():
    with pytest.raises(ValueError, match='must equal CLASS_NAMES'):
        cfg = head_cfg()
        cfg['RPN_HEAD_CFGS'] = [{'HEAD_CLS_NAME': ['Pedestrian', 'Cyclist']},
                                {'HEAD_CLS_NAME': ['Car']}]
        AnchorHeadMulti(cfg, C_IN, 3, CLASSES, GRID, PCR)
    keys = AnchorHeadMulti(head_cfg(), C_IN, 3, CLASSES, GRID, PCR).state_dict()
    assert 'shared_conv.0.weight' in keys and 'rpn_heads.1.head_convs.0.1.running_var' in keys
    assert 'rpn_heads.1.convs.5.weight' in keys and 'rpn_heads.1.convs.6.weight' not in keys


# ---------------------------------------------------------------- ATSS


def _anchor_grid(x0, n=6, spacing=2.0):
    """(1, n, n, 1, 1, 7) axis-aligned car anchors on a grid starting at x0."""
    anchors = np.zeros((1, n, n, 1, 1, 7), np.float32)
    anchors[0, :, :, 0, 0, 0] = (x0 + np.arange(n) * spacing)[None, :]
    anchors[0, :, :, 0, 0, 1] = (np.arange(n) * spacing)[:, None]
    anchors[..., 3:6] = [3.9, 1.6, 1.56]
    return anchors


def _gt(x, y, cls_id=1):
    return np.array([[[x, y, 0.0, 3.9, 1.6, 1.56, 0.0, cls_id]]], np.float32)


def _random_scene(rng):
    sets = []
    for size, rots in (([3.9, 1.6, 1.56], [0.0, 1.57]), ([0.8, 0.6, 1.73], [0.0, 1.57])):
        a = np.zeros((1, 5, 7, 1, 2, 7), np.float32)
        a[..., 0] = np.arange(7)[None, None, :, None, None] * 1.5
        a[..., 1] = np.arange(5)[None, :, None, None, None] * 1.5 - 3.0
        a[..., 2] = -1.0
        a[..., 3:6] = size
        a[..., 6] = np.asarray(rots)
        sets.append(a)
    gt = np.zeros((2, 5, 8), np.float32)
    for i, n in enumerate((4, 2)):
        gt[i, :n, 0] = rng.uniform(0, 9, n)
        gt[i, :n, 1] = rng.uniform(-3, 3, n)
        gt[i, :n, 2] = -1.0
        gt[i, :n, 3:6] = rng.uniform(0.6, 4.0, (n, 3))
        gt[i, :n, 6] = rng.uniform(-np.pi, np.pi, n)
        gt[i, :n, 7] = rng.integers(1, 3, n)
    return sets, gt


ATSS_CASES = {
    'on_grid_anchor': lambda rng: ([_anchor_grid(0.0)], _gt(4.0, 4.0)),
    'all_padded': lambda rng: ([_anchor_grid(0.0)], np.zeros((1, 3, 8), np.float32)),
    'per_set_independent': lambda rng: ([_anchor_grid(0.0), _anchor_grid(500.0)],
                                        _gt(4.0, 4.0)),
    'rotated_two_sets': _random_scene,
}


@pytest.mark.parametrize('case', list(ATSS_CASES))
def test_atss_matches_jax(case):
    sets, gt = ATSS_CASES[case](np.random.default_rng(5))
    want = JaxATSS(topk=9, box_coder=JaxCoder()).assign_targets(
        [a for a in sets], jnp.asarray(gt))
    got = ATSSTargetAssigner(9, ResidualCoder()).assign_targets(
        [torch.from_numpy(a) for a in sets], torch.from_numpy(gt))
    np.testing.assert_array_equal(got['box_cls_labels'].numpy(),
                                  np.asarray(want['box_cls_labels']))
    np.testing.assert_array_equal(got['reg_weights'].numpy(), np.asarray(want['reg_weights']))
    close(got['box_reg_targets'], want['box_reg_targets'], 'targets')
    labels = got['box_cls_labels'].numpy()
    if case == 'on_grid_anchor':
        assert labels[0].reshape(6, 6)[2, 2] == 1
        fg = labels[0] > 0
        centers = sets[0].reshape(-1, 7)[fg]
        assert (np.abs(centers[:, 0] - 4.0) <= 3.9 / 2 + 1e-5).all()
        assert (np.abs(centers[:, 1] - 4.0) <= 1.6 / 2 + 1e-5).all()
    elif case == 'all_padded':
        assert (labels == 0).all()
    elif case == 'per_set_independent':
        solo = ATSSTargetAssigner(9, ResidualCoder()).assign_targets(
            [torch.from_numpy(sets[0])], torch.from_numpy(gt))['box_cls_labels'][0]
        both = labels[0].reshape(36, 2)
        np.testing.assert_array_equal(both[:, 0], solo.numpy())
        assert (both[:, 1] == 0).all()
    else:
        assert (labels > 0).sum() >= 6


def test_anchor_head_single_with_atss_matches_jax():
    """TARGET_ASSIGNER_CONFIG.NAME ATSS through AnchorHeadSingle's loss."""
    cfg = head_cfg('AnchorHeadSingle', 'ATSS')
    pair = HeadPair(cfg, JaxSingle, AnchorHeadSingle, seed=1)
    assert isinstance(pair.tmod.target_assigner, ATSSTargetAssigner)
    (jloss, jtb, _, jgrads), (out, grads) = pair.train_both()
    np.testing.assert_allclose(float(out['loss'].detach()), float(jloss), rtol=1e-4)
    for k in ('rpn_loss_cls', 'rpn_loss_loc', 'rpn_loss_dir'):
        np.testing.assert_allclose(float(out['tb_dict'][k].detach()), float(jtb[k]),
                                   rtol=1e-4, err_msg=k)
    assert float(jtb['rpn_loss_loc']) > 0
    check_grads(jgrads, grads)


# ---------------------------------------------------------------- NOFP


def nofp_cfg():
    sa = load_cfg('hvpr.yaml').MODEL.BACKBONE_3D.SA_CONFIG
    cfg = ConfigDict({'NAME': 'PointNet2MSG_NOFP', 'SA_CONFIG': dict(sa)})
    cfg.SA_CONFIG['NPOINTS'] = [128, 32]
    cfg.SA_CONFIG['MLPS'] = [[[8, 8, 16], [8, 8, 16]], [[16, 16, 32], [16, 16, 32]]]
    # the TPU's rule, which the port's 'auto' takes (the JAX package's
    # 'auto' on the CPU takes first-by-index)
    cfg.SA_CONFIG['BALL_QUERY'] = 'bucket'
    return cfg


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
def test_pointnet2_msg_nofp_matches_jax(train):
    rng = np.random.default_rng(6)
    b, n = 2, 1024
    pts = np.zeros((b, n, 4), np.float32)
    pts[..., :3] = rng.uniform([0, -8, -2], [16, 8, 1], (b, n, 3))
    pts[..., 3] = rng.uniform(0, 1, (b, n))
    mask = np.ones((b, n), bool)
    mask[1, -100:] = False
    cfg = nofp_cfg()
    jmod = JaxNOFP(model_cfg=cfg, input_channels=4)
    # the module writes the last level's mask into the dict it is given
    jb = {'points': jnp.asarray(pts), 'point_valid_mask': jnp.asarray(mask)}
    flat = perturbed(jmod.init(jax.random.PRNGKey(0), dict(jb), train=False), rng)
    state = {k[len('backbone_3d.'):]: v for k, v in from_flax_variables(
        {'/'.join(k.split('/')[:1] + ['backbone_3d'] + k.split('/')[1:]): v
         for k, v in flat.items()}).items()}
    mod = PointNet2MSG_NOFP(cfg, 4)
    mod.load_state_dict(state, strict=True)
    assert mod.num_point_features == jmod.num_point_features == 64
    if train:
        want, _ = jmod.apply(unflatten(flat), dict(jb), train=True, mutable=['batch_stats'])
    else:
        want = jmod.apply(unflatten(flat), dict(jb), train=False)
    before = _kernels.launch_counts()
    got = mod.train(train)({'points': torch.from_numpy(pts),
                            'point_valid_mask': torch.from_numpy(mask)})
    assert _kernels.launch_counts() == before               # plain versions on the CPU
    np.testing.assert_array_equal(got['point_valid_mask'].numpy(),
                                  np.asarray(want['point_valid_mask']))
    np.testing.assert_array_equal(got['point_coords'].numpy(), np.asarray(want['point_coords']))
    assert got['point_features'].shape == (b, 32, 64)
    close(got['point_features'].detach(), want['point_features'], 'point_features')
