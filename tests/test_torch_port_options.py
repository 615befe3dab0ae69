"""Options of the ported modules against the JAX package on the CPU.

- Box coders: ``ResidualCoder`` with and without ``encode_angle_by_sincos``,
  ``PreviousResidualDecoder``, ``PointResidualCoder`` with and without
  ``use_mean_size`` on seeded boxes: encode and decode within f32 rounding
  (rtol 1e-6, atol 1e-6 of the largest magnitude; 2e-6 for the decoded
  heading, an atan2 of sums).
- AnchorHeadSingle and AnchorHeadMulti with the sincos coder (code size 8,
  anchors zero-padded to 8 columns): eval logits and decoded boxes, the
  targets, the loss terms and every gradient leaf, at the tolerances of
  ``tests/test_torch_port_multihead.py``. The JAX assigner flattens the
  anchors to 7 columns (``reshape(-1, 7)``), which raises on the 8-column
  grids of the JAX sincos head in training; here the JAX assigner is given
  their first 7 columns, which is what the port's assigner reads (the
  encoding of a 7-column gt box reads no anchor column past 7).
- The axis-aligned assigner with ``MATCH_HEIGHT`` (rotated 3D IoU) and
  ``NORM_BY_NUM_EXAMPLES`` on a seeded scene of two classes with padded gt
  rows: labels exactly, targets and weights within 1e-6 (f32).
- ``subsample`` fed the uniforms that ``jax.random`` drew for the JAX
  ``_subsample``: labels exactly. With the port's own generator: the
  budget invariants, ``POS_FRACTION: 0.0``, the keep-all fallbacks and the
  resampling by global step of ``tests/test_pos_fraction.py``.
- ``DUAL_PASS: sequential`` against the JAX sequential pass: outputs and
  running statistics within 2e-5; the port's sequential pass against its
  stacked pass at the tolerances of ``tests/test_dual_pass.py``.
- ``TOPK_MODE: approx``: the memory scatter's eval forward against the JAX
  module's ``approx`` (rtol 1e-2, atol 1e-3 of the largest value: bf16
  rounding of the reconstruction); the port's approx equals
  its exact mode bit for bit; the mode is checked at construction.
- ``fill_infos`` over a mock devkit database against the JAX function:
  paths, tokens, names and counts exactly, matrices and boxes within 1e-6.
- ``misc``, ``profiler``, ``WeightedL1Loss``, ``get_corner_loss_lidar`` and
  ``get_voxel_centers`` against the JAX package (f32: rtol 1e-6, atol 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_multihead import (C_IN, CLASSES, GRID, PCR, HeadPair, check_grads,
                                       head_cfg)
from test_torch_port_second import close, perturbed, unflatten
from torch_port_helpers import torch_threads

from hvpr_tpu.models.backbones_2d.base_bev_backbone import (
    BaseBEVBackboneScale as JaxScaleBackbone)
from hvpr_tpu.models.dense_heads.anchor_head_multi import AnchorHeadMulti as JaxMulti
from hvpr_tpu.models.dense_heads.anchor_head_single import AnchorHeadSingle as JaxSingle
from hvpr_tpu.models.dense_heads.target_assigner import (
    axis_aligned_target_assigner as jax_axis_aligned)
from hvpr_tpu.utils import box_coder_utils as jax_coders

from hvpr_tpu_torch.models.backbones_2d.base_bev_backbone import BaseBEVBackboneScale
from hvpr_tpu_torch.models.backbones_2d.map_to_bev.pointpillar_scatter import (
    PointPillarScatterAggMemory1Scale)
from hvpr_tpu_torch.models.dense_heads.anchor_head_multi import AnchorHeadMulti
from hvpr_tpu_torch.models.dense_heads.anchor_head_single import AnchorHeadSingle
from hvpr_tpu_torch.models.dense_heads.target_assigner.axis_aligned_target_assigner import (
    AxisAlignedTargetAssigner)
from hvpr_tpu_torch.utils import box_coder_utils
from hvpr_tpu_torch.utils.weights import from_flax_variables


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    with torch_threads(1):
        yield


def t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------- coders


def random_boxes(rng, n, extra=0):
    b = np.zeros((n, 7 + extra), np.float32)
    b[:, :3] = rng.uniform(-20, 20, (n, 3))
    b[:, 3:6] = rng.uniform(0.4, 5.0, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    b[:, 7:] = rng.normal(size=(n, extra))
    return b


CODERS = {
    'residual': ({}, 'ResidualCoder'),
    'residual_sincos': ({'encode_angle_by_sincos': True}, 'ResidualCoder'),
    'residual_extra_columns': ({}, 'ResidualCoder'),
    'previous_residual': ({}, 'PreviousResidualDecoder'),
    'point_mean_size': ({'mean_size': [[3.9, 1.6, 1.56], [0.8, 0.6, 1.73]]},
                        'PointResidualCoder'),
    'point_no_mean_size': ({'use_mean_size': False}, 'PointResidualCoder'),
}


@pytest.mark.parametrize('case', list(CODERS))
def test_box_coder_matches_jax(case):
    kwargs, name = CODERS[case]
    rng = np.random.default_rng(3)
    extra = 2 if case == 'residual_extra_columns' else 0
    boxes, anchors = random_boxes(rng, 64, extra), random_boxes(rng, 64, extra)
    classes = rng.integers(1, 3, 64)
    jc = getattr(jax_coders, name)(**kwargs)
    pc = box_coder_utils.build_box_coder(
        {'BOX_CODER': name, 'NUM_DIR_BINS': 2, 'BOX_CODER_CONFIG': kwargs})
    assert type(pc).__name__ == name and pc.code_size == jc.code_size
    cls_kw = ({'gt_classes': classes}, {'gt_classes': t(classes)}) \
        if name == 'PointResidualCoder' else ({}, {})
    if name != 'PreviousResidualDecoder':
        want = jc.encode(jnp.asarray(boxes), jnp.asarray(anchors), **cls_kw[0])
        got = pc.encode(t(boxes), t(anchors), **cls_kw[1])
        close(got, want, 'encode', (1e-6, 1e-6))
        enc = np.asarray(want)
    else:
        enc = rng.normal(0, 0.3, (64, 7 + extra)).astype(np.float32)
    dec_kw = ({'pred_classes': classes}, {'pred_classes': t(classes)}) \
        if name == 'PointResidualCoder' else ({}, {})
    want = np.asarray(jc.decode(jnp.asarray(enc), jnp.asarray(anchors), **dec_kw[0]))
    got = pc.decode(t(enc), t(anchors), **dec_kw[1]).numpy()
    assert got.shape == want.shape
    close(np.delete(got, 6, -1), np.delete(want, 6, -1), 'decode', (1e-6, 1e-6))
    close(got[:, 6], want[:, 6], 'decoded heading', (2e-6, 2e-6))
    if name == 'ResidualCoder':            # and back: the round trip
        close(got[:, :7], boxes[:, :7], 'round trip', (1e-4, 1e-5))


# ---------------------------------------------------------------- sincos heads


def sincos_cfg(name):
    cfg = head_cfg(name)
    cfg.TARGET_ASSIGNER_CONFIG['BOX_CODER_CONFIG'] = {'encode_angle_by_sincos': True}
    cfg.LOSS_CONFIG.LOSS_WEIGHTS['code_weights'] = [1.0] * 8
    return cfg


@pytest.fixture
def jax_assigner_reads_7_columns(monkeypatch):
    original = jax_axis_aligned.AxisAlignedTargetAssigner.assign_targets

    def assign(self, all_anchors, gt, global_step=None):
        return original(self, [np.asarray(a)[..., :7] for a in all_anchors], gt,
                        global_step=global_step)
    monkeypatch.setattr(jax_axis_aligned.AxisAlignedTargetAssigner, 'assign_targets', assign)


HEADS = {'single': ('AnchorHeadSingle', JaxSingle, AnchorHeadSingle),
         'multi': ('AnchorHeadMulti', JaxMulti, AnchorHeadMulti)}


@pytest.fixture(scope='module', params=list(HEADS))
def sincos_head(request):
    name, jax_cls, port_cls = HEADS[request.param]
    return HeadPair(sincos_cfg(name), jax_cls, port_cls, seed=1)


def test_sincos_head_is_code_size_8(sincos_head):
    head = sincos_head.tmod
    assert head.box_coder.code_size == 8 and head.box_coder.encode_angle_by_sincos
    assert head.anchors.shape == (8 * 16 * 6, 8)
    assert all(getattr(head, f'class_anchors_{i}').shape[-1] == 8 for i in range(3))
    assert float(head.anchors[:, 7].abs().max()) == 0.0
    # the flax kernels map across at the wider box width
    boxes = [k for k in sincos_head.state if k.endswith('.weight')
             and ('conv_box' in k or (k.startswith('rpn_heads') and
                                      tuple(sincos_head.state[k].shape[1:]) != (3, 3)))]
    assert boxes
    widths = [sincos_head.state[k].shape[0] for k in boxes]
    if isinstance(head, AnchorHeadSingle):
        assert sincos_head.state['conv_box.weight'].shape[0] == 6 * 8
    else:
        assert any(w % 8 == 0 and w > 8 for w in widths)


def test_sincos_head_eval_matches_jax(sincos_head):
    want = sincos_head.jmod.apply(sincos_head.variables, sincos_head.jbatch(), train=False)
    sincos_head.tmod.eval()
    with torch.no_grad():
        got = sincos_head.tmod(sincos_head.tbatch())
    wc, gc = np.asarray(want['batch_cls_preds']), got['batch_cls_preds'].numpy()
    live = wc > -1e8
    np.testing.assert_array_equal(gc > -1e8, live)
    close(gc[live], wc[live], 'logits')
    assert got['batch_box_preds'].shape[-1] == 7
    close(got['batch_box_preds'], want['batch_box_preds'], 'decoded boxes')


def test_sincos_head_targets_losses_and_gradients_match_jax(
        sincos_head, jax_assigner_reads_7_columns):
    pair = sincos_head

    def loss_fn(params):
        out, _ = pair.jmod.apply({**pair.variables, 'params': params},
                                 pair.jbatch(train=True), train=True, mutable=['batch_stats'])
        return out['loss'], out['tb_dict']
    (jloss, jtb), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        pair.variables['params'])
    pair.tmod.load_state_dict(pair.state, strict=True)
    pair.tmod.train()
    out = pair.tmod(pair.tbatch(train=True))
    params = dict(pair.tmod.named_parameters())
    grads = dict(zip(params, torch.autograd.grad(out['loss'], list(params.values()))))
    np.testing.assert_allclose(float(out['loss'].detach()), float(jloss), rtol=1e-4)
    for k in ('rpn_loss_cls', 'rpn_loss_loc', 'rpn_loss_dir', 'rpn_loss'):
        np.testing.assert_allclose(float(out['tb_dict'][k].detach()), float(jtb[k]),
                                   rtol=1e-4, err_msg=k)
    assert float(jtb['rpn_loss_loc']) > 0
    check_grads(jgrads, grads)
    # the targets: 8 columns, the JAX assigner's on the first 7 anchor columns
    head = pair.tmod
    got = head.target_assigner.assign_targets(
        [getattr(head, f'class_anchors_{i}') for i in range(3)], t(pair.gt))
    want = jax.jit(lambda gt: pair.jmod.apply(
        pair.variables, method=lambda m: m.target_assigner.assign_targets(m.anchors_list, gt))
    )(jnp.asarray(pair.gt))
    np.testing.assert_array_equal(got['box_cls_labels'].numpy(),
                                  np.asarray(want['box_cls_labels']))
    assert got['box_reg_targets'].shape[-1] == 8
    close(got['box_reg_targets'], want['box_reg_targets'], 'targets', (1e-6, 1e-6))
    pair.tmod.load_state_dict(pair.state, strict=True)


# ---------------------------------------------------------------- assigner


def assigner_cfg(pos_fraction=-1.0, sample_size=512, norm=False, classes=('Car',)):
    anchor_cfg = [{'class_name': c, 'matched_threshold': m, 'unmatched_threshold': u}
                  for c, m, u in (('Car', 0.6, 0.45), ('Pedestrian', 0.5, 0.35))
                  if c in classes]
    return {'ANCHOR_GENERATOR_CONFIG': anchor_cfg,
            'TARGET_ASSIGNER_CONFIG': {'POS_FRACTION': pos_fraction,
                                       'SAMPLE_SIZE': sample_size,
                                       'NORM_BY_NUM_EXAMPLES': norm}}


def height_scene(rng):
    """Two classes' (1, 6, 8, 1, 2, 7) anchor grids and 2 samples of gts
    (padded rows zero) whose heights and z vary, so that the 3D IoU
    labels other anchors than the nearest-BEV IoU."""
    sets = []
    for size, z in (([3.9, 1.6, 1.56], -1.0), ([0.8, 0.6, 1.73], -0.6)):
        a = np.zeros((1, 6, 8, 1, 2, 7), np.float32)
        a[..., 0] = np.arange(8)[None, None, :, None, None] * 1.0
        a[..., 1] = np.arange(6)[None, :, None, None, None] * 1.0 - 3.0
        a[..., 2] = z
        a[..., 3:6] = size
        a[..., 6] = np.asarray([0.0, 1.57])
        sets.append(a)
    gt = np.zeros((2, 6, 8), np.float32)
    for i, n in enumerate((5, 3)):
        gt[i, :n, 0] = rng.uniform(0, 7, n)
        gt[i, :n, 1] = rng.uniform(-3, 2, n)
        gt[i, :n, 2] = rng.uniform(-2.0, 0.5, n)
        gt[i, :n, 3:6] = [3.9, 1.6, 1.56] * rng.uniform(0.7, 1.3, (n, 3))
        gt[i, :n, 6] = rng.uniform(-0.4, 0.4, n)
        gt[i, :n, 7] = rng.integers(1, 3, n)
    return sets, gt


def test_match_height_and_norm_by_num_examples_match_jax():
    sets, gt = height_scene(np.random.default_rng(7))
    classes = ['Car', 'Pedestrian']
    cfg = assigner_cfg(norm=True, classes=classes)
    labels = {}
    for match_height in (True, False):
        # op by op: under jit XLA fuses the IoU's arithmetic, whose
        # roundings then differ from both the eager run and the port's
        want = jax_axis_aligned.AxisAlignedTargetAssigner(
            cfg, classes, jax_coders.ResidualCoder(), match_height=match_height
        ).assign_targets(sets, jnp.asarray(gt))
        got = AxisAlignedTargetAssigner(
            cfg, classes, box_coder_utils.ResidualCoder(), match_height=match_height
        ).assign_targets([t(a) for a in sets], t(gt))
        np.testing.assert_array_equal(got['box_cls_labels'].numpy(),
                                      np.asarray(want['box_cls_labels']))
        close(got['box_reg_targets'], want['box_reg_targets'], 'targets', (1e-6, 1e-6))
        close(got['reg_weights'], want['reg_weights'], 'weights', (1e-6, 1e-7))
        labels[match_height] = got['box_cls_labels'].numpy()
        w = got['reg_weights'].numpy()
        assert (w > 0).any() and w.max() < 1.0     # divided by the examples
    assert (labels[True] > 0).any()
    assert not np.array_equal(labels[True], labels[False])


def jax_draws(key, n):
    k_fg, k_bg = jax.random.split(key)
    return (np.asarray(jax.random.uniform(k_fg, (n,))),
            np.asarray(jax.random.uniform(k_bg, (n,))))


@pytest.mark.parametrize('pos_fraction,sample_size', [(0.25, 64), (0.0, 64), (0.5, 512),
                                                      (1.0, 16)])
def test_subsample_with_jax_uniforms_matches_jax(pos_fraction, sample_size):
    rng = np.random.default_rng(11)
    n = 2000
    labels = rng.choice([-1, 0, 0, 0, 1, 2], n).astype(np.int32)
    bg = (labels == 0) | (rng.uniform(size=n) < 0.05)
    cfg = assigner_cfg(pos_fraction, sample_size)
    jax_asg = jax_axis_aligned.AxisAlignedTargetAssigner(cfg, ['Car'],
                                                         jax_coders.ResidualCoder())
    port = AxisAlignedTargetAssigner(cfg, ['Car'], box_coder_utils.ResidualCoder())
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jax_asg._subsample(jnp.asarray(labels), jnp.asarray(bg), key))
        u_fg, u_bg = jax_draws(key, n)
        got = port.subsample(t(labels).long(), t(bg), t(u_fg), t(u_bg)).numpy()
        np.testing.assert_array_equal(got, want)
        cap = int(pos_fraction * sample_size)
        assert (got > 0).sum() == min(cap, (labels > 0).sum())


def toy_scene():
    """``tests/test_pos_fraction.py``'s scene: 32 gt-identical anchors and
    32 far ones, one gt, batch 1."""
    gt = np.array([[10.0, 10.0, 0.0, 3.9, 1.6, 1.56, 0.0, 1.0]], np.float32)
    anchors = np.zeros((1, 4, 8, 2, 1, 7), np.float32)
    anchors[..., 3:6] = [3.9, 1.6, 1.56]
    anchors[:, :2, ..., 0:2] = 10.0
    anchors[:, 2:, ..., 0] = 100.0
    anchors[:, 2:, ..., 1] = np.arange(8)[None, None, :, None, None] * 20.0
    return [t(anchors)], t(gt[None])


def port_labels(pos_fraction, sample_size=32, global_step=None):
    asg = AxisAlignedTargetAssigner(assigner_cfg(pos_fraction, sample_size), ['Car'],
                                    box_coder_utils.ResidualCoder())
    anchors, gt = toy_scene()
    out = asg.assign_targets(anchors, gt, global_step=global_step)
    return out['box_cls_labels'][0].numpy(), out['reg_weights'][0].numpy()


def test_subsample_budgets_with_the_port_generator():
    labels, weights = port_labels(0.5)
    assert (labels > 0).sum() == 16 and (labels == 0).sum() == 16
    assert (labels == -1).sum() == labels.size - 32
    assert (np.where(labels.reshape(4, 8, 2) > 0)[0] < 2).all()
    assert ((weights > 0) == (labels > 0)).all()
    # fewer candidates than the budget: every one kept
    labels, _ = port_labels(0.5, sample_size=512)
    assert (labels > 0).sum() == 32 and (labels == 0).sum() == labels.size - 32
    # POS_FRACTION 0.0 is a setting: backgrounds only
    labels, _ = port_labels(0.0)
    assert (labels > 0).sum() == 0 and (labels == 0).sum() == 32
    # POS_FRACTION -1: no subsampling
    labels, _ = port_labels(-1.0)
    assert (labels > 0).sum() == 32 and (labels == -1).sum() == 0


def test_subsample_draws_by_global_step():
    a, _ = port_labels(0.5, global_step=3)
    b, _ = port_labels(0.5, global_step=3)
    c, _ = port_labels(0.5, global_step=4)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    np.testing.assert_array_equal(port_labels(0.5)[0], port_labels(0.5, global_step=0)[0])


# ---------------------------------------------------------------- dual pass


def bev_cfg(mode):
    return {'DUAL_PASS': mode, 'LAYER_NUMS': [2, 2], 'SFM_LAYER_NUMS': [1, 2],
            'LAYER_STRIDES': [2, 2], 'NUM_FILTERS': [16, 32], 'NUM_SCALE_FILTERS': [8, 16],
            'UPSAMPLE_STRIDES': [1, 2], 'NUM_UPSAMPLE_FILTERS': [16, 16]}


@pytest.fixture(scope='module')
def dual_pass():
    rng = np.random.default_rng(0)
    batch = {k: rng.normal(size=(4, 24, 32, c)).astype(np.float32)
             for k, c in (('spatial_features', 12), ('spatial_features_point', 12),
                          ('spatial_scale_features', 6))}
    jmod = JaxScaleBackbone(model_cfg=bev_cfg('sequential'), input_channels=12)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.jit(lambda bd: jmod.init(jax.random.PRNGKey(0), bd, train=True))(jbatch)
    flat = perturbed(variables, rng)
    want, upd = jax.jit(lambda var, bd: jmod.apply(var, bd, train=True,
                                                   mutable=['batch_stats']))(unflatten(flat),
                                                                             jbatch)
    state = {k[len('backbone_2d.'):]: v for k, v in from_flax_variables(
        {'/'.join(k.split('/')[:1] + ['backbone_2d'] + k.split('/')[1:]): v
         for k, v in flat.items()}).items()}
    stats = {k[len('backbone_2d.'):]: v for k, v in from_flax_variables(
        {'batch_stats/backbone_2d/' + '/'.join(str(p.key) for p in path): np.asarray(v)
         for path, v in jax.tree_util.tree_leaves_with_path(upd['batch_stats'])}).items()}
    outs = {}
    for mode in ('sequential', 'stacked'):
        mod = BaseBEVBackboneScale(bev_cfg(mode), 12, 6)
        mod.load_state_dict(state, strict=True)
        mod.train()
        with torch.no_grad():
            out = mod({k: t(v) for k, v in batch.items()})
        outs[mode] = (out, mod.state_dict())
    return want, stats, outs


def test_sequential_dual_pass_matches_jax(dual_pass):
    want, stats, outs = dual_pass
    out, port_state = outs['sequential']
    for k in ('spatial_features_2d', 'spatial_features_point_2d'):
        close(out[k], want[k], k, (2e-5, 2e-5))
    assert stats
    for k, v in stats.items():
        if 'running' in k:
            close(port_state[k], v.numpy(), k, (2e-5, 2e-5))


def test_sequential_dual_pass_matches_stacked(dual_pass):
    _, _, outs = dual_pass
    (seq, seq_state), (st, st_state) = outs['sequential'], outs['stacked']
    for k in ('spatial_features_2d', 'spatial_features_point_2d'):
        close(st[k], seq[k].numpy(), k, (2e-5, 2e-5))
    for k, v in seq_state.items():
        if 'running' in k:
            # a BN visited more than once a pass (the repeated SFM conv and
            # the attention) interleaves its updates in the stacked pass
            tol = 5e-3 if 'sfmblocks_down' in k or 'attention' in k else 2e-5
            close(st_state[k], v.numpy(), k, (tol, tol))


# ---------------------------------------------------------------- approx top-k


def scatter_cfg(mode):
    return {'NAME': 'PointPillarScatter_Agg_Memory_1_scale', 'NUM_K': 5, 'NUM_M': 64,
            'NUM_PT_FEATURES': 16, 'SHRINK_TH': 0.0025, 'TOPK_MODE': mode}


def test_approx_topk_eval_forward_matches_jax_and_exact():
    """The memory scatter's eval forward (the memory's top-k lookup and the
    canvases) under TOPK_MODE approx against the JAX module's approx
    (``lax.approx_max_k``, exact off the TPU) on seeded pillars with empty
    slots, at ``tests/test_torch_port_mini.py``'s map_to_bev tolerance (rtol
    1e-2, atol 1e-3 of the largest value: the reconstruction rounds to bf16,
    where a flipped ulp moves a value by ~2^-8 of it). The port's approx
    equals its exact mode bit for bit."""
    from hvpr_tpu.models.backbones_2d.map_to_bev.pointpillar_scatter import (
        PointPillarScatterAggMemory1Scale as JaxScatter)
    rng = np.random.default_rng(8)
    b, v, nx, ny = 2, 96, 16, 12
    cells = np.stack([rng.permutation(nx * ny)[:v] for _ in range(b)])
    coords = np.stack([np.zeros_like(cells), cells // nx, cells % nx], -1).astype(np.int32)
    batch = {'pillar_features': rng.normal(size=(b, v, 16)).astype(np.float32),
             'pillar_scale_features': rng.normal(size=(b, v, 8)).astype(np.float32),
             'voxel_coords': coords, 'voxel_mask': rng.uniform(size=(b, v)) < 0.8}
    jmod = JaxScatter(model_cfg=scatter_cfg('approx'), grid_size=(nx, ny, 1))
    jbatch = {k: jnp.asarray(x) for k, x in batch.items()}
    variables = jmod.init(jax.random.PRNGKey(0), dict(jbatch), train=False)
    want = jax.jit(lambda bd: jmod.apply(variables, bd, train=False))(dict(jbatch))
    outs = {}
    for mode in ('approx', 'exact'):
        mod = PointPillarScatterAggMemory1Scale(scatter_cfg(mode), (nx, ny, 1)).eval()
        mod.load_state_dict({'memory.weight': t(variables['params']['memory']['weight'])})
        with torch.no_grad():
            outs[mode] = mod({k: t(x) for k, x in batch.items()})
    for k in ('spatial_features', 'spatial_scale_features'):
        close(outs['approx'][k], want[k], k, (1e-2, 1e-3))
        assert torch.equal(outs['approx'][k], outs['exact'][k]), k


@pytest.mark.parametrize('cfg,mode', [({'TOPK_MODE': 'approx'}, 'approx'),
                                      ({'TOPK_MODE': 'EXACT'}, 'exact'),
                                      ({'TOPK_MODE': 'fused', 'EXACT_TOPK': True}, 'exact'),
                                      ({}, 'fused'),
                                      ({'TOPK_MODE': 'nearest'}, None)])
def test_topk_mode_is_validated_at_construction(cfg, mode):
    base = {'NUM_K': 4, 'NUM_M': 16, 'NUM_PT_FEATURES': 8, 'SHRINK_TH': 0.0025, **cfg}
    if mode is None:
        with pytest.raises(ValueError, match='TOPK_MODE'):
            PointPillarScatterAggMemory1Scale(base, (8, 8, 1))
    else:
        assert PointPillarScatterAggMemory1Scale(base, (8, 8, 1)).topk_mode == mode


# ---------------------------------------------------------------- fill_infos


class _MockNusc:
    """A devkit stand-in: flat token -> record tables (``tests/test_nuscenes.py``'s)."""

    def __init__(self, tables):
        self.tables = tables

    def get(self, table, token):
        return self.tables[table][token]


def _pose(rng):
    yaw = rng.uniform(-np.pi, np.pi)
    return {'translation': list(rng.uniform(-50, 50, 3)),
            'rotation': [np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)]}


def mock_database(rng, n_sweeps=4):
    sd = {f'sd{i}': {'timestamp': 2_000_000 - 50_000 * i, 'filename': f'sweeps/{i}.bin',
                     'calibrated_sensor_token': f'cs{i}', 'ego_pose_token': f'ep{i}',
                     'prev': f'sd{i + 1}' if i + 1 < n_sweeps else ''}
          for i in range(n_sweeps)}
    sd['sd0']['filename'] = 'samples/x.bin'
    categories = ['vehicle.car', 'movable_object.debris', 'human.pedestrian.adult']
    anns = {f'a{j}': {'translation': list(rng.uniform(-20, 20, 3)),
                      'size': list(rng.uniform(0.5, 4.5, 3)),
                      'rotation': _pose(rng)['rotation'],
                      'category_name': categories[j], 'num_lidar_pts': int(j * 7 + 3)}
            for j in range(3)}
    return {'sample': {'s0': {'data': {'LIDAR_TOP': 'sd0'}, 'anns': list(anns),
                              'scene_token': 'sc0'},
                       's1': {'data': {'LIDAR_TOP': 'sd1'}, 'anns': [],
                              'scene_token': 'sc0'}},
            'sample_data': sd,
            'calibrated_sensor': {f'cs{i}': _pose(rng) for i in range(n_sweeps)},
            'ego_pose': {f'ep{i}': _pose(rng) for i in range(n_sweeps)},
            'sample_annotation': anns}


@pytest.mark.parametrize('max_sweeps', [10, 2])
def test_fill_infos_matches_jax(max_sweeps):
    from hvpr_tpu.datasets.nuscenes import nuscenes_utils as jax_nu
    from hvpr_tpu_torch.datasets.nuscenes import nuscenes_utils as port_nu
    nusc = _MockNusc(mock_database(np.random.default_rng(2)))
    want = jax_nu.fill_infos(nusc, ['s0', 's1'], max_sweeps=max_sweeps)
    got = port_nu.fill_infos(nusc, ['s0', 's1'], max_sweeps=max_sweeps)
    assert len(got) == len(want) == 2
    assert len(got[0]['sweeps']) == min(max_sweeps - 1, 3)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in ('lidar_path', 'token', 'timestamp'):
            assert g[k] == w[k], k
        np.testing.assert_array_equal(g['gt_names'], w['gt_names'])
        np.testing.assert_array_equal(g['num_lidar_pts'], w['num_lidar_pts'])
        assert g['gt_boxes'].dtype == w['gt_boxes'].dtype and g['gt_names'].dtype.kind == 'U'
        assert g['gt_boxes'].shape == w['gt_boxes'].shape
        if len(w['gt_boxes']):
            close(g['gt_boxes'], w['gt_boxes'], 'gt_boxes', (1e-6, 1e-6))
        close(g['ref_to_global'], w['ref_to_global'], 'ref_to_global', (1e-6, 1e-6))
        for gs, ws in zip(g['sweeps'], w['sweeps']):
            assert gs['lidar_path'] == ws['lidar_path'] and gs['time_lag'] == ws['time_lag']
            close(gs['transform_matrix'], ws['transform_matrix'], 'sweep', (1e-6, 1e-6))
    assert list(got[0]['gt_names']) == ['car', 'ignore', 'pedestrian']


# ---------------------------------------------------------------- helpers


def test_smoothed_value_and_metric_logger_match_jax(capsys):
    from hvpr_tpu.utils import misc as jax_misc
    from hvpr_tpu_torch.utils import misc
    values = np.random.default_rng(4).uniform(0, 5, 30).tolist()
    sv, jsv = misc.SmoothedValue(window_size=7), jax_misc.SmoothedValue(window_size=7)
    for i, v in enumerate(values):
        sv.update(v, n=1 + i % 3)
        jsv.update(v, n=1 + i % 3)
    for attr in ('median', 'avg', 'global_avg', 'max', 'value', 'count', 'total'):
        assert getattr(sv, attr) == getattr(jsv, attr), attr
    assert str(sv) == str(jsv)
    logs = []
    for mod in (misc, jax_misc):
        ml = mod.MetricLogger(delimiter=' | ')
        for v in values[:5]:
            ml.update(loss=v, lr=v / 10)
        assert ml.loss.count == 5
        with pytest.raises(AttributeError):
            ml.missing
        ml.add_meter('it', mod.SmoothedValue(fmt='{value:.1f}'))
        assert list(ml.log_every(range(4), 2, header='ep')) == [0, 1, 2, 3]
        logs.append(str(ml))
        assert 'ep [0/4]' in capsys.readouterr().out
    assert logs[0] == logs[1]


def test_device_memory_stats_and_profiler_on_the_cpu(tmp_path):
    from hvpr_tpu_torch.utils import misc, profiler
    assert misc.device_memory_stats() == ({} if not torch.cuda.is_available() else
                                          misc.device_memory_stats())
    with profiler.trace(tmp_path / 'trace') as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert (tmp_path / 'trace' / 'trace.json').stat().st_size > 0
    assert any('mm' in e.key for e in prof.key_averages())


def test_weighted_l1_corner_loss_and_voxel_centers_match_jax():
    from hvpr_tpu.utils import common_utils as jax_common
    from hvpr_tpu.utils import loss_utils as jax_loss
    from hvpr_tpu_torch.utils import common_utils, loss_utils
    rng = np.random.default_rng(6)
    x, y = rng.normal(size=(2, 2, 50, 7)).astype(np.float32)
    y[0, 3, 2] = np.nan
    w = rng.uniform(0, 1, (2, 50)).astype(np.float32)
    cw = [1.0, 2.0, 0.5, 1.0, 1.0, 1.0, 3.0]
    want = jax_loss.WeightedL1Loss(code_weights=cw)(jnp.asarray(x), jnp.asarray(y),
                                                   weights=jnp.asarray(w))
    close(loss_utils.WeightedL1Loss(code_weights=cw)(t(x), t(y), t(w)), want, 'l1',
          (1e-6, 1e-6))
    close(loss_utils.WeightedL1Loss()(t(x), t(y)), jax_loss.WeightedL1Loss()(
        jnp.asarray(x), jnp.asarray(y)), 'l1 unweighted', (1e-6, 1e-6))
    pred, gt = random_boxes(rng, 40), random_boxes(rng, 40)
    gt[:10] = pred[:10] + rng.normal(0, 0.05, (10, 7)).astype(np.float32)
    gt[10:15, 6] = pred[10:15, 6] + np.pi          # the flipped heading
    close(loss_utils.get_corner_loss_lidar(t(pred), t(gt)),
          jax_loss.get_corner_loss_lidar(jnp.asarray(pred), jnp.asarray(gt)), 'corners',
          (1e-5, 1e-6))
    coords = rng.integers(0, 400, (100, 3)).astype(np.int32)
    vs, pcr = [0.16, 0.16, 4.0], [0.0, -39.68, -3.0, 69.12, 39.68, 1.0]
    want = jax_common.get_voxel_centers(jnp.asarray(coords), 2, vs, pcr)
    close(common_utils.get_voxel_centers(t(coords), 2, vs, pcr), want, 'centres',
          (1e-6, 1e-6))
    close(common_utils.get_voxel_centers(coords, 2, vs, pcr), want, 'centres (numpy)',
          (1e-6, 1e-6))
