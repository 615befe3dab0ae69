"""The port's train path against the JAX package on hvpr_mini.yaml, on the CPU.

Both sides run TRAIN_ATTEND_MODE gather (tests/test_torch_port_train_fused.py
runs the shipped mode, fused, through the same checks), BALL_QUERY bucket (the port's
'auto'; the JAX package's CPU 'auto' is the first-by-index rule) and
FPS_CHUNKS 4, from the same flax-initialized weights (BN statistics and
affine terms perturbed from a seed) and the same seeded batch. The points
are uniform over the range: in tight clusters the 3-NN of the feature
propagation meets near-ties that the f32 matmul-form distances break by
summation order (the JAX package documents that noise at ~1e-4 m^2).

Tolerances and why (f32 everywhere):
- module outputs and BN running statistics: rtol 1e-4, atol 1e-5 of the
  largest value; the arithmetic is the JAX package's, summed in another
  order. The memory path (memory features, the memory map) also carries the
  bf16 roundings of the reconstruction, where an f32-ulp difference can flip
  a bf16 rounding (2^-8 of one term): atol 1e-3 of the largest value.
- target labels: exact; regression targets rtol 1e-6.
- gradients, leaf by leaf, before the optimizer: the difference within
  ``tol`` of the leaf's gradient, in L2 norm and in max magnitude, plus
  1e-7 of the global gradient norm (~12). tol is 1e-4 for the VFE, the BEV
  backbone and the heads (measured <= 2.1e-5 but for the sums below),
  1e-3 for the point stream, whose gradient passes back through the
  reconstruction's bf16 products (measured <= 3.6e-4), and 1e-2 for the
  memory, every element of which is a sum over those bf16 products
  (measured 2.7e-3). The absolute term
  covers a leaf whose gradient is a sum that cancels: the attention BN's
  single bias (1.9e-3, off by 3.8e-7) and conv biases before a BN, whose
  gradient is rounding noise (~1e-9).
- one step: loss terms and the gradient norm rtol 1e-4, and 99% of the
  updated parameters within 1e-6 relative of JAX's. Adam's first step
  moves a weight by about lr whatever its gradient's size, so a weight
  whose gradient is at the rounding-noise level may step the other way;
  the leaf-by-leaf gradients above are what hold the update's direction.
- three steps: those flipped steps feed the next forward, so loss terms
  rtol 5e-3, the gradient norm rtol 1e-2, the running statistics rtol 1e-3,
  and 90% of the parameters within 0.1 lr of JAX's (measured 94.8%; 17%
  stay within 1e-6 relative).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from hvpr_tpu.models import build_network as jax_build_network
from hvpr_tpu.optimization import build_optimizer as jax_build_optimizer
from hvpr_tpu.parallel import TrainState as JaxTrainState
from hvpr_tpu.parallel import make_train_step as jax_make_train_step
from hvpr_tpu.ops.voxelizer import voxelize_batch_flat as jax_voxelize

from hvpr_tpu_torch.models import DatasetMeta
from hvpr_tpu_torch.models import build_network as port_build_network
from hvpr_tpu_torch.models.model_utils import layers as port_layers
from hvpr_tpu_torch.parallel import loss_and_grads
from hvpr_tpu_torch.utils.weights import from_flax_variables

from torch_port_helpers import mini_cfg, to_np, to_torch

TOTAL_STEPS = 50


def train_cfg(cfg=None):
    cfg = mini_cfg() if cfg is None else cfg
    cfg.MODEL.MAP_TO_BEV.TRAIN_ATTEND_MODE = 'gather'
    cfg.MODEL.BACKBONE_3D.SA_CONFIG.BALL_QUERY = 'bucket'
    cfg.MODEL.BACKBONE_3D.SA_CONFIG.FPS_CHUNKS = 4
    return cfg


def uniform_points(rng, b, n, pcr, channels=4):
    """(B, N, channels) points uniform over the range (intensity in [0, 1);
    a fifth channel, the time lag of nuScenes sweeps, in [0, 0.5))."""
    pts = np.zeros((b, n, channels), np.float32)
    lo, hi = np.asarray(pcr[0:3]), np.asarray(pcr[3:6])
    pts[..., :3] = lo + rng.uniform(0.02, 0.98, (b, n, 3)) * (hi - lo)
    pts[..., 3] = rng.uniform(0, 1, (b, n))
    if channels == 5:
        pts[..., 4] = rng.uniform(0, 0.5, (b, n))
    return pts


def gt_boxes(rng, b, pcr, n=4, num_classes=1):
    """(B, n, 8) car-sized boxes inside the range, class 1 (with
    ``num_classes`` > 1, drawn from 1..num_classes); the last row of the
    last sample is padding (zeros)."""
    gt = np.zeros((b, n, 8), np.float32)
    lo, hi = np.asarray(pcr[:3]), np.asarray(pcr[3:])
    gt[..., 0:2] = lo[:2] + rng.uniform(0.2, 0.8, (b, n, 2)) * (hi - lo)[:2]
    gt[..., 2] = -1.0
    gt[..., 3:6] = [3.9, 1.6, 1.56] * rng.uniform(0.9, 1.1, (b, n, 3))
    gt[..., 6] = rng.uniform(-np.pi, np.pi, (b, n))
    gt[..., 7] = 1 if num_classes == 1 else rng.integers(1, num_classes + 1, (b, n))
    gt[-1, -1] = 0
    return gt


class TrainPair:
    """The JAX network and the port's train network with the same weights."""

    def __init__(self, cfg, batch=2, n_points=256, seed=0, host_batch=None,
                 cls_bias=None):
        """``host_batch``: a batch of the data layer (its numpy arrays are
        taken) in place of seeded points voxelized by the JAX device
        voxelizer. ``cls_bias``: the cls head's bias (fresh init puts every
        score at 0.01, below SCORE_THRESH)."""
        self.cfg = cfg
        self.meta = DatasetMeta(cfg.DATA_CONFIG, cfg.CLASS_NAMES, mode='train')
        m = self.meta
        rng = np.random.default_rng(seed)
        if host_batch is not None:
            self.gt = host_batch['gt_boxes']
            self.jbatch = {k: jnp.asarray(v) for k, v in host_batch.items()
                           if isinstance(v, np.ndarray)}
        else:
            self.points = uniform_points(rng, batch, n_points, m.point_cloud_range,
                                         channels=m.num_point_features)
            self.mask = np.ones((batch, n_points), bool)
            self.mask[:, -7:] = False
            self.gt = gt_boxes(rng, batch, m.point_cloud_range,
                               num_classes=len(cfg.CLASS_NAMES))
            pts, mask = jnp.asarray(self.points), jnp.asarray(self.mask)
            vox = jax_voxelize(pts, mask, tuple(float(v) for v in m.point_cloud_range),
                               tuple(float(v) for v in m.voxel_size),
                               max_voxels=m.max_voxels,
                               max_points_per_voxel=m.max_points_per_voxel,
                               grid_size_static=tuple(int(g) for g in m.grid_size))
            self.jbatch = {'points': pts, 'point_valid_mask': mask, **vox,
                           'gt_boxes': jnp.asarray(self.gt)}
        # the JAX builder reads the point channels off the dataset's encoder
        jmeta = types.SimpleNamespace(**vars(m), point_feature_encoder=types.SimpleNamespace(
            num_point_features=m.num_point_features))
        self.jnet = jax_build_network(cfg.MODEL, len(cfg.CLASS_NAMES), jmeta)
        variables = self.jnet.init(jax.random.PRNGKey(seed), self.jbatch, train=True)
        flat = {'/'.join(k): np.asarray(v) for k, v in
                traverse_util.flatten_dict(variables).items()}
        for key in flat:
            if key.startswith('batch_stats/') and key.endswith('/mean'):
                flat[key] = rng.normal(0, 0.1, flat[key].shape).astype(np.float32)
            elif key.startswith('batch_stats/') and key.endswith('/var'):
                flat[key] = rng.uniform(0.5, 2.0, flat[key].shape).astype(np.float32)
            elif key.endswith('/scale') or (key.endswith('/bias') and 'BatchNorm' in key):
                flat[key] = (flat[key] + rng.normal(0, 0.1, flat[key].shape)
                             ).astype(np.float32)
        if cls_bias is not None:
            key = 'params/dense_head/conv_cls/bias'
            flat[key] = np.full_like(flat[key], cls_bias)
        self.flat = flat
        self.variables = traverse_util.unflatten_dict(
            {tuple(k.split('/')): jnp.asarray(v) for k, v in flat.items()})
        self.state_dict = from_flax_variables(flat)
        self.tnet = port_build_network(cfg.MODEL, len(cfg.CLASS_NAMES), m,
                                       device='cpu', train=True)
        self.reset()

    def reset(self):
        self.tnet.load_state_dict(self.state_dict)
        self.tnet.module.train()

    def tbatch(self):
        return {k: torch.from_numpy(np.array(v)) for k, v in self.jbatch.items()}

    def jax_upto(self, stage):
        out, mutated = self.jnet.module.apply(
            self.variables, self.jbatch, train=True, upto=stage,
            mutable=['batch_stats'])
        return out, traverse_util.flatten_dict(mutated['batch_stats'], sep='/')


def assert_close(got, want, rtol, atol_frac, what):
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_frac * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def assert_stats(pair, jstats, prefix):
    """The port's running statistics under ``prefix`` against JAX's."""
    port = pair.tnet.module.state_dict()
    want = from_flax_variables({'batch_stats/' + k: v for k, v in jstats.items()})
    keys = [k for k in want if k.startswith(prefix) and 'running' in k]
    assert keys
    for k in keys:
        assert_close(port[k], want[k].numpy(), 1e-4, 1e-5, k)


@pytest.fixture(scope='module')
def pair():
    return TrainPair(train_cfg())


def test_point_stream_and_its_bn_stats_match_jax(pair):
    pair.reset()
    jout, jstats = pair.jax_upto('backbone_3d')
    out = pair.tnet.module.backbone_3d(pair.tbatch())
    assert_close(out['point_features'], jout['point_features'], 1e-4, 1e-5,
                 'point_features')
    assert float(np.abs(to_np(out['point_features'])).max()) > 0
    assert_stats(pair, jstats, 'backbone_3d.')


def test_vfe_and_map_to_bev_train_match_jax(pair):
    pair.reset()
    jout, jstats = pair.jax_upto('map_to_bev')
    mod = pair.tnet.module
    batch = mod.vfe(dict(pair.tbatch(), point_features=to_torch(jout['point_features'])))
    for k in ('pillar_features', 'pillar_scale_features'):
        assert_close(batch[k], jout[k], 1e-4, 1e-5, k)
    assert_stats(pair, jstats, 'vfe.')
    keys_in = ('pillar_features', 'pillar_scale_features', 'voxel_coords',
               'voxel_mask', 'point_features', 'point_valid_mask')
    out = mod.map_to_bev_module({k: to_torch(jout[k]) for k in keys_in})
    for k, tol in (('spatial_features', 1e-3), ('memory_positive_features', 1e-3),
                   ('spatial_features_point', 1e-5), ('spatial_scale_features', 1e-5),
                   ('point_positive_features', 1e-5)):
        assert_close(out[k], jout[k], 1e-4, tol, k)


def test_backbone_2d_stacked_dual_pass_matches_jax(pair):
    pair.reset()
    jout, jstats = pair.jax_upto('backbone_2d')
    mod = pair.tnet.module
    keys_in = ('spatial_features', 'spatial_features_point', 'spatial_scale_features')
    out = mod.backbone_2d({k: to_torch(jout[k]) for k in keys_in})
    for k in ('spatial_features_2d', 'spatial_features_point_2d'):
        assert_close(out[k], jout[k], 1e-4, 1e-5, k)
    assert_stats(pair, jstats, 'backbone_2d.')


def test_target_labels_match_jax_exactly(pair):
    from hvpr_tpu.models.dense_heads.anchor_head_single import AnchorHeadSingle as JHead
    head_cfg = pair.cfg.MODEL.DENSE_HEAD
    jhead = JHead(model_cfg=head_cfg, input_channels=8, num_class=1,
                  class_names=pair.cfg.CLASS_NAMES,
                  grid_size=tuple(int(g) for g in pair.meta.grid_size),
                  point_cloud_range=tuple(float(v) for v in pair.meta.point_cloud_range))
    jt = jhead.bind({}).target_assigner.assign_targets(
        jhead.bind({}).anchors_list, jnp.asarray(pair.gt))
    head = pair.tnet.module.dense_head
    tt = head.target_assigner.assign_targets(
        [getattr(head, f'class_anchors_{i}') for i in range(head.num_anchor_classes)],
        torch.from_numpy(pair.gt))
    labels = np.asarray(jt['box_cls_labels'])
    np.testing.assert_array_equal(tt['box_cls_labels'].numpy(), labels)
    assert (labels > 0).sum() >= 4 and (labels == -1).sum() > 0
    np.testing.assert_allclose(tt['box_reg_targets'].numpy(),
                               np.asarray(jt['box_reg_targets']), rtol=1e-6, atol=1e-6)


def test_masked_and_split_batchnorm_train_match_flax():
    from hvpr_tpu.models.model_utils.layers import MaskedBatchNorm, SplitBatchNorm
    rng = np.random.default_rng(5)
    x = rng.normal(1.0, 2.0, (6, 50)).astype(np.float32)
    mask = rng.uniform(size=50) > 0.3
    jbn = MaskedBatchNorm()
    jv = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask), False,
                  transposed=True)
    jy, jm = jbn.apply(jv, jnp.asarray(x), jnp.asarray(mask), True, transposed=True,
                       mutable=['batch_stats'])
    bn = port_layers.MaskedBatchNorm(6).train()
    y = bn(torch.from_numpy(x), torch.from_numpy(mask))
    assert_close(y, jy, 1e-5, 1e-6, 'masked bn')
    assert_close(bn.running_var, jm['batch_stats']['var'], 1e-6, 1e-7, 'unbiased var')
    assert_close(bn.running_mean, jm['batch_stats']['mean'], 1e-6, 1e-7, 'mean')

    x4 = rng.normal(0.5, 1.5, (4, 5, 6, 3)).astype(np.float32)          # NHWC
    sbn = SplitBatchNorm()
    sv = sbn.init(jax.random.PRNGKey(0), jnp.asarray(x4), False)
    sy, sm = sbn.apply(sv, jnp.asarray(x4), True, splits=2, mutable=['batch_stats'])
    tbn = port_layers.SplitBatchNorm(3).train()
    ty = tbn(torch.from_numpy(x4).permute(0, 3, 1, 2), splits=2).permute(0, 2, 3, 1)
    assert_close(ty, sy, 1e-5, 1e-6, 'split bn')
    assert_close(tbn.running_var, sm['batch_stats']['var'], 1e-6, 1e-7, 'biased var')
    assert_close(tbn.running_mean, sm['batch_stats']['mean'], 1e-6, 1e-7, 'mean')


def run_steps(pair, n_steps):
    """n steps on both sides from the same state: per-step metrics and the
    final params / batch stats as port state_dicts."""
    optim_cfg = pair.cfg.OPTIMIZATION
    tx, lr_fn = jax_build_optimizer(pair.variables['params'], optim_cfg,
                                    total_steps=TOTAL_STEPS)
    step = jax_make_train_step(pair.jnet.module, tx, donate=False)
    state = JaxTrainState.create(pair.variables, tx)
    pair.reset()
    pair.tnet.init_training(optim_cfg, TOTAL_STEPS)
    jm, tm = [], []
    for _ in range(n_steps):
        state, metrics = step(state, pair.jbatch)
        jm.append({k: float(v) for k, v in metrics.items()})
        tm.append({k: float(v) for k, v in pair.tnet.train_step(pair.tbatch()).items()})
    flat = {'/'.join(k): np.asarray(v) for k, v in traverse_util.flatten_dict(
        {'params': state.params, 'batch_stats': state.batch_stats}).items()}
    want = from_flax_variables(flat)
    return jm, tm, want, float(lr_fn(0))


def check_steps(pair, n_steps, first_rtol=None, stats_tol=None,
                agree_lr_frac=None, agree_frac=0.99):
    """``first_rtol``: {metric: rtol} of the first step (default 1e-4);
    ``stats_tol``: (rtol, atol as a fraction of the largest value) of the
    running statistics (default (1e-4, 1e-5) after one step, (1e-3, 1e-5)
    after more); ``agree_frac`` of the parameters must agree with JAX's
    within ``agree_lr_frac`` of the first step's lr (default: within 1e-6
    relative)."""
    jm, tm, want, lr0 = run_steps(pair, n_steps)
    one = n_steps == 1
    for i, (j, t) in enumerate(zip(jm, tm)):
        assert set(t) == set(j), (set(t) ^ set(j))
        for k in j:
            if i == 0:
                rtol = (first_rtol or {}).get(k, 1e-4)
            else:
                rtol = 1e-2 if k == 'grad_norm' else 5e-3
            np.testing.assert_allclose(t[k], j[k], rtol=rtol, atol=1e-7,
                                       err_msg=f'step {i}: {k}')
        assert np.isfinite(t['loss']) and t['loss'] > 0
    port = pair.tnet.module.state_dict()
    assert set(want) <= set(port)
    agree = total = 0
    for k, w in want.items():
        got, w = port[k].numpy(), w.numpy()
        if 'num_batches' in k:
            continue
        if 'running' in k:
            assert_close(got, w, *(stats_tol or (1e-4 if one else 1e-3, 1e-5)), k)
            continue
        tol = (1e-7 + 1e-6 * np.abs(w) if agree_lr_frac is None
               else agree_lr_frac * lr0)
        agree += int(np.sum(np.abs(got - w) <= tol))
        total += w.size
    assert agree >= agree_frac * total, (agree, total)
    return tm


def grad_tol(name):
    """The leaf-by-leaf gradient tolerance of the module docstring."""
    if name.startswith('map_to_bev_module.memory'):
        return 1e-2
    return 1e-3 if name.startswith('backbone_3d.') else 1e-4


def check_gradients(pair, grad_tol=grad_tol):
    """Each gradient leaf of one port step against ``jax.grad``, within
    ``grad_tol(name)`` of the leaf (module docstring)."""
    def loss_fn(params):
        out, _ = pair.jnet.module.apply(
            {'params': params, 'batch_stats': pair.variables['batch_stats']},
            dict(pair.jbatch, global_step=0), train=True, mutable=['batch_stats'])
        return out['loss']

    jgrads = jax.grad(loss_fn)(pair.variables['params'])
    want = from_flax_variables({'params/' + '/'.join(k): np.asarray(v) for k, v in
                                traverse_util.flatten_dict(jgrads).items()})
    pair.reset()
    pair.tnet.init_training(pair.cfg.OPTIMIZATION, TOTAL_STEPS)
    _, grads = loss_and_grads(pair.tnet.train_state, pair.tbatch())
    pair.reset()
    names = [n for n, _ in pair.tnet.module.named_parameters()]
    assert set(names) == set(want)
    atol = 1e-7 * np.sqrt(sum(float((w.double() ** 2).sum()) for w in want.values()))
    for name, g in zip(names, grads):
        g, w = g.numpy(), want[name].numpy()
        diff, tol = g - w, grad_tol(name)
        assert np.linalg.norm(diff) <= tol * np.linalg.norm(w) + atol, \
            (name, np.linalg.norm(diff), np.linalg.norm(w))
        assert np.abs(diff).max() <= tol * np.abs(w).max() + atol, \
            (name, np.abs(diff).max(), np.abs(w).max())


def test_gradients_match_jax_leaf_by_leaf(pair):
    check_gradients(pair)


@pytest.mark.parametrize('n_steps', [1, 3])
def test_train_steps_match_jax(pair, n_steps):
    tm = check_steps(pair, n_steps) if n_steps == 1 else \
        check_steps(pair, n_steps, agree_lr_frac=0.1, agree_frac=0.9)
    if n_steps == 3:
        assert tm[-1]['loss'] != tm[0]['loss']


def test_gradients_reach_the_vfe_and_the_point_stream(pair):
    pair.reset()
    out = pair.tnet.module(pair.tbatch())
    out['loss'].backward()
    grads = {n: p.grad for n, p in pair.tnet.module.named_parameters()}
    for name in ('vfe.pfn_layers.0.linear.weight', 'vfe.pfn_scale_layers.0.0.weight',
                 'backbone_3d.SA_modules.0.mlps.0.0.weight',
                 'backbone_3d.FP_modules.0.mlp.3.weight',
                 'map_to_bev_module.memory.weight', 'dense_head.conv_cls.weight'):
        assert grads[name] is not None and float(grads[name].abs().max()) > 0, name
    for p in pair.tnet.module.parameters():
        p.grad = None


def test_gather_mode_backwards_repeat_their_bits(pair, monkeypatch):
    """The gather mode's gathers (each pillar's top-k points in the
    attentive pooling, their reconstructions in the memory path) go through
    ``gather_rows``, as the point stream's do: two backwards from the same
    state give the same bits with deterministic algorithms off, each
    through the in-order backward (K12's plain version here) 4 times for
    the point stream, once for the pooling's one chunk of pillars and once
    for the memory path."""
    from hvpr_tpu_torch.ops import gather_rows
    calls = []
    backward = gather_rows.gather_rows_backward
    monkeypatch.setattr(gather_rows, 'gather_rows_backward',
                        lambda *a: calls.append(a[2]) or backward(*a))
    assert not torch.are_deterministic_algorithms_enabled()
    runs = []
    for _ in range(2):
        pair.reset()
        pair.tnet.init_training(pair.cfg.OPTIMIZATION, TOTAL_STEPS)
        runs.append(loss_and_grads(pair.tnet.train_state, pair.tbatch())[1])
    pair.reset()
    assert len(calls) == 2 * 6, calls
    for a, b in zip(*runs):
        assert torch.equal(a, b)
