"""The port's roofline accounting (``hvpr_tpu_torch/utils/flops.py``) and
its profilers (``hvpr_tpu_torch/tools/profile_*.py``) against the JAX
package's ``hvpr_tpu/utils/flops.py`` and profile records, on the CPU.

Tolerances and why:
- ``utilization`` and the four analytic formulas: exactly equal (the same
  arithmetic), the formulas at widths that are multiples of the TPU's
  padding (128, and 256 for V); at an unpadded shape the JAX value is the
  port's times the padding ratio, to 1e-12 relative.
- the counter's flops for backbone_2d and dense_head against
  ``xla_cost`` of the same JAX stage, jitted on the CPU: the counter takes
  every tap of a convolution (``torch.utils.flop_counter``), so it equals
  the full-tap formula exactly; XLA counts the in-bounds taps plus one flop
  for each element of an elementwise op. So XLA minus the in-bounds taps
  (computed here from each convolution's shapes, stride and padding) must
  lie in [0, 16 x the stage's output elements]: 16 flops an output element
  covers BatchNorm (4), ReLU (1), the CBAM gates and the head's box decode
  (measured: 7.0 and 2.9 an element at hvpr_mini.yaml).
- every wrapper's report: at most its formula for the call (a forward
  call against the forward's value, a backward call against the value
  with its forward, since the JAX count of memory_recon's backward is one
  of K7's five products short); the lookup's report exactly its
  data-dependent work.
"""

import math

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from hvpr_tpu.utils import flops as jax_flops

from hvpr_tpu_torch.ops import memory_lookup, memory_recon, topk_attend
from hvpr_tpu_torch.tools import (profile_head, profile_lookup, profile_pn2, profile_post,
                                  profile_stages, profile_train, profile_train_stages)
from hvpr_tpu_torch.utils import flops

from torch_port_helpers import Pair, mini_cfg, to_torch

PEAKS = (197e12, 819e9)


@pytest.mark.parametrize('fl, nbytes, seconds, bound', [
    (1e9, 1e6, 1.0, 'latency/host'),
    (5e12, 1e9, 1.0, 'compute'),
    (1e12, 4e11, 1.0, 'hbm'),
])
def test_utilization_equals_jax(monkeypatch, fl, nbytes, seconds, bound):
    monkeypatch.setenv('HVPR_PEAK_TFLOPS', str(PEAKS[0] / 1e12))
    monkeypatch.setenv('HVPR_HBM_GBPS', str(PEAKS[1] / 1e9))
    want = jax_flops.utilization(fl, nbytes, seconds)
    assert want['bound'] == bound
    assert flops.utilization(fl, nbytes, seconds, PEAKS) == want
    # with both overrides the port reads the same peaks without a card
    assert flops.device_peaks() == jax_flops.device_peaks() == PEAKS
    assert flops.utilization(fl, nbytes, seconds) == want


def test_unknown_card_raises(monkeypatch):
    monkeypatch.delenv('HVPR_PEAK_TFLOPS', raising=False)
    monkeypatch.delenv('HVPR_HBM_GBPS', raising=False)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        flops.device_peaks()
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'get_device_name', lambda device=None: 'NVIDIA A100-SXM4-40GB')
    with pytest.raises(RuntimeError, match='no published rates'):
        flops.device_peaks()
    monkeypatch.setattr(torch.cuda, 'get_device_name', lambda device=None: 'NVIDIA H100 80GB HBM3')
    assert flops.device_peaks() == (989e12, 3.35e12)


def _pad(x, m):
    return -(-x // m) * m


# (port formula, JAX formula, args at padded widths, args unpadded, padding ratio)
FORMULAS = {
    'memory_lookup_fused': (flops.memory_lookup_fused_flops, jax_flops.memory_lookup_fused_flops,
                            (1000, 2048, 128), (1000, 2000, 64),
                            (_pad(2000, 128) * _pad(64, 128)) / (2000 * 64)),
    'bucket_threshold': (flops.bucket_threshold_flops, jax_flops.bucket_threshold_flops,
                         (2, 512, 1024, 128), (2, 500, 1000, 64),
                         (512 * 1024 * 128) / (500 * 1000 * 64)),
    'masked_attend': (flops.masked_attend_flops, jax_flops.masked_attend_flops,
                      (2, 512, 1024, 128, False, True), (2, 500, 1000, 64, False, True),
                      (512 * 1024 * 128) / (500 * 1000 * 64)),
    'memory_recon': (flops.memory_recon_flops, jax_flops.memory_recon_flops,
                     (4096, 2048, 128, True), (4096, 2000, 64, True),
                     (2048 * 128) / (2000 * 64)),
}


@pytest.mark.parametrize('name', sorted(FORMULAS))
def test_formulas_equal_jax(name):
    port, jax_fn, padded, unpadded, ratio = FORMULAS[name]
    assert port(*padded) == jax_fn(*padded)
    assert math.isclose(port(*unpadded) * ratio, jax_fn(*unpadded), rel_tol=1e-12)
    if name == 'masked_attend':
        for shared in (False, True):
            for with_bwd in (False, True):
                args = (2, 512, 1024, 128, shared, with_bwd)
                assert port(*args) == jax_fn(*args)
    if name == 'memory_recon':
        assert port(4096, 2048, 128, False) == jax_fn(4096, 2048, 128, False)


def _attend_inputs(rng, b, v, n, c):
    pillars = torch.from_numpy(rng.normal(size=(b, v, c)).astype(np.float32))
    table = torch.from_numpy(rng.normal(size=(b, n, c)).astype(np.float32))
    vals = torch.from_numpy(rng.normal(size=(b, n, c)).astype(np.float32))
    neg = torch.zeros(b, n)
    neg[0, -5:] = -1e30
    row_mask = torch.from_numpy(rng.random((b, v)) < 0.8)
    return pillars, table, vals, neg, row_mask


def _reports(fn):
    with flops.Counter() as c:
        fn()
    return {k: e['ops'] for k, e in c.kernels.items()}


@pytest.mark.parametrize('name', sorted(FORMULAS))
def test_wrapper_report_under_formula(name):
    """What a wrapper reports for one call is at most its formula's value
    for that call (it counts only the rows and points these inputs need)."""
    rng = np.random.default_rng(0)
    if name == 'memory_lookup_fused':
        r, m, c = 96, 300, 32
        pillars = torch.from_numpy(rng.normal(size=(r, c)).astype(np.float32))
        memory = torch.from_numpy(rng.normal(size=(m, c)).astype(np.float32))
        got = _reports(lambda: memory_lookup.memory_lookup_fused(
            pillars, memory, 20, torch.from_numpy(rng.random(r) < 0.7)))
        assert 0 < got['memory_lookup'] <= flops.memory_lookup_fused_flops(r, m, c)
        return
    if name == 'memory_recon':
        r, m, c = 200, 64, 16
        rows = torch.from_numpy(rng.normal(size=(r, c)).astype(np.float32)).requires_grad_()
        weight = torch.from_numpy(rng.normal(size=(m, c)).astype(np.float32)).requires_grad_()
        got = _reports(lambda: torch.autograd.grad(
            memory_recon.memory_recon(rows, weight, 0.0025).sum(), (rows, weight)))
        assert 0 < got['memory_recon_fwd'] <= flops.memory_recon_flops(r, m, c, False)
        assert 0 < got['memory_recon_bwd'] <= flops.memory_recon_flops(r, m, c, True)
        return
    b, v, n, c = 2, 40, 300, 16
    pillars, table, vals, neg, row_mask = _attend_inputs(rng, b, v, n, c)
    th = topk_attend.bucket_threshold(pillars, table, neg, 8, row_mask)
    if name == 'bucket_threshold':
        got = _reports(lambda: topk_attend.bucket_threshold(pillars, table, neg, 8, row_mask))
        assert 0 < got['bucket_threshold'] <= flops.bucket_threshold_flops(b, v, n, c)
        return
    for shared in (True, False):
        val = (table if shared else vals).clone().requires_grad_()
        sel = val if shared else table
        got = _reports(lambda: torch.autograd.grad(
            topk_attend.masked_attend(pillars, sel, val, neg, th, row_mask).sum(), val))
        assert 0 < got['masked_attend_fwd'] <= flops.masked_attend_flops(b, v, n, c, shared,
                                                                         False)
        assert 0 < got['masked_attend_bwd'] <= flops.masked_attend_flops(b, v, n, c, shared,
                                                                         True)


def test_memory_lookup_counts_its_work_exactly():
    """Under a counter the lookup adds exactly its data-dependent work (the
    valid rows' logits, 2C flops a selected column), none of its plain
    version's own matmuls; outside a counter it reports nothing."""
    rng = np.random.default_rng(1)
    r, m, c, k = 80, 256, 32, 20
    pillars = torch.from_numpy(rng.normal(size=(r, c)).astype(np.float32))
    memory = torch.from_numpy(rng.normal(size=(m, c)).astype(np.float32))
    row_mask = torch.from_numpy(rng.random(r) < 0.6)
    _, _, selected = memory_lookup.memory_lookup_fused(pillars, memory, k, row_mask,
                                                       return_stats=True)
    want = flops.memory_lookup_work(r, int(row_mask.sum()), m, c, float(selected.sum()))
    with flops.Counter() as counter:
        out = memory_lookup.memory_lookup_fused(pillars, memory, k, row_mask)
    assert counter.flops == want.ops and counter.bytes == want.nbytes
    assert counter.kernels == {'memory_lookup': {'calls': 1, 'ops': want.ops,
                                                 'bytes': want.nbytes, 'rate': 'bf16',
                                                 'dmma_ops': want.dmma_ops}}
    torch.testing.assert_close(out, memory_lookup.memory_lookup_plain(pillars, memory, k,
                                                                      row_mask),
                               rtol=0, atol=0)
    assert flops.counter is None
    memory_lookup.memory_lookup_fused(pillars, memory, k, row_mask)
    assert counter.kernels['memory_lookup']['calls'] == 1


class _PlaneOps(TorchDispatchMode):
    """Counts the float (N, M)-sized results of the plain rotated IoU's
    arithmetic ops (add, sub, mul, div, maximum, minimum, clamp)."""
    ARITH = {'add', 'sub', 'rsub', 'mul', 'div', 'maximum', 'minimum', 'clamp', 'clamp_min'}

    def __init__(self, plane):
        super().__init__()
        self.plane, self.ops = plane, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if (func.overloadpacket.__name__ in self.ARITH and isinstance(out, torch.Tensor)
                and out.is_floating_point() and out.numel() == self.plane):
            self.ops += 1
        return out


@pytest.mark.parametrize('iou', [False, True])
def test_rotated_iou_work_is_the_plain_arithmetic(iou):
    """K13's work is the pairs times the plain version's operations on its
    (N, M) planes (N = 3, M = 11: no per-box tensor has N M elements) and
    the plane's and the boxes' records' bytes; under a counter the wrapper
    reports it, on the CPU too, and none of the plain version's own ops."""
    from hvpr_tpu_torch.ops import rotated_iou
    rng = np.random.default_rng(4)
    boxes = [torch.from_numpy(np.concatenate([rng.uniform(-3, 3, (k, 3)),
                                              rng.uniform(1, 3, (k, 3)),
                                              rng.uniform(-3, 3, (k, 1))], 1).astype(np.float32))
             for k in (3, 11)]
    plain = rotated_iou.boxes_iou_bev_plain if iou else rotated_iou.boxes_overlap_bev_plain
    with _PlaneOps(3 * 11) as mode:
        want = plain(*boxes)
    assert mode.ops == (flops.ROTATED_IOU_OPS if iou else flops.ROTATED_OVERLAP_OPS)
    work = flops.rotated_iou_work(3, 11, iou)
    assert work == flops.Work(mode.ops * 33.0, 4.0 * 33 + 84.0 * 14, 'f32')
    fn = rotated_iou.boxes_iou_bev if iou else rotated_iou.boxes_overlap_bev
    with flops.Counter() as counter:
        got = fn(*boxes)
    assert counter.flops == work.ops and counter.bytes == work.nbytes
    assert counter.kernels == {'rotated_iou': {'calls': 1, 'ops': work.ops,
                                               'bytes': work.nbytes, 'rate': 'f32',
                                               'dmma_ops': 0.0}}
    assert torch.equal(got, want)


def test_conv_bytes_and_view():
    """A conv2d counts its input, weight, bias and output once and the
    full-tap flops; a view moves nothing."""
    x, w, bias = torch.randn(2, 16, 32, 32), torch.randn(32, 16, 3, 3), torch.randn(32)
    out, fl, nbytes = flops.count(torch.nn.functional.conv2d, x, w, bias, padding=1)
    assert fl == 2 * 2 * 32 * 32 * 32 * 16 * 9
    assert nbytes == flops.tensor_bytes(x, w, bias, out) == jax_flops.tensor_bytes(
        *(t.numpy() for t in (x, w, bias, out)))
    _, fl, nbytes = flops.count(lambda: x.view(2, 16, 1024).transpose(1, 2))
    assert fl == 0 and nbytes == 0


def _in_bounds_taps(size, kernel, stride, pad, out):
    return sum(sum(1 for t in range(kernel) if 0 <= o * stride - pad + t < size)
               for o in range(out))


@pytest.fixture(scope='module')
def mini_pair():
    pair = Pair(mini_cfg(), batch=1)
    jout = pair.jnet.module.apply(pair.jnet.variables, pair.jax_batch(), train=False)
    return pair, jout


@pytest.mark.parametrize('stage, keys', [
    ('backbone_2d', ('spatial_features', 'spatial_scale_features')),
    ('dense_head', ('spatial_features_2d',)),
])
def test_stage_flops_against_xla(mini_pair, stage, keys):
    pair, jout = mini_pair
    inputs = {k: jout[k] for k in keys}
    jitted = jax.jit(lambda bd: pair.jnet.module.apply(
        pair.jnet.variables, bd, False, method=lambda m, bd, train: getattr(m, stage)(bd, train)))
    xla_fl, _ = jax_flops.xla_cost(jitted.lower(inputs).compile())
    module = getattr(pair.tnet.module, stage)
    convs = []
    hooks = [m.register_forward_hook(lambda m, a, o: convs.append((m, a[0].shape, o.shape)))
             for m in module.modules() if isinstance(m, torch.nn.Conv2d | torch.nn.ConvTranspose2d)]
    try:
        with torch.no_grad():
            out, fl, _ = flops.count(module, {k: to_torch(v) for k, v in inputs.items()})
    finally:
        for h in hooks:
            h.remove()
    full = in_bounds = out_elements = 0
    for m, (b, ci, h, w), osh in convs:
        kh, kw = m.kernel_size
        if isinstance(m, torch.nn.ConvTranspose2d):
            # stride = kernel here: every tap lands inside the output
            assert m.stride == m.kernel_size and m.padding == (0, 0)
            taps = 2 * b * ci * h * w * m.out_channels * kh * kw
            full, in_bounds = full + taps, in_bounds + taps
        else:
            per = 2 * b * m.out_channels * ci // m.groups
            full += per * osh[2] * osh[3] * kh * kw
            in_bounds += (per * _in_bounds_taps(h, kh, m.stride[0], m.padding[0], osh[2])
                          * _in_bounds_taps(w, kw, m.stride[1], m.padding[1], osh[3]))
        out_elements += math.prod(osh)
    if stage == 'dense_head':
        # the three 1x1 convs run as one matmul over the (B, H, W, C) map
        b, h, w, _ = inputs['spatial_features_2d'].shape
        head = pair.tnet.module.dense_head
        convs_1x1 = [head.conv_cls, head.conv_box, head.conv_dir_cls]
        full = in_bounds = sum(2 * b * h * w * cv.weight.numel() for cv in convs_1x1)
        out_elements = sum(b * h * w * cv.out_channels for cv in convs_1x1)
    assert fl == full > 0
    assert 0 <= xla_fl - in_bounds <= 16 * out_elements, (xla_fl, in_bounds, out_elements)


STAGE_KEYS = ('stage', 'cum_ms', 'stage_ms', 'stage_gflop', 'stage_gb', 'mfu', 'hbm_frac',
              'bound', 'cum_mfu')
TRAIN_KEYS = ('stage', 'cum_ms', 'stage_ms', 'stage_gflop', 'mfu', 'hbm_frac', 'bound')
REGION_KEYS = ('stage', 'ms', 'gflop', 'gb', 'mfu', 'hbm_frac', 'bound')
# each tool: its stage names (the JAX record's, or the JAX tool's printout,
# at hvpr_mini.yaml's sizes) and the keys of its rows
TOOLS = {
    'profile_stages': (profile_stages, ['voxelize', '+vfe', '+map_to_bev', '+backbone_2d',
                                        '+dense_head', 'full+post'], STAGE_KEYS),
    'profile_train_stages': (profile_train_stages, ['backbone_3d', 'vfe', 'map_to_bev',
                                                    'backbone_2d', 'full'], TRAIN_KEYS),
    'profile_post': (profile_post, ['sigmoid+thresh', 'top_k', 'gather boxes', 'iou',
                                    'suppress loop', 'compaction', 'nms_bev_fixed'],
                     REGION_KEYS),
    'profile_head': (profile_head, ['assign_targets', 'head fwd+bwd (dual path)',
                                    'head convs only', 'optimizer update'], REGION_KEYS),
    'profile_pn2': (profile_pn2, ['fps 16384->64 (1 chunks)',
                                  'ball_query r=0.4 ns=8 (16384->64)',
                                  'ball_query r=0.8 ns=8 (16384->64)',
                                  'ball_query_msg r=(0.4, 0.8) ns=(8, 8) (one sweep)',
                                  'group_points (64x8, C=16)', 'shared_mlp (64x8, 4->16)',
                                  'three_nn (16384 from 64)', 'backbone fwd',
                                  'backbone fwd+bwd'], REGION_KEYS),
    'profile_lookup': (profile_lookup, ['full fused lookup', 'plain', 'sdpa yardstick'],
                       REGION_KEYS),
    'profile_train': (profile_train, None, ('metric', 'value', 'unit', 'batch',
                                            'scans_per_sec')),
}


@pytest.mark.parametrize('name', sorted(TOOLS))
def test_profiler_record_on_cpu(name):
    """Each profiler's ``run`` at hvpr_mini.yaml, batch 1, on the CPU (the
    train profilers at the mini tests' 2,048 points a scan): the JAX
    record's stage names and keys, device metrics null, counts >= 0."""
    module, stages, keys = TOOLS[name]
    points = {'n_points': 2048} if name in ('profile_train_stages', 'profile_train') else {}
    with torch.random.fork_rng():
        rec = module.run(mini_cfg(), batch=1, device='cpu', iters=1, **points)
    assert rec['device'] == 'cpu' and rec['peak_tflops_bf16'] is None
    rows = [rec] if stages is None else rec['stages']
    if stages is not None:
        assert [r['stage'] for r in rows] == stages
    for row in rows:
        assert set(keys) <= set(row), (keys, sorted(row))
        assert row.get('mfu', None) is None and row.get('hbm_frac', None) is None
    if name == 'profile_stages':
        assert rec['pipeline_mfu'] is None
        gflop = {r['stage']: r['stage_gflop'] for r in rows}
        assert gflop['+backbone_2d'] > 0 and gflop['+dense_head'] > 0
        assert rec['kernels']['segment_sweep']['calls'] == 3
        assert rec['kernels']['memory_lookup']['calls'] == 1
        assert rec['kernels']['bev_canvas']['calls'] == 2
    if name in ('profile_train_stages', 'profile_train'):
        assert rec.get('train_step_mfu', None) is None
        assert {k: v['calls'] for k, v in rec['kernels'].items()} == {
            'ball_query': 2, 'fps_chunks': 2, 'memory_recon_fwd': 1, 'memory_recon_bwd': 1,
            'bucket_threshold': 1, 'masked_attend_fwd': 1, 'masked_attend_pairs': 1,
            'masked_attend_bwd': 2, 'gather_grad': 4}
