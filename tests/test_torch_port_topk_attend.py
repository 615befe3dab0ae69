"""The port's top-k-masked attention (K8-K10's plain versions) and the fused
train mode against the JAX package, on the CPU.

Inputs come from numpy seeds and go to both packages unchanged. The JAX side
runs its XLA twin (``bucket_threshold``'s XLA branch, ``_attend_emulation``)
and, for the threshold, its Pallas kernels in interpret mode.

Tolerances and why:
- thresholds on bf16-exact inputs (multiples of 1/8, as in
  tests/test_topk_attend.py): exactly equal, since every score is then an
  exact sum in f32 and in f64 alike. On random inputs at C = 64 the JAX
  package's f32 sums differ from the port's f64 sums by f32 ulps: rtol 1e-5.
- the aggregation (forward) and dval: each side with its own threshold, so
  the point that defines it is selected on both. The weights are rounded to
  bf16 before the value product, and an f32-ulp difference in a weight (den
  summed in f32 vs f64) can flip that rounding: 2^-8 of one term. rtol and
  atol 1e-2 of the largest value, the tolerance tests/test_topk_attend.py
  holds the Pallas kernels to. dval is itself rounded to bf16 on both sides.
- the module, fused against the JAX module's fused mode: the memory path
  adds the reconstruction's bf16 roundings (tests/test_torch_port_train_ops.py
  holds it to 2e-3): rtol and atol 2e-2, as the JAX package holds its fused
  mode to its gather mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hvpr_tpu.models.backbones_2d.map_to_bev.pointpillar_scatter import (
    PointPillarScatterAggMemory1Scale as JaxScatter)
from hvpr_tpu.ops import topk_attend as jax_ta

from hvpr_tpu_torch.models.backbones_2d.map_to_bev.pointpillar_scatter import (
    PointPillarScatterAggMemory1Scale as PortScatter)
from hvpr_tpu_torch.ops import topk_attend as port_ta

from torch_port_helpers import load_cfg

RTOL = 1e-2


def _t(x):
    return torch.from_numpy(np.array(x))


def _quantized(rng, shape):
    """bf16-exact values: multiples of 1/8 in [-4, 4)."""
    return (rng.integers(-32, 32, size=shape) / 8.0).astype(np.float32)


def _inputs(rng, b, v, n, c, quantized):
    """Pillars, selection table, value table and neg: the last 37 points of
    scan 0 are padding; a zero pillar row (all-tie) sits at row 1."""
    make = (lambda s: _quantized(rng, s)) if quantized else \
        (lambda s: rng.normal(size=s).astype(np.float32))
    pillars, points, vals = make((b, v, c)), make((b, n, c)), make((b, n, c))
    pillars[0, 1] = 0.0
    neg = np.zeros((b, n), np.float32)
    neg[0, -37:] = -1e30
    return pillars, points, vals, neg


def _all_rows(b, v):
    return torch.ones(b, v, dtype=torch.bool)


def _close(got, want, what, rtol=RTOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30), err_msg=what)


@pytest.mark.parametrize('b,v,n,c,k,quantized', [
    (2, 10, 300, 8, 4, True),          # N not a multiple of 128: padded buckets
    (2, 40, 2000, 64, 20, False)])     # hvpr.yaml's C and k
def test_bucket_threshold_matches_jax(b, v, n, c, k, quantized):
    rng = np.random.default_rng(n)
    pillars, points, _, neg = _inputs(rng, b, v, n, c, quantized)
    args = (jnp.asarray(pillars), jnp.asarray(points), jnp.asarray(neg), k)
    want_xla = np.asarray(jax_ta.bucket_threshold(*args))
    want_pallas = np.asarray(jax_ta.bucket_threshold(*args, interpret=True))
    got = port_ta.bucket_threshold(_t(pillars), _t(points), _t(neg), k,
                                   _all_rows(b, v)).numpy()
    for want in (want_xla, want_pallas):
        if quantized:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert got[0, 1] == 0.0                 # the zero row ties at 0
    mask = np.ones((b, v), bool)
    mask[:, ::3] = False
    masked = port_ta.bucket_threshold(_t(pillars), _t(points), _t(neg), k,
                                      _t(mask)).numpy()
    np.testing.assert_array_equal(masked[mask], got[mask])
    assert (masked[~mask] == 0).all()
    with pytest.raises(ValueError, match='k <= 128'):
        port_ta.bucket_threshold(_t(pillars), _t(points), _t(neg), 129, _all_rows(b, v))


def _jax_attend(pillars, sel, val, neg, k, shared, dout):
    """JAX's output and jax.grad wrt (pillars, sel, val) of sum(out * dout)."""
    pj, sj, nj = jnp.asarray(pillars), jnp.asarray(sel), jnp.asarray(neg)
    vj = sj if shared else jnp.asarray(val)
    th = jax_ta.bucket_threshold(pj, sj, nj, k)

    def loss(p, s, v_):
        out = jax_ta.masked_attend(p, s, s if shared else v_, nj, th, shared)
        return (out * dout).sum(), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        pj, sj, vj)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize('shared', [True, False])
@pytest.mark.parametrize('quantized', [True, False])
def test_masked_attend_and_grad_match_jax(shared, quantized):
    rng = np.random.default_rng(3 + shared + 2 * quantized)
    b, v, n, c, k = 2, 24, 500, 64 if not quantized else 16, 8
    pillars, points, vals, neg = _inputs(rng, b, v, n, c, quantized)
    dout = rng.normal(size=(b, v, c)).astype(np.float32)
    want, (gp, gs, gv) = _jax_attend(pillars, points, vals, neg, k, shared, dout)

    tp, tn = _t(pillars).requires_grad_(), _t(neg)
    pts = _t(points).requires_grad_()
    val = pts if shared else _t(vals).requires_grad_()
    th = port_ta.bucket_threshold(tp, pts, tn, k, _all_rows(b, v))
    out = port_ta.masked_attend(tp, pts, val, tn, th, _all_rows(b, v))
    (out * _t(dout)).sum().backward()
    _close(out.detach().numpy(), want, 'out')
    # the gradient flows to the value table only, once when it is shared
    assert np.abs(gp).max() == 0.0 and tp.grad is None
    if shared:
        _close(pts.grad.numpy(), gs + gv, 'dval (shared)')
    else:
        assert np.abs(gs).max() == 0.0 and pts.grad is None
        _close(val.grad.numpy(), gv, 'dval')
    g = val.grad.numpy()
    np.testing.assert_array_equal(g, _t(g).to(torch.bfloat16).float().numpy())


def test_masked_attend_edge_rows():
    """An empty set gives 0; a zero row weighs its valid points uniformly;
    rows outside the mask give 0 and add nothing to dval."""
    rng = np.random.default_rng(9)
    b, v, n, c, k = 3, 40, 300, 16, 4
    pillars, points, vals, neg = _inputs(rng, b, v, n, c, quantized=False)
    neg[2] = -1e30                                  # scan 2: no valid point
    mask = rng.uniform(size=(b, v)) > 0.3
    mask[0, 1] = True
    dout = rng.normal(size=(b, v, c)).astype(np.float32)
    tp, ts, tv, tn = _t(pillars), _t(points), _t(vals), _t(neg)

    every = _all_rows(b, v)
    th = port_ta.bucket_threshold(tp, ts, tn, k, every)
    out, mx, den, cnt, pidx, pw = port_ta.masked_attend_fwd(tp, ts, tv, tn, th, False,
                                                            every)
    assert (cnt[2] == 0).all() and (out[2] == 0).all() and (den[2] == 0).all()
    assert int(cnt[0, 1]) == n - 37
    out_s, *_ = port_ta.masked_attend_fwd(tp, ts, ts, tn, th, True, every)
    valid = _t(points[0, :n - 37]).to(torch.bfloat16).double()
    w = torch.tensor(1.0 / (n - 37)).to(torch.bfloat16).double()
    np.testing.assert_allclose(out_s[0, 1].numpy(), (w * valid.sum(0)).float().numpy(),
                               rtol=1e-6, atol=1e-7)

    tm = _t(mask)
    th_m = port_ta.bucket_threshold(tp, ts, tn, k, tm)
    out_m, mx_m, den_m, cnt_m, pidx_m, pw_m = port_ta.masked_attend_fwd(
        tp, ts, tv, tn, th_m, False, tm)
    assert (out_m[~tm] == 0).all() and (cnt_m[~tm] == 0).all()
    np.testing.assert_array_equal(out_m[tm].numpy(), out[tm].numpy())
    dval_m = port_ta.masked_attend_bwd(tp, ts, tv, tn, th_m, mx_m, den_m, _t(dout),
                                       False, tm, pidx_m, pw_m, cnt_m)
    dout0 = np.where(mask[..., None], dout, 0.0).astype(np.float32)
    dval0 = port_ta.masked_attend_bwd(tp, ts, tv, tn, th, mx, den, _t(dout0), False,
                                      every, pidx, pw, cnt)
    np.testing.assert_array_equal(dval_m.numpy(), dval0.numpy())


def test_selection_is_the_forward_set():
    """``selection`` yields, scan by scan, the rows inside the mask and the
    points they select: as many as the forward counts, and each row's
    threshold point among them."""
    rng = np.random.default_rng(13)
    b, v, n, c, k = 2, 30, 400, 16, 6
    pillars, points, vals, neg = (_t(x) for x in _inputs(rng, b, v, n, c, quantized=False))
    mask = _t(rng.uniform(size=(b, v)) > 0.4)
    th = port_ta.bucket_threshold(pillars, points, neg, k, mask)
    cnt = port_ta.masked_attend_fwd(pillars, points, vals, neg, th, False, mask)[3]
    seen = 0
    for bi, rows, sel in port_ta.selection(pillars, points, neg, th, mask):
        np.testing.assert_array_equal(rows.numpy(), np.flatnonzero(mask[bi].numpy()))
        assert sel.shape == (len(rows), n)
        np.testing.assert_array_equal(sel.sum(-1).numpy(), cnt[bi, rows].numpy())
        assert (sel.sum(-1) >= 1).all()
        seen += 1
    assert seen == b


# ---------------------------------------------------------------------------
# the module: TRAIN_ATTEND_MODE fused against JAX's fused mode and the
# port's gather mode
# ---------------------------------------------------------------------------


@pytest.fixture(scope='module')
def module_batch():
    """Tie-free quantized pillars and points (no tie at any pillar's k-th
    score, so the superset is the exact top-k); the last two pillar slots
    of scan 1 are empty (zero features, outside voxel_mask)."""
    rng = np.random.default_rng(11)
    b, v, n, c, cs, k = 2, 12, 128, 8, 4, 5
    ny, nx = 6, 8
    pillars = _quantized(rng, (b, v, c))
    pillars[1, -2:] = 0.0
    points = _quantized(rng, (b, n, c))
    pmask = np.ones((b, n), bool)
    pmask[1, 120:] = False
    vmask = np.ones((b, v), bool)
    vmask[1, -2:] = False
    s = np.einsum('bvc,bnc->bvn', pillars, points) + np.where(pmask, 0, -1e30)[:, None]
    srt = np.sort(s, axis=-1)[vmask]
    assert (srt[:, -k] > srt[:, -k - 1]).all(), 'reroll the fixture seed'
    cells = rng.permutation(ny * nx)[:b * v].reshape(b, v)
    coords = np.stack([np.zeros((b, v)), cells // nx, cells % nx], -1).astype(np.int32)
    batch = dict(pillar_features=pillars, pillar_scale_features=_quantized(rng, (b, v, cs)),
                 voxel_coords=coords, voxel_mask=vmask, point_features=points,
                 point_valid_mask=pmask)
    cfg = {'NUM_M': 16, 'NUM_PT_FEATURES': c, 'SHRINK_TH': 0.0025, 'NUM_K': k}
    return batch, cfg, (nx, ny, 1)


OUT_KEYS = ('spatial_features', 'spatial_features_point', 'spatial_scale_features',
            'point_positive_features', 'memory_positive_features')


def _loss_terms(out, vmask):
    m = vmask[..., None]
    return (out['spatial_features'].sum() + out['spatial_features_point'].sum()
            + (out['point_positive_features'] * m).sum()
            + (out['memory_positive_features'] * m).sum())


def _port_run(batch, cfg, grid, mode, memory_weight):
    mod = PortScatter(dict(cfg, TRAIN_ATTEND_MODE=mode), grid).train()
    with torch.no_grad():
        mod.memory.weight.copy_(_t(memory_weight))
    tb = {k: _t(v) for k, v in batch.items()}
    tb['point_features'].requires_grad_()
    out = mod(dict(tb))
    _loss_terms(out, tb['voxel_mask']).backward()
    return out, mod.memory.weight.grad.numpy(), tb['point_features'].grad.numpy()


def _jax_run(batch, cfg, grid):
    mod = JaxScatter(model_cfg=dict(cfg, TRAIN_ATTEND_MODE='fused'), grid_size=grid)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = mod.init(jax.random.PRNGKey(0), dict(jb), train=True)

    def loss(params, pts):
        out = mod.apply({'params': params}, dict(jb, point_features=pts), train=True)
        return _loss_terms(out, jb['voxel_mask']), out

    (_, out), (gparams, gpts) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        variables['params'], jb['point_features'])
    return (out, np.asarray(variables['params']['memory']['weight']),
            np.asarray(gparams['memory']['weight']), np.asarray(gpts))


def test_module_fused_matches_jax_fused(module_batch):
    batch, cfg, grid = module_batch
    jout, weight, jgw, jgp = _jax_run(batch, cfg, grid)
    out, gw, gp = _port_run(batch, cfg, grid, 'fused', weight)
    vmask = batch['voxel_mask']
    for key in OUT_KEYS:
        got, want = out[key].detach().numpy(), np.asarray(jout[key])
        if key.endswith('positive_features'):
            assert (got[~vmask] == 0).all(), key     # empty slots are skipped
            got, want = got[vmask], want[vmask]
        _close(got, want, key, rtol=2e-2)
    _close(gw, jgw, 'memory weight grad', rtol=2e-2)
    _close(gp, jgp, 'point feature grad', rtol=2e-2)


def test_module_fused_matches_port_gather(module_batch):
    batch, cfg, grid = module_batch
    weight = np.random.default_rng(1).uniform(-0.3, 0.3, (16, 8)).astype(np.float32)
    fused = _port_run(batch, cfg, grid, 'fused', weight)
    gather = _port_run(batch, cfg, grid, 'gather', weight)
    vmask = batch['voxel_mask']
    for key in OUT_KEYS:
        got, want = fused[0][key].detach().numpy(), gather[0][key].detach().numpy()
        if key.endswith('positive_features'):
            got, want = got[vmask], want[vmask]
        _close(got, want, key, rtol=2e-2)
    _close(fused[1], gather[1], 'memory weight grad', rtol=2e-2)
    _close(fused[2], gather[2], 'point feature grad', rtol=2e-2)


def test_hvpr_yaml_trains_in_fused_mode():
    """hvpr.yaml sets no TRAIN_ATTEND_MODE: the port trains in fused mode,
    as the JAX package does."""
    cfg = load_cfg('hvpr.yaml')
    assert 'TRAIN_ATTEND_MODE' not in cfg.MODEL.MAP_TO_BEV
    mod = PortScatter(cfg.MODEL.MAP_TO_BEV, (296, 248, 1))
    assert mod.train_attend_mode == 'fused'
