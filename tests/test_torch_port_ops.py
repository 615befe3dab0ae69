"""Port ops vs the JAX package on the CPU: voxelizer, segment sweep (K1),
memory lookup (K2), BEV canvas (K3), rotated IoU and NMS.

The JAX side runs its Pallas kernels in interpret mode, as its own tests do;
the port's wrappers take their plain versions because the tensors lie on the
CPU. Inputs come from numpy with a fixed seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hvpr_tpu.ops.bev_canvas import canvas_from_sorted as jax_canvas
from hvpr_tpu.ops.memory_lookup import memory_lookup_fused as jax_lookup
from hvpr_tpu.ops.nms import nms_bev_fixed as jax_nms
from hvpr_tpu.ops.rotated_iou import boxes_iou3d as jax_iou3d
from hvpr_tpu.ops.rotated_iou import boxes_iou_bev as jax_iou_bev
from hvpr_tpu.ops.scatter import scatter_to_bev as jax_scatter
from hvpr_tpu.ops.segment_sweep import segment_sweep_pallas
from hvpr_tpu.ops.voxelizer import voxelize_batch_flat as jax_voxelize

from hvpr_tpu_torch.ops.bev_canvas import canvas_from_sorted
from hvpr_tpu_torch.ops.memory_lookup import memory_lookup_fused
from hvpr_tpu_torch.ops.nms import nms_bev_fixed
from hvpr_tpu_torch.ops.rotated_iou import boxes_iou3d, boxes_iou_bev
from hvpr_tpu_torch.ops.segment_sweep import segment_sweep
from hvpr_tpu_torch.ops.voxelizer import voxelize_batch_flat


# ------------------------------------------------------------------ voxelizer

@pytest.mark.parametrize('max_voxels', [400, 60])
def test_voxelizer_matches_jax_exactly(max_voxels):
    """Integer outputs equal and the sorted float rows equal, bit for bit;
    max_voxels=60 overflows the pillar slots so the cap path runs too."""
    rng = np.random.default_rng(max_voxels)
    b, n = 3, 700
    pcr = (0.0, -4.0, -3.0, 8.0, 4.0, 1.0)
    vs = (0.5, 0.5, 4.0)
    grid = (16, 16, 1)
    pts = np.zeros((b, n, 4), np.float32)
    pts[..., 0] = rng.uniform(-1.0, 9.0, (b, n))      # some out of range
    pts[..., 1] = rng.uniform(-5.0, 5.0, (b, n))
    pts[..., 2] = rng.uniform(-3.5, 1.5, (b, n))
    pts[..., 3] = rng.uniform(0, 1, (b, n))
    pts[:, :80, :3] = [0.2, -3.8, -1.0]                # 80 points, pillar 0
    pts[:, 80:120, :3] += rng.normal(0, 1e-3, (b, 40, 3)).astype(np.float32)
    mask = rng.uniform(size=(b, n)) > 0.1
    mask[2] = False                                    # an empty sample

    kw = dict(max_voxels=max_voxels, max_points_per_voxel=32,
              grid_size_static=grid)
    want = jax_voxelize(jnp.asarray(pts), jnp.asarray(mask), pcr, vs, **kw)
    got = voxelize_batch_flat(torch.from_numpy(pts), torch.from_numpy(mask),
                              pcr, vs, **kw)
    for key in ('flat_slot', 'flat_write', 'voxel_coords', 'voxel_num_points',
                'voxel_mask'):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    np.testing.assert_array_equal(got['flat_points'].numpy(),
                                  np.asarray(want['flat_points']))
    assert got['voxel_num_points'].max() == 32


# -------------------------------------------------------------- segment sweep

def _flat_layout(rng, r, max_seg, n_slots):
    """Contiguous segments of 1..max_seg rows (several of exactly max_seg),
    sentinel gaps, and a sentinel tail standing for empty samples."""
    slot = np.full(r, n_slots, np.int32)
    write = np.zeros(r, bool)
    pos, sid = 0, 0
    while pos < r - 200 and sid < n_slots:
        pos += rng.integers(0, 3)
        seg = max_seg if sid % 5 == 0 else rng.integers(1, max_seg + 1)
        end = min(pos + seg, r - 200)
        slot[pos:end] = sid
        write[pos:end] = True
        pos, sid = end, sid + 1
    return slot, write


# max_seg 32 (the shipped configs) keeps its cases' ids; 8 (hvpr_mini.yaml),
# 20 (nuScenes) and 64 (the wrapper's limit) add theirs
_SWEEP_CASES = [pytest.param(c, op, m, id=f'{c}-{op}' + ('' if m == 32 else f'-seg{m}'))
                for m in (32, 8, 20, 64) for c in (4, 16) for op in ('max', 'sum')]


@pytest.mark.parametrize('c,op,max_seg', _SWEEP_CASES)
def test_segment_sweep_matches_pallas(c, op, max_seg):
    """max is exact; sum is reassociated (the Pallas kernel and the plain
    version add in different orders), so it agrees to f32 rounding of
    sums over <= 2 * max_seg - 1 terms: rtol 1e-6 of the row, atol 1e-6 of
    the largest."""
    rng = np.random.default_rng(c)
    r = 3000
    slot, write = _flat_layout(rng, r, max_seg, r // 4)
    x = rng.normal(size=(c, r)).astype(np.float32) * 10
    x = np.where(write[None, :], x, -1e9 if op == 'max' else 0.0).astype(np.float32)
    want = np.asarray(segment_sweep_pallas(jnp.asarray(x), jnp.asarray(slot),
                                           max_seg, op, block=512, interpret=True))
    got = segment_sweep(torch.from_numpy(x), torch.from_numpy(slot), max_seg, op).numpy()
    if op == 'max':
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())


# -------------------------------------------------------------- memory lookup

# Tolerance: both sides round inputs and weights to bf16 and share the
# threshold rule; the JAX kernels accumulate logits and sum(e) in f32 and the
# port in f64 rounded once, a difference of f32 ulps. Where that moves one
# bf16 weight by an ulp, the output moves by <= 2^-8 of that weight times a
# memory row (|row| < 1/8 here): atol 1e-4, rtol 1e-2.
ML_TOL = dict(rtol=1e-2, atol=1e-4)


def _lookup_pair(pillars, memory, k):
    want = np.asarray(jax_lookup(jnp.asarray(pillars), jnp.asarray(memory), k=k,
                                 interpret=True))
    got = memory_lookup_fused(torch.from_numpy(pillars),
                              torch.from_numpy(memory), k).numpy()
    return got, want


def test_memory_lookup_matches_pallas():
    rng = np.random.default_rng(7)
    pillars = rng.normal(size=(300, 64)).astype(np.float32)
    memory = (rng.uniform(-1, 1, (500, 64)) / 8).astype(np.float32)
    got, want = _lookup_pair(pillars, memory, 20)
    np.testing.assert_allclose(got, want, **ML_TOL)


def test_memory_lookup_ties():
    """Duplicate memory rows give duplicate bucket maxima: the threshold is
    the k-th largest counting ties, in both packages."""
    rng = np.random.default_rng(3)
    base = (rng.uniform(-1, 1, (32, 64)) / 8).astype(np.float32)
    memory = np.tile(base, (8, 1))                    # each row 8 times
    pillars = rng.normal(size=(64, 64)).astype(np.float32)
    got, want = _lookup_pair(pillars, memory, 20)
    np.testing.assert_allclose(got, want, **ML_TOL)
    _, thresh, count = memory_lookup_fused(torch.from_numpy(pillars),
                                           torch.from_numpy(memory), 20,
                                           return_stats=True)
    assert (count >= 20).all()


def test_memory_lookup_all_zero_rows():
    """All-zero pillars: every logit ties at 0; finite, equal outputs."""
    memory = np.random.default_rng(0).uniform(-1, 1, (256, 64)).astype(np.float32)
    pillars = np.zeros((8, 64), np.float32)
    got, want = _lookup_pair(pillars, memory, 20)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **ML_TOL)


# ----------------------------------------------------------------- BEV canvas

NY, NX = 24, 40


def _sorted_pillars(rng, b, v, c, n_valid):
    feat = rng.normal(size=(b, v, c)).astype(np.float32) * 10
    coords = np.zeros((b, v, 3), np.int32)
    mask = np.zeros((b, v), bool)
    for i, nv in enumerate(n_valid):
        cells = np.sort(rng.choice(NY * NX, nv, replace=False))
        coords[i, :nv, 1] = cells // NX
        coords[i, :nv, 2] = cells % NX
        mask[i, :nv] = True
    return feat, coords, mask


@pytest.mark.parametrize('dtype', ['fp32', 'bf16'])
def test_canvas_matches_pallas(dtype):
    """bf16: exact (both cast the rows, then copy). f32: the port is exact
    against the JAX scatter; the Pallas kernel rebuilds f32 from two bf16
    halves, ~2^-17 relative (rtol 2e-5, as its own test states)."""
    rng = np.random.default_rng(1)
    feat, coords, mask = _sorted_pillars(rng, 2, 512, 32, [500, 17])
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == 'fp32'
                else (jnp.bfloat16, torch.bfloat16))
    want = jax_canvas(jnp.asarray(feat), jnp.asarray(coords), jnp.asarray(mask),
                      NY, NX, interpret=True, out_dtype=jdt)
    got = canvas_from_sorted(torch.from_numpy(feat), torch.from_numpy(coords),
                             torch.from_numpy(mask), NY, NX, tdt)
    assert got.dtype == tdt and got.shape == (2, NY, NX, 32)
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    if dtype == 'bf16':
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-4)
        exact = np.asarray(jax_scatter(jnp.asarray(feat), jnp.asarray(coords),
                                       jnp.asarray(mask), NY, NX))
        np.testing.assert_array_equal(got, exact)


# ---------------------------------------------------------- rotated IoU / NMS

def _boxes(rng, n):
    b = np.zeros((n, 7), np.float32)
    b[:, 0:2] = rng.uniform(0, 12, (n, 2))
    b[:, 2] = rng.uniform(-1.5, -0.5, n)
    b[:, 3:6] = rng.uniform([2.0, 1.0, 1.2], [4.5, 2.0, 1.8], (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    b[:5] = b[5:10]                                     # coincident pairs
    b[10:15, 6] = 0.0                                   # axis-aligned
    b[15:20] = b[10:15]
    b[15:20, 0] += b[15:20, 3]                          # abutting edges
    return b


def test_rotated_iou_matches_jax():
    """Same Green's-theorem algorithm in f32: agreement to f32 rounding."""
    rng = np.random.default_rng(5)
    a, b = _boxes(rng, 60), _boxes(rng, 40)
    for jf, tf in ((jax_iou_bev, boxes_iou_bev), (jax_iou3d, boxes_iou3d)):
        want = np.asarray(jf(jnp.asarray(a), jnp.asarray(b)))
        got = tf(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('n', [0, 1, 60])
def test_box_records_are_the_corners_half_planes_and_areas(n):
    """The plain records that kernel K13's are held to on the card: each
    box's corners, its half-planes (ux y - uy x + c positive inside) and
    dx * dy, for any number of boxes, none included."""
    from hvpr_tpu_torch.ops.rotated_iou import box_records, box_to_corners_bev, half_planes
    boxes = torch.from_numpy(_boxes(np.random.default_rng(6), 60)[:n])
    rec = box_records(boxes)
    assert rec.shape == (n, 21) and rec.dtype == torch.float32
    corners = box_to_corners_bev(boxes[:, [0, 1, 3, 4, 6]])
    ux, uy, c = half_planes(corners)
    assert torch.equal(rec[:, :8], corners.reshape(n, 8))
    assert torch.equal(rec[:, 8:20], torch.cat([ux, uy, c], dim=1))
    assert torch.equal(rec[:, 20], boxes[:, 3] * boxes[:, 4])
    centre = boxes[:, None, :2]
    inside = ux * centre[..., 1] - uy * centre[..., 0] + c
    assert bool((inside > 0).all())


def test_nms_kept_set_matches_jax():
    """Kept indices equal exactly, including tied scores (lower index
    first) and -inf rows that must neither suppress nor survive."""
    rng = np.random.default_rng(9)
    boxes = _boxes(rng, 300)
    scores = rng.uniform(0, 1, 300).astype(np.float32)
    scores[20:40] = 0.5                                 # ties
    scores[::7] = -np.inf
    ki, km, nk = jax_nms(jnp.asarray(boxes), jnp.asarray(scores), 0.1,
                         pre_maxsize=256, post_maxsize=64, stage1=256)
    gi, gm, gk = nms_bev_fixed(torch.from_numpy(boxes), torch.from_numpy(scores),
                               0.1, pre_maxsize=256, post_maxsize=64)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(km))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ki))
    assert int(gk) == int(nk) and int(gk) > 0


def test_memory_lookup_row_mask():
    """Masked rows output zeros (and zero stats); the others are the
    unmasked result, row for row."""
    rng = np.random.default_rng(11)
    pillars = torch.from_numpy(rng.normal(size=(50, 32)).astype(np.float32))
    memory = torch.from_numpy((rng.uniform(-1, 1, (300, 32)) / 6).astype(np.float32))
    mask = torch.from_numpy(rng.uniform(size=50) > 0.4)
    full = memory_lookup_fused(pillars, memory, 8, return_stats=True)
    part = memory_lookup_fused(pillars, memory, 8, mask, return_stats=True)
    for f, p in zip(full, part):
        assert torch.equal(p[mask], f[mask])
        assert (p[~mask] == 0).all()


def test_memory_exact_mode_matches_flax():
    """TOPK_MODE=exact: torch.topk vs lax.top_k over f32 logits, the
    aggregation in bf16 on both sides (atol 2e-3: bf16 rounding of the
    weights and of the sum, |memory| <= 1/8)."""
    from hvpr_tpu.models.backbones_2d.map_to_bev.memory_module import (
        MemoryUnitAgg as JaxMemory)
    from hvpr_tpu_torch.models.backbones_2d.map_to_bev.memory_module import (
        MemoryUnitAgg)
    rng = np.random.default_rng(4)
    pillars = rng.normal(size=(2, 40, 32)).astype(np.float32)
    jmod = JaxMemory(mem_dim=200, fea_dim=32)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(pillars), 8)
    want = jmod.apply(variables, jnp.asarray(pillars), 8, 'exact',
                      method=jmod.eval_forward)['output']
    mod = MemoryUnitAgg(200, 32)
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(np.asarray(variables['params']['weight'])))
        got = mod.eval_forward(torch.from_numpy(pillars), 8, 'exact')['output']
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-3)


def test_scans_match_bench():
    """The port's scan generators draw like bench.py's: same seed, same scans."""
    import bench
    from hvpr_tpu_torch.utils import scans
    pcr = (0.0, -19.84, -2.5, 47.36, 19.84, 0.5)
    for name in ('realistic_scans', 'synthetic_scans'):
        want = getattr(bench, name)(np.random.default_rng(3), 2, 12000, pcr)
        got = getattr(scans, name)(np.random.default_rng(3), 2, 12000, pcr)
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ kernel table

def test_kernel_table_is_the_only_list_of_sources():
    """Every csrc/*.cu is the source of a declared kernel, and every source
    the table declares exists."""
    from pathlib import Path
    from hvpr_tpu_torch.ops import _kernels
    csrc = Path(__file__).resolve().parent.parent / 'hvpr_tpu_torch' / 'csrc'
    on_disk = {p.stem for p in csrc.glob('*.cu')}
    declared = {e.source for e in _kernels.ENTRIES.values()}
    assert {e.source for e in _kernels.ENTRIES.values() if e.counts} == on_disk
    assert declared == on_disk == set(_kernels.SOURCES)


def test_kernel_table_is_the_only_list_of_kernels():
    """KERNELS, the launch counts' keys and chip_smoke's table of the TPU
    kernels each kernel replaces name the same kernels."""
    import chip_smoke
    from hvpr_tpu_torch.ops import _kernels
    assert list(_kernels.launch_counts()) == list(_kernels.KERNELS)
    assert set(_kernels.KERNELS) == set(chip_smoke.META)
    assert all(_kernels.ENTRIES[k].counts == k for k in _kernels.KERNELS)


def _rulebook_call():
    from hvpr_tpu_torch.ops.sparse_conv import tap_rulebook
    cells = torch.tensor([[0, 0, 1], [0, 1, 1], [1, 2, 3], [3, 3, 0]], dtype=torch.int32)
    lin = (cells[:, 0] * 16 + cells[:, 1] * 4 + cells[:, 2]).long()
    return lambda: tap_rulebook(lin[None], cells[None], torch.ones(1, 4, dtype=torch.bool),
                                (3, 3, 3), True, (4, 4, 4))


def _canvas_call():
    coords = torch.zeros(1, 8, 3, dtype=torch.int32)
    coords[0, :, 2] = torch.arange(8, dtype=torch.int32)
    return lambda: canvas_from_sorted(torch.randn(1, 8, 16), coords,
                                      torch.ones(1, 8, dtype=torch.bool), 1, 8)


INFERENCE_CALLS = {
    'segment_sweep': lambda: (lambda: segment_sweep(
        torch.randn(4, 64), torch.arange(64, dtype=torch.int32), 32, 'max')),
    'memory_lookup': lambda: (lambda: memory_lookup_fused(
        torch.randn(100, 16), torch.randn(40, 16), 4)),
    'bev_canvas': _canvas_call,
    'rotated_iou': lambda: (lambda: boxes_iou_bev(*[torch.rand(6, 7)] * 2)),
    'sparse_rulebook': _rulebook_call,
}


@pytest.mark.parametrize('name', sorted(INFERENCE_CALLS))
def test_inference_wrapper_reports_under_its_table_name(name):
    """Under a flops.Counter on the CPU, one call of an inference wrapper
    (K1, K2, K3, K13, K14) is one report under its kernel's table name."""
    from hvpr_tpu_torch.ops import _kernels
    from hvpr_tpu_torch.utils import flops
    call = INFERENCE_CALLS[name]()
    with flops.Counter() as counter:
        call()
    assert name in _kernels.KERNELS
    assert {k: v['calls'] for k, v in counter.kernels.items()} == {name: 1}
