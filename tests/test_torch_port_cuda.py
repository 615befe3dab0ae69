"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where torch sees no CUDA device (the
kernels have no CPU form). On a machine with a card run them with
``python -m pytest tests/test_torch_port_cuda.py -q``. The kernels repeat
their plain versions' arithmetic in the same order (K1, K4, K5: products and
sums rounded one by one, no FMA contraction) or with exact f64 accumulation
(K2), or copy bytes (K3; cast to bf16 by the same rounding), so those
comparisons are exact; so is K11's (the bucketed 3-NN), indices and
distances. K6/K7 (the memory
reconstruction) and K9/K10 (the masked attention) also accumulate exact
products in f64, but a sum of f32 terms in f64 may round its last bit by
order: their float outputs are held to 1e-5 of the output's largest
magnitude; K8's thresholds (its score product on DMMA, as K9's) and K9's
selected counts, row maxima and pairs
(indices and bf16 weights) are exact, in K9's dense sweep and in its pair
pass (a call handed another call's selection). K10 reduces K9's pairs; it
is also held to the dense plain backward, which recomputes every row's
weights. K5's long path (sets above 8192 rows) is exact too. K12 (the row
gathers' deterministic backward, no TPU kernel) sums in the order of its
plain version on the CPU, so it gives those bits, and the same bits on
every run. K13 (the rotated BEV IoU, no TPU kernel) repeats its plain
version's f32 arithmetic pair by pair in its order, so its planes and the
NMS's detections are exact. K14 (a sparse conv's rulebook, no TPU kernel)
returns integers: every tap's rows and hits equal the plain per-tap
lookups', and a sparse backbone's output the plain one's bit for bit.
"""

import functools
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hvpr_tpu_torch.ops import _kernels
from hvpr_tpu_torch.ops.bev_canvas import canvas_from_sorted
from hvpr_tpu_torch.ops.memory_lookup import memory_lookup_fused
from hvpr_tpu_torch.ops.memory_recon import memory_recon, recon_backward, recon_forward
from hvpr_tpu_torch.ops.pn2_select import ball_query_bucket, fps_chunks, three_nn_bucket
from hvpr_tpu_torch.ops.rotated_iou import (box_records, boxes_iou3d, boxes_iou_bev,
                                             boxes_overlap_bev, records_on_card)
from hvpr_tpu_torch.ops.segment_sweep import segment_sweep
from hvpr_tpu_torch.ops.sparse_conv import tap_rulebook
from hvpr_tpu_torch.ops.topk_attend import (bucket_threshold, masked_attend,
                                            masked_attend_bwd, masked_attend_bwd_plain,
                                            masked_attend_fwd)
from sparse_rulebook_cases import CASES as RULEBOOK_CASES
from sparse_rulebook_cases import rulebook_case

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device; the kernels have no CPU form')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _both(fn, *args, **kwargs):
    got = fn(*args, **kwargs)
    with _kernels.plain_versions():
        want = fn(*args, **kwargs)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.parametrize('op', ['max', 'sum'])
@pytest.mark.parametrize('c', [4, 64])
def test_segment_sweep_kernel(cuda, op, c):
    rng = np.random.default_rng(c)
    r = 20000
    lengths = rng.integers(1, 33, r)
    slot = np.repeat(np.arange(r), lengths)[:r].astype(np.int32)
    slot[-500:] = r                                          # sentinel tail
    x = rng.normal(size=(c, r)).astype(np.float32)
    x[:, -500:] = -1e9 if op == 'max' else 0.0
    before = _kernels.launch_counts()['segment_sweep']
    got, want = _both(segment_sweep, torch.from_numpy(x).to(cuda),
                      torch.from_numpy(slot).to(cuda), 32, op)
    assert torch.equal(got, want)
    assert _kernels.launch_counts()['segment_sweep'] == before + 1


def _sweep_layout(rng, r, max_seg):
    """Slots of contiguous segments of 1..max_seg rows (every fourth exactly
    max_seg), sentinel rows at the start, between segments and at the end,
    and a max_seg segment across each window edge of the kernel (its output
    windows hold 512 - 2 * halo rows) and across a 16-row lane strip."""
    sentinel = r + 1000
    slot = np.full(r, sentinel, np.int32)
    pos, sid = int(rng.integers(1, 5)), 0
    while pos < r - 3:
        pos += int(rng.integers(0, 3))
        seg = max_seg if sid % 4 == 0 else int(rng.integers(1, max_seg + 1))
        end = min(pos + seg, r - 3)
        slot[pos:end] = sid
        pos, sid = end, sid + 1
    steps = int(np.ceil(np.log2(max_seg))) if max_seg > 1 else 0
    halo = ((1 << steps) - 1 + 3) // 4 * 4
    out_rows = 512 - 2 * halo
    for k, edge in enumerate([out_rows * i for i in range(1, 4)] + [16 * 7]):
        a = edge - max_seg // 2
        if a >= 1 and a + max_seg <= r - 3:
            slot[a:a + max_seg] = r + k
    return slot


@pytest.mark.parametrize('r', [37, 5003, 6144])          # below one window, R % 4 != 0
@pytest.mark.parametrize('c', [1, 4, 16, 64])
@pytest.mark.parametrize('max_seg', [8, 20, 32, 64])
@pytest.mark.parametrize('op', ['max', 'sum'])
def test_segment_sweep_kernel_edges(cuda, op, max_seg, c, r):
    """K1 equals the plain sweeps bit for bit at every max_seg the wrapper
    takes, at ragged and tiny R, with segments across window and strip
    edges, and a max segment mixing -0.0 and +0.0."""
    rng = np.random.default_rng(max_seg * 1000 + c + r)
    slot = _sweep_layout(rng, r, max_seg)
    x = rng.normal(size=(c, r)).astype(np.float32)
    x[:, slot > r + 100] = -1e9 if op == 'max' else 0.0     # sentinel rows
    # a segment of signed zeros: the first run of 2 rows or more from 2R/3 on
    cuts = np.flatnonzero(np.diff(slot)) + 1
    runs = [(a, e) for a, e in zip(np.r_[0, cuts], np.r_[cuts, r])
            if e - a >= 2 and slot[a] <= r + 100]
    a, e = next(((a, e) for a, e in runs if a >= 2 * r // 3), runs[-1])
    x[:, a:e] = np.where(np.arange(e - a) % 2, 0.0, -0.0)
    before = _kernels.launch_counts()['segment_sweep']
    got, want = _both(segment_sweep, torch.from_numpy(x).to(cuda),
                      torch.from_numpy(slot).to(cuda), max_seg, op)
    assert torch.equal(got, want)
    assert np.array_equal(got.cpu().numpy().view(np.int32), want.cpu().numpy().view(np.int32))
    assert _kernels.launch_counts()['segment_sweep'] == before + 1


@pytest.mark.parametrize('c', [4, 11, 64])
@pytest.mark.parametrize('op', ['max', 'sum'])
def test_segment_sweep_kernel_nuscenes_shapes(cuda, op, c):
    """K1 at pointpillar_nuscenes.yaml's shapes: max_seg 20 over the rows of
    a batch of 4 frames of 10 sweeps (R = 4 x 339,523, not a multiple of
    16), at the 4 and 64 channels its sweeps take and the 11 decorated
    channels of 5-channel points."""
    rng = np.random.default_rng(c + 20)
    r = 4 * 339523
    slot = _sweep_layout(rng, r, 20)
    x = rng.normal(size=(c, r)).astype(np.float32)
    x[:, slot > r + 100] = -1e9 if op == 'max' else 0.0
    before = _kernels.launch_counts()['segment_sweep']
    got, want = _both(segment_sweep, torch.from_numpy(x).to(cuda),
                      torch.from_numpy(slot).to(cuda), 20, op)
    assert torch.equal(got, want)
    assert _kernels.launch_counts()['segment_sweep'] == before + 1


@pytest.mark.parametrize('m,c,k', [(2000, 64, 20), (64, 32, 4), (300, 16, 128)])
def test_memory_lookup_kernel(cuda, m, c, k):
    rng = np.random.default_rng(m)
    pillars = torch.from_numpy(rng.normal(size=(1000, c)).astype(np.float32)).to(cuda)
    pillars[:3] = 0.0                                        # all-tie rows
    memory = torch.from_numpy((rng.uniform(-1, 1, (m, c)) / c ** 0.5)
                              .astype(np.float32)).to(cuda)
    row_mask = torch.rand(1000, device=cuda) > 0.3
    row_mask[:16] = False                                    # a whole block out
    for mask in (None, row_mask):
        got, want = _both(memory_lookup_fused, pillars, memory, k, mask,
                          return_stats=True)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('c,ny,nx', [(32, 60, 70), (8, 61, 71)])    # odd grid, 16-byte rows
def test_bev_canvas_kernel(cuda, dtype, c, ny, nx):
    rng = np.random.default_rng(0)
    b, v = 2, 3000
    feat = torch.from_numpy(rng.normal(size=(b, v, c)).astype(np.float32)).to(cuda)
    coords = torch.zeros(b, v, 3, dtype=torch.int32)
    mask = torch.zeros(b, v, dtype=torch.bool)
    for i, n in enumerate((2900, 10)):
        cells = np.sort(rng.choice(ny * nx, n, replace=False))
        coords[i, :n, 1] = torch.from_numpy(cells // nx)
        coords[i, :n, 2] = torch.from_numpy(cells % nx)
        mask[i, :n] = True
    got, want = _both(canvas_from_sorted, feat, coords.to(cuda), mask.to(cuda),
                      ny, nx, dtype)
    assert got.dtype == dtype and torch.equal(got, want)
    assert int((got[1].abs().sum(-1) > 0).sum()) == 10      # every other cell zero


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_bev_canvas_kernel_nuscenes_grid(cuda, dtype):
    """K3 at pointpillar_nuscenes.yaml's canvas: 512 x 512 cells of 64
    channels (256-byte f32 rows), 30,000 pillar slots a frame, a batch of
    4 (one frame with few pillars)."""
    rng = np.random.default_rng(512)
    b, v, c, ny, nx = 4, 30000, 64, 512, 512
    feat = torch.from_numpy(rng.normal(size=(b, v, c)).astype(np.float32)).to(cuda)
    coords = torch.zeros(b, v, 3, dtype=torch.int32)
    mask = torch.zeros(b, v, dtype=torch.bool)
    for i, n in enumerate((30000, 29000, 30000, 100)):
        cells = np.sort(rng.choice(ny * nx, n, replace=False))
        coords[i, :n, 1] = torch.from_numpy(cells // nx)
        coords[i, :n, 2] = torch.from_numpy(cells % nx)
        mask[i, :n] = True
    before = _kernels.launch_counts()['bev_canvas']
    got, want = _both(canvas_from_sorted, feat, coords.to(cuda), mask.to(cuda),
                      ny, nx, dtype)
    assert got.shape == (b, ny, nx, c) and got.dtype == dtype and torch.equal(got, want)
    assert _kernels.launch_counts()['bev_canvas'] == before + 1


def test_kernels_without_backward_refuse_grad(cuda):
    """K1-K3 and K13 have no backward: an input that requires grad raises
    (with grad enabled) instead of returning an output with no history."""
    x = torch.randn(16, 64, device=cuda, requires_grad=True)
    slot = torch.arange(64, dtype=torch.int32, device=cuda)
    mem = torch.randn(32, 16, device=cuda)
    feat = torch.randn(1, 8, 4, device=cuda, requires_grad=True)
    coords = torch.zeros(1, 8, 3, dtype=torch.int32, device=cuda)
    coords[0, :, 2] = torch.arange(8, dtype=torch.int32)
    vmask = torch.ones(1, 8, dtype=torch.bool, device=cuda)
    boxes = torch.rand(6, 7, device=cuda).requires_grad_()
    calls = [lambda: segment_sweep(x, slot, 32, 'max'),
             lambda: memory_lookup_fused(x.t().contiguous(), mem, 4),
             lambda: canvas_from_sorted(feat, coords, vmask, 1, 8),
             lambda: boxes_iou_bev(boxes, boxes)]
    for call in calls:
        with pytest.raises(RuntimeError, match='no backward'):
            call()
        with torch.no_grad():
            call()
    torch.cuda.synchronize()


def _scan(rng, b, n):
    """(b, n, 3) points of KITTI-like 16384-point scans, n of them at random."""
    from hvpr_tpu_torch.utils.scans import realistic_scans
    pcr = [0, -39.68, -3, 69.12, 39.68, 1]
    pts = realistic_scans(rng, b, 16384, pcr)[..., :3]
    return torch.from_numpy(pts[:, rng.permutation(16384)[:n]].copy())


@pytest.mark.parametrize('b,n,s,radius,nsample', [
    (2, 1000, 50, 0.3, 32),           # mod-128 bucket collisions
    (4, 16384, 4096, 0.1, 16),        # hvpr.yaml SA1, both radii
    (4, 16384, 4096, 0.5, 32),
    (4, 4096, 1024, 1.0, 32)])        # SA2
def test_ball_query_kernel(cuda, b, n, s, radius, nsample):
    rng = np.random.default_rng(n + s)
    if n == 1000:
        xyz = torch.from_numpy(rng.uniform(0, 1, (b, n, 3)).astype(np.float32))
    else:
        xyz = _scan(rng, b, n)
    centres = xyz[:, rng.choice(n, s, replace=False)].clone()
    centres[0, 0] = 1e3                                      # no point in reach
    mask = torch.from_numpy(rng.uniform(size=(b, n)) > 0.05)
    before = _kernels.launch_counts()['ball_query']
    (gi, gc), (wi, wc) = _both(ball_query_bucket, radius, nsample, xyz.to(cuda),
                               centres.to(cuda), mask.to(cuda))
    assert torch.equal(gi, wi) and torch.equal(gc, wc)
    assert int(gc[0, 0]) == 0 and int(gc.max()) > 1
    assert _kernels.launch_counts()['ball_query'] == before + 1


def _ball_edge_inputs(rng, radius):
    """Three scans of 1000 points (1000 % 32 != 0) and 64 centres each:
    scan 0 a cube of side radius / 2, so every valid point is in reach of
    every centre (neighbourhoods that fill early, ~950 hits colliding in 128
    buckets), scan 1 all invalid, scan 2 sparse with points placed on each
    centre's sphere of the radius (3-4-5 offsets and axis offsets, which
    round to either side of f32(r * r))."""
    n, s = 1000, 64
    xyz = rng.uniform(0, 1, (3, n, 3)).astype(np.float32)
    xyz[0] *= radius * 0.5
    xyz[2] *= 40.0
    centres = xyz[:, rng.choice(n, s, replace=False)].copy()
    ring = np.array([[0.6, 0.8, 0.0], [0.0, 0.6, 0.8], [1.0, 0.0, 0.0],
                     [0.0, 0.0, -1.0], [0.8, 0.0, 0.6]], np.float32) * radius
    for i in range(s):
        slots = 300 + 5 * i + np.arange(5)
        xyz[2, slots] = centres[2, i] + ring
    mask = rng.uniform(size=(3, n)) > 0.05
    mask[1] = False
    mask[2, 300:] = True
    return (torch.from_numpy(xyz), torch.from_numpy(centres), torch.from_numpy(mask))


@pytest.mark.parametrize('nsample', [1, 16, 32, 128])
@pytest.mark.parametrize('radius', [0.5, 0.25])
def test_ball_query_kernel_edges(cuda, radius, nsample):
    """K4 (a warp a centre) against its plain version, bit for bit: ragged
    groups of 32, every nsample up to the 128 buckets, points on the radius,
    an all-invalid scan, dense neighbourhoods, and the two-radius sweep
    against one plain call per radius."""
    from hvpr_tpu_torch.ops.pn2_select import ball_query_bucket2
    rng = np.random.default_rng(int(radius * 100) + nsample)
    xyz, centres, mask = (t.to(cuda) for t in _ball_edge_inputs(rng, radius))
    before = _kernels.launch_counts()['ball_query']
    (gi, gc), (wi, wc) = _both(ball_query_bucket, radius, nsample, xyz, centres, mask)
    assert torch.equal(gi, wi) and torch.equal(gc, wc)
    assert int(gc[1].max()) == 0 and int(gi[1].abs().max()) == 0     # all invalid
    assert int(gc[0].min()) == nsample                               # filled early
    assert _kernels.launch_counts()['ball_query'] == before + 1
    if nsample == 128:
        hits = (((xyz[0, None] - centres[0, :, None]) ** 2).sum(-1) < radius ** 2)
        assert int((hits & mask[0]).sum(-1).min()) > 128             # buckets collide
    other = (radius * 2.0, 32)
    got, want = _both(ball_query_bucket2, (radius, other[0]), (nsample, other[1]),
                      xyz, centres, mask)
    assert _kernels.launch_counts()['ball_query'] == before + 2
    for (gi2, gc2), (wi2, wc2) in zip(got, want):
        assert torch.equal(gi2, wi2) and torch.equal(gc2, wc2)
    assert torch.equal(got[0][0], gi) and torch.equal(got[0][1], gc)


@pytest.mark.parametrize('r,l,nsamp', [(3, 100, 20), (64, 1024, 256), (64, 256, 64)])
def test_fps_chunks_kernel(cuda, r, l, nsamp):
    rng = np.random.default_rng(l)
    pts = torch.from_numpy(rng.normal(size=(r, l, 3)).astype(np.float32))
    pts[0, 10:20] = pts[0, 5]                                # exact ties
    valid = torch.from_numpy(rng.uniform(size=(r, l)) > 0.2)
    valid[1] = False                                         # a set with no valid row
    valid[2, :7] = False                                     # starts past row 0
    before = _kernels.launch_counts()['fps_chunks']
    got, want = _both(fps_chunks, pts.to(cuda), valid.to(cuda), nsamp)
    assert torch.equal(got, want)
    assert int(got[1, 0]) == l - 1 and int(got[2, 0]) == int(valid[2].int().argmax())
    assert _kernels.launch_counts()['fps_chunks'] == before + 1


@pytest.mark.parametrize('r,l,nsamp', [(2, 16384, 512), (1, 20000, 300), (3, 8193, 64)])
def test_fps_chunks_long_sets(cuda, r, l, nsamp):
    """Sets longer than the one-block path holds: K5's long path (a cluster
    of 8 blocks, 32,768 rows in registers, the rest streamed from device
    memory: see the 40,000-row case of test_fps_chunks_kernel_edges)."""
    rng = np.random.default_rng(l)
    pts = torch.from_numpy(rng.normal(size=(r, l, 3)).astype(np.float32))
    pts[:, 100:120] = pts[:, 50:51]                          # exact ties
    pts[:, -5:] = pts[:, 3:4]                                # ties across head and tail
    valid = torch.from_numpy(rng.uniform(size=(r, l)) > 0.2)
    valid[0, :9] = False                                     # starts past row 0
    if r > 2:
        valid[2] = False                                     # a set with no valid row
    before = _kernels.launch_counts()['fps_chunks']
    got, want = _both(fps_chunks, pts.to(cuda), valid.to(cuda), nsamp)
    assert torch.equal(got, want)
    assert int(got[0, 0]) == int(valid[0].int().argmax())
    if r > 2:
        assert int(got[2, 0]) == l - 1
    assert _kernels.launch_counts()['fps_chunks'] == before + 1


def _fps_case(name):
    """(pts, valid, nsamp) of one K5 edge case."""
    rng = np.random.default_rng(len(name))
    r, l, nsamp = {'one-block limit': (2, 8192, 200), 'long path at 8193': (2, 8193, 200),
                   'nsamp = L': (3, 300, 300), 'nsamp = L, one warp': (4, 32, 32),
                   'all tied': (3, 1024, 64), 'only the last row valid': (3, 256, 8),
                   'one warp': (5, 7, 5), 'nsamp = L, long': (1, 9000, 9000),
                   'long path with a tail': (2, 40000, 100)}[name]
    pts = torch.from_numpy(rng.normal(size=(r, l, 3)).astype(np.float32))
    valid = torch.from_numpy(rng.uniform(size=(r, l)) > 0.1)
    if name == 'all tied':
        pts[:] = pts[:, :1]
    if name == 'only the last row valid':
        valid[:] = False
        valid[:, -1] = True
    return pts, valid, nsamp


@pytest.mark.parametrize('name', ['one-block limit', 'long path at 8193', 'nsamp = L',
                                  'nsamp = L, one warp', 'all tied',
                                  'only the last row valid', 'one warp', 'nsamp = L, long',
                                  'long path with a tail'])
def test_fps_chunks_kernel_edges(cuda, name):
    """K5 equals the plain FPS at the one-block path's limit and just past
    it, with nsamp = L, with every point tied, with only the last row valid,
    at one-warp sets, and past the long path's 32,768 rows on chip."""
    pts, valid, nsamp = _fps_case(name)
    before = _kernels.launch_counts()['fps_chunks']
    got, want = _both(fps_chunks, pts.to(cuda), valid.to(cuda), nsamp)
    assert torch.equal(got, want)
    assert _kernels.launch_counts()['fps_chunks'] == before + 1
    if name == 'only the last row valid':
        assert bool((got == pts.shape[1] - 1).all())


def test_exact_furthest_point_sample_on_a_scan(cuda):
    """furthest_point_sample(num_chunks=1) over whole 16,384-point scans at
    hvpr.yaml's SA1 npoint: one set a scan, on the card."""
    from hvpr_tpu_torch.ops.pointnet2 import furthest_point_sample
    rng = np.random.default_rng(4)
    xyz = _scan(rng, 4, 16384).to(cuda)
    mask = torch.ones(4, 16384, dtype=torch.bool, device=cuda)
    mask[1, -2000:] = False
    got, want = _both(furthest_point_sample, xyz, mask, 4096, num_chunks=1)
    assert torch.equal(got, want) and got.shape == (4, 4096)
    assert bool(torch.gather(mask, 1, got).all())


@pytest.mark.parametrize('b,n,s,case', [
    (4, 4096, 1024, None), (4, 16384, 4096, None),          # hvpr.yaml FP
    (2, 300, 700, None), (2, 100, 50, None),
    (2, 1000, 1500, None),                                  # S not a multiple of the tile
    (2, 500, 900, 'all masked'),
    (2, 500, 900, 'duplicates')])
def test_three_nn_kernel(cuda, b, n, s, case):
    rng = np.random.default_rng(n + s)
    if s >= 1024:
        known = _scan(rng, b, s)
        unknown = _scan(rng, b, n)
    else:
        known = torch.from_numpy(rng.uniform(-2, 2, (b, s, 3)).astype(np.float32))
        unknown = torch.from_numpy(rng.uniform(-2, 2, (b, n, 3)).astype(np.float32))
        if s >= 256:
            known[0, 128:256] = known[0, 0:128]              # ties within a bucket
        unknown[0, :4] = known[0, :4]                        # distance 0
    mask = torch.from_numpy(rng.uniform(size=(b, s)) > 0.1)
    if n == 100:
        mask[1] = False                                      # S < 128, all masked
    if case == 'all masked':
        mask[:] = False
    if case == 'duplicates':
        # one point at many indices, in every bucket, and a second one
        # repeated within a tile and across tiles: equal keys tie
        known[:, 1:400] = known[:, :1]
        known[:, 600::7] = known[:, 599:600]
        mask[:] = True
        unknown[:, :8] = known[:, :1] + 0.25
    before = _kernels.launch_counts()['three_nn_bucket']
    (gd, gi), (wd, wi) = _both(three_nn_bucket, unknown.to(cuda), known.to(cuda),
                               mask.to(cuda))
    assert torch.equal(gi, wi) and torch.equal(gd, wd)
    assert gi.dtype == torch.int32 and gd.shape == (b, n, 3)
    assert _kernels.launch_counts()['three_nn_bucket'] == before + 1
    if n == 100:
        assert int(gi[1].abs().sum()) == 0 and bool((gd[1] == 1e5).all())
    if case == 'all masked':
        assert not gi.any() and bool((gd == 1e5).all())
    again = three_nn_bucket(unknown.to(cuda), known.to(cuda), mask.to(cuda))
    assert torch.equal(again[0], gd) and torch.equal(again[1], gi)


def _close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    err = float((got - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), err


@pytest.mark.parametrize('r,m,c,lam', [(1000, 64, 32, 0.0), (1003, 300, 64, 0.0025),
                                       (517, 2000, 30, 0.0025),   # ragged tiles, C < 64
                                       (65536, 2000, 64, 0.0025),
                                       # lam = 0: K6's dense (DMMA) output path
                                       (517, 2000, 30, 0.0), (65536, 2000, 64, 0.0)])
def test_memory_recon_kernels(cuda, r, m, c, lam):
    rng = np.random.default_rng(r)
    x = torch.from_numpy(rng.normal(0, 1, (r, c)).astype(np.float32)).to(cuda)
    w = torch.from_numpy(rng.uniform(-1, 1, (m, c)).astype(np.float32) / c ** 0.5).to(cuda)
    dy = torch.from_numpy(rng.normal(0, 1, (r, c)).astype(np.float32)).to(cuda)
    got, want = _both(recon_forward, x, w, lam)
    _close(got, want)
    (gdx, gdw), (wdx, wdw) = _both(recon_backward, x, w, dy, lam)
    _close(gdx, wdx)
    _close(gdw, wdw)
    # the autograd function launches K6 forward and K7 backward
    before = _kernels.launch_counts()
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    (memory_recon(xr, wr, lam) * dy).sum().backward()
    after = _kernels.launch_counts()
    assert after['memory_recon_fwd'] == before['memory_recon_fwd'] + 1
    assert after['memory_recon_bwd'] == before['memory_recon_bwd'] + 1
    _close(xr.grad, wdx)
    _close(wr.grad, wdw)


def test_memory_recon_forward_over_the_list_cap(cuda):
    """Rows with more nonzero weights than K6's per-row list holds (512):
    their 16-row tiles take the dense DMMA output, the others the list."""
    from hvpr_tpu_torch.ops.memory_recon import _attention
    rng = np.random.default_rng(9)
    r, m, c, lam = 4000, 2000, 64, 0.0004
    x = torch.from_numpy(rng.normal(0, 6, (r, c)).astype(np.float32))
    x[[5, 1000, 3999]] = 0.0             # a flat softmax: all 2000 weights > lam
    w = torch.from_numpy(rng.uniform(-1, 1, (m, c)).astype(np.float32) / c ** 0.5)
    nonzero = (_attention(x, w, lam)[3].to(torch.bfloat16) != 0).sum(dim=1)
    assert int(nonzero[5]) == m and int((nonzero > 512).sum()) == 3
    assert 0 < int(nonzero.min()) and int(nonzero.median()) < 512
    got, want = _both(recon_forward, x.to(cuda), w.to(cuda), lam)
    _close(got, want)


def _attend_inputs(rng, b, v, n, c, cuda):
    """Pillars, a selection table, a value table, neg, a row mask and dout,
    with a zero pillar row (it ties with every point: all valid points are
    selected, past the kernel's list), padded points, and, for b > 2, a scan
    with no valid point (every row selects nothing)."""
    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(cuda)
    pillars = rng.normal(size=(b, v, c))
    pillars[0, 1] = 0.0
    neg = np.zeros((b, n))
    neg[0, -37:] = -1e30
    if b > 2:
        neg[2] = -1e30
    row_mask = rng.uniform(size=(b, v)) > 0.3
    row_mask[0, 1] = True
    row_mask[:, 32:64] = False                              # a whole tile out
    return (t(pillars), t(rng.normal(size=(b, n, c))), t(rng.normal(size=(b, n, c))),
            t(neg), torch.from_numpy(row_mask).to(cuda), t(rng.normal(size=(b, v, c))))


@pytest.mark.parametrize('b,v,n,c,k', [(3, 300, 1000, 64, 20), (2, 100, 300, 16, 4),
                                       (4, 16000, 16384, 64, 20)])   # hvpr.yaml batch 4
def test_topk_attend_kernels(cuda, b, v, n, c, k):
    rng = np.random.default_rng(n)
    pillars, points, vals, neg, row_mask, dout = _attend_inputs(rng, b, v, n, c, cuda)
    for mask in (torch.ones_like(row_mask), row_mask):
        th, th_p = _both(bucket_threshold, pillars, points, neg, k, mask)
        assert torch.equal(th, th_p)
        for shared in (True, False):
            val = points if shared else vals
            (out, mx, den, cnt, pidx, pw), (out_p, mx_p, den_p, cnt_p, pidx_p, pw_p) = _both(
                masked_attend_fwd, pillars, points, val, neg, th, shared, mask)
            assert torch.equal(cnt, cnt_p) and torch.equal(mx, mx_p)
            assert torch.equal(pidx, pidx_p) and torch.equal(pw, pw_p)     # K9's pairs
            _close(out, out_p)
            _close(den, den_p)
            assert int(cnt[0, 1]) == n - 37                  # the zero row
            assert int(cnt.max()) > 128 >= int(cnt[1].max())
            if b > 2:
                assert int(cnt[2].max()) == 0 and float(out[2].abs().max()) == 0.0
            assert int(cnt[~mask].sum()) == 0 and float(out[~mask].abs().sum()) == 0.0
            dval, dval_p = _both(masked_attend_bwd, pillars, points, val, neg, th, mx,
                                 den, dout, shared, mask, pidx, pw, cnt)
            _close(dval, dval_p)
            assert torch.equal(dval, dval.to(torch.bfloat16).float())
            # and the dense oracle, which recomputes every row's weights
            _close(dval, masked_attend_bwd_plain(pillars, points, val, neg, th, mx, den,
                                                 dout, shared, mask))


@pytest.mark.parametrize('k', [1, 20, 128])
@pytest.mark.parametrize('c', [8, 32, 64])
@pytest.mark.parametrize('quantized', [False, True])
def test_bucket_threshold_kernel(cuda, quantized, c, k):
    """K8 (the DMMA sweep) against its plain version, bit for bit: N % 128
    != 0 and a scan of fewer points than buckets (padded buckets), masked
    points scored -1e30 + dot, quantized inputs whose scores tie, masked
    rows and a 16-row tile without a valid row."""
    rng = np.random.default_rng(c * 1000 + k + quantized)
    b, v = 3, 100
    for n in (1000, 100):
        if quantized:       # dots of small integers / 2: many equal scores
            pillars = rng.integers(-2, 3, (b, v, c)) / 2.0
            table = rng.integers(-2, 3, (b, n, c)) / 2.0
        else:
            pillars, table = rng.normal(size=(b, v, c)), rng.normal(size=(b, n, c))
        neg = np.where(rng.uniform(size=(b, n)) < 0.2, -1e30, 0.0)
        neg[0, -37:] = -1e30
        neg[2] = -1e30                                       # every point masked
        row_mask = rng.uniform(size=(b, v)) > 0.3
        row_mask[:, 16:32] = False                           # a tile without a valid row
        args = [torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(cuda)
                for x in (pillars, table, neg)]
        mask = torch.from_numpy(row_mask).to(cuda)
        before = _kernels.launch_counts()['bucket_threshold']
        th, th_p = _both(bucket_threshold, *args, k, mask)
        assert torch.equal(th, th_p)
        assert _kernels.launch_counts()['bucket_threshold'] == before + 1
        assert float(th[~mask].abs().max()) == 0.0
        if n < k:
            assert bool((th[mask] == -1e30).all())            # a padded bucket's maximum


@pytest.mark.parametrize('b,v,n,c,k', [(3, 300, 1000, 64, 20), (2, 100, 300, 16, 4),
                                       (4, 16000, 16384, 64, 20)])   # hvpr.yaml batch 4
def test_masked_attend_pair_pass(cuda, b, v, n, c, k):
    """K9's pair pass: a call handed the shared call's selection (count and
    pairs) against the plain version given the same selection, and against
    the dense sweep that recomputes it; counts, row maxima and pairs exact."""
    rng = np.random.default_rng(n + 1)
    pillars, points, vals, neg, row_mask, _ = _attend_inputs(rng, b, v, n, c, cuda)
    for mask in (torch.ones_like(row_mask), row_mask):
        th = bucket_threshold(pillars, points, neg, k, mask)
        first = masked_attend_fwd(pillars, points, points, neg, th, True, mask)
        selection = (first[3], first[4])
        for shared in (True, False):
            val = points if shared else vals
            before = _kernels.launch_counts()['masked_attend_pairs']
            got, want = _both(masked_attend_fwd, pillars, points, val, neg, th, shared,
                              mask, selection)
            assert _kernels.launch_counts()['masked_attend_pairs'] == before + 1
            dense = masked_attend_fwd(pillars, points, val, neg, th, shared, mask)
            for ref in (want, dense):
                out, mx, den, cnt, pidx, pw = got
                assert torch.equal(cnt, ref[3]) and torch.equal(mx, ref[1])
                assert torch.equal(pidx, ref[4]) and torch.equal(pw, ref[5])
                _close(out, ref[0])
                _close(den, ref[2])
            assert int(got[3][0, 1]) == n - 37                # the zero row overflows


@pytest.mark.parametrize('shared', [True, False])
def test_masked_attend_autograd_launches_k9_and_k10(cuda, shared):
    rng = np.random.default_rng(5)
    pillars, points, vals, neg, row_mask, dout = _attend_inputs(rng, 2, 200, 700, 32, cuda)
    th = bucket_threshold(pillars, points, neg, 8, row_mask)
    pts = points.clone().requires_grad_()
    val = pts if shared else vals.clone().requires_grad_()
    before = _kernels.launch_counts()
    out = masked_attend(pillars, pts, val, neg, th, row_mask)
    (out * dout).sum().backward()
    after = _kernels.launch_counts()
    assert after['masked_attend_fwd'] == before['masked_attend_fwd'] + 1
    assert after['masked_attend_bwd'] == before['masked_attend_bwd'] + 1
    _, mx, den, cnt, pidx, pw = masked_attend_fwd(pillars, points, val.detach(), neg, th,
                                                  shared, row_mask)
    with _kernels.plain_versions():
        want = masked_attend_bwd(pillars, points, val.detach(), neg, th, mx, den, dout,
                                 shared, row_mask, pidx, pw, cnt)
    _close(val.grad, want)                                  # once, not twice when shared
    if not shared:
        assert pts.grad is None


@pytest.mark.parametrize('v', [2000, 40000])     # long points; two byte-map windows
def test_masked_attend_bwd_long_points(cuda, v):
    """Points listed by many rows: K10 sorts and reduces a point with more
    than 256 listed rows by a block (its rows' byte map in windows of 32768
    rows, its sum in pieces); the zero row (an overflow row) merges into
    every point's sum."""
    rng = np.random.default_rng(v)
    b, n, c, k = 1, 1000, 16, 4
    pillars, points, vals, neg, row_mask, dout = _attend_inputs(rng, b, v, n, c, cuda)
    row_mask[:] = True
    pillars[0, :, 0] = pillars[0, :, 0].abs() + 1.0       # every row leans to channel 0
    pillars[0, 1] = 0.0                                    # but the zero row
    points[0, 7] = 0.0
    points[0, 7, 0] = 1000.0                               # a point every row selects
    th = bucket_threshold(pillars, points, neg, k, row_mask)
    for shared in (True, False):
        val = points if shared else vals
        _, mx, den, cnt, pidx, pw = masked_attend_fwd(pillars, points, val, neg, th, shared,
                                                      row_mask)
        assert int((pidx == 7).sum()) > (256 if v < 32768 else 32768)
        assert int(cnt[0, 1]) > 128                        # the zero row overflows
        dval, dval_p = _both(masked_attend_bwd, pillars, points, val, neg, th, mx, den, dout,
                             shared, row_mask, pidx, pw, cnt)
        _close(dval, dval_p)
        _close(dval, masked_attend_bwd_plain(pillars, points, val, neg, th, mx, den, dout,
                                             shared, row_mask))
        again = masked_attend_bwd(pillars, points, val, neg, th, mx, den, dout, shared,
                                  row_mask, pidx, pw, cnt)
        assert torch.equal(again, dval)                    # the same bits every run


def test_padded_eval_path_launches_k2_only(cuda):
    """hvpr_mini.yaml on the card: a host-voxelized padded batch launches
    K2 once and neither K1 nor K3, and its detections equal the flat
    device path's on the same points."""
    from pathlib import Path

    from hvpr_tpu_torch.config import ConfigDict, cfg_from_yaml_file
    from hvpr_tpu_torch.models import DatasetMeta, build_network
    from hvpr_tpu_torch.ops.voxelizer import VoxelGeneratorNumpy

    cfg = cfg_from_yaml_file(str(Path(__file__).resolve().parent.parent / 'tools' / 'cfgs'
                                 / 'kitti_models' / 'hvpr_mini.yaml'), ConfigDict())
    meta = DatasetMeta(cfg.DATA_CONFIG, cfg.CLASS_NAMES)
    torch.manual_seed(0)
    net = build_network(cfg.MODEL, 1, meta, device='cuda')
    with torch.no_grad():       # logits near 0, so that anchors clear SCORE_THRESH
        net.module.dense_head.conv_cls.bias.zero_()
    rng = np.random.default_rng(0)
    pcr = meta.point_cloud_range
    pts = rng.uniform(pcr[:3], pcr[3:], (2, 256, 3))
    pts = np.concatenate([pts, rng.uniform(0, 1, (2, 256, 1))], axis=2).astype(np.float32)
    gen = VoxelGeneratorNumpy(meta.voxel_size, pcr, meta.max_points_per_voxel, meta.max_voxels)
    v, p = meta.max_voxels, meta.max_points_per_voxel
    batch = {'voxels': np.zeros((2, v, p, 4), np.float32),
             'voxel_coords': np.zeros((2, v, 3), np.int32),
             'voxel_num_points': np.zeros((2, v), np.int32)}
    for i in range(2):
        vox, coords, cnt = gen.generate(pts[i])
        batch['voxels'][i, :len(vox)] = vox
        batch['voxel_coords'][i, :len(vox)] = coords
        batch['voxel_num_points'][i, :len(vox)] = cnt
    batch['voxel_mask'] = batch['voxel_num_points'] > 0
    _kernels.reset_launch_counts()
    padded = net.eval_forward({k: torch.from_numpy(a).to(cuda) for k, a in batch.items()})
    torch.cuda.synchronize()
    launches = _kernels.launch_counts()
    assert launches['memory_lookup'] == 1
    assert launches['segment_sweep'] == 0 and launches['bev_canvas'] == 0
    flat = net.pipeline(torch.from_numpy(pts).to(cuda),
                        torch.ones(2, 256, dtype=torch.bool, device=cuda))
    assert bool(padded['pred_mask'].any())
    for k in ('pred_mask', 'pred_boxes', 'pred_scores', 'pred_labels'):
        assert torch.equal(padded[k], flat[k]), k


def test_padded_train_step_kernels_equal_plain(cuda):
    """hvpr_mini.yaml as shipped (fused) on the card: one train step on a
    host-voxelized padded batch (the train CLI's layout) through the
    kernels equals one through the plain versions from the same state, bit
    for bit (losses, grad norm, every weight and BN statistic), under
    deterministic algorithms; the kernel step launches K4-K10 and K12
    their expected number of times and K1, K3 and K11 never."""
    import os
    from pathlib import Path

    from hvpr_tpu_torch.config import ConfigDict, cfg_from_yaml_file
    from hvpr_tpu_torch.models import DatasetMeta, build_network, load_data_to_gpu
    from hvpr_tpu_torch.ops.voxelizer import VoxelGeneratorNumpy

    os.environ.setdefault('CUBLAS_WORKSPACE_CONFIG', ':4096:8')
    cfg = cfg_from_yaml_file(str(Path(__file__).resolve().parent.parent / 'tools' / 'cfgs'
                                 / 'kitti_models' / 'hvpr_mini.yaml'), ConfigDict())
    meta = DatasetMeta(cfg.DATA_CONFIG, cfg.CLASS_NAMES, mode='train')
    rng = np.random.default_rng(1)
    pcr = meta.point_cloud_range
    n = 256
    pts = rng.uniform(pcr[:3], pcr[3:], (2, n, 3))
    pts = np.concatenate([pts, rng.uniform(0, 1, (2, n, 1))], axis=2).astype(np.float32)
    gen = VoxelGeneratorNumpy(meta.voxel_size, pcr, meta.max_points_per_voxel, meta.max_voxels)
    v, p = meta.max_voxels, meta.max_points_per_voxel
    batch = {'points': pts, 'point_valid_mask': np.ones((2, n), bool),
             'voxels': np.zeros((2, v, p, 4), np.float32),
             'voxel_coords': np.zeros((2, v, 3), np.int32),
             'voxel_num_points': np.zeros((2, v), np.int32),
             'gt_boxes': np.zeros((2, 4, 8), np.float32)}
    for i in range(2):
        vox, coords, cnt = gen.generate(pts[i])
        batch['voxels'][i, :len(vox)] = vox
        batch['voxel_coords'][i, :len(vox)] = coords
        batch['voxel_num_points'][i, :len(vox)] = cnt
    batch['voxel_mask'] = batch['voxel_num_points'] > 0
    batch['gt_boxes'][:, :3] = [[20.0, 0.0, -1.0, 3.9, 1.6, 1.56, 0.3, 1.0],
                                [30.0, 5.0, -1.0, 4.1, 1.7, 1.5, -1.2, 1.0],
                                [12.0, -8.0, -1.0, 3.8, 1.6, 1.5, 2.0, 1.0]]
    dev_batch = load_data_to_gpu(batch, cuda)

    torch.manual_seed(0)
    net = build_network(cfg.MODEL, 1, meta, device='cuda', train=True)
    state = {k: v.clone() for k, v in net.module.state_dict().items()}
    runs = {}
    torch.use_deterministic_algorithms(True)
    try:
        for name in ('kernels', 'plain'):
            net.module.load_state_dict(state)
            net.init_training(cfg.OPTIMIZATION, 10)
            _kernels.reset_launch_counts()
            if name == 'plain':
                with _kernels.plain_versions():
                    metrics = net.train_step(dev_batch)
            else:
                metrics = net.train_step(dev_batch)
            torch.cuda.synchronize()
            runs[name] = ({k: float(x) for k, x in metrics.items()}, _kernels.launch_counts(),
                          {k: x.clone() for k, x in net.module.state_dict().items()})
    finally:
        torch.use_deterministic_algorithms(False)
    (mk, launches, sk), (mp, plain_launches, sp) = runs['kernels'], runs['plain']
    assert mk == mp and np.isfinite(mk['loss'])
    for k in sp:
        assert torch.equal(sk[k], sp[k]), k
    assert launches == {**dict.fromkeys(_kernels.KERNELS, 0),
                        'ball_query': 2, 'fps_chunks': 2, 'memory_recon_fwd': 1,
                        'memory_recon_bwd': 1, 'bucket_threshold': 1,
                        'masked_attend_fwd': 1, 'masked_attend_pairs': 1,
                        'masked_attend_bwd': 2, 'gather_grad': 4}, launches
    assert not any(plain_launches.values())


# K12's cases: (targets n, rows R, channels C, how the rows pick targets)
GATHER_GRAD_CASES = {
    'hub and empty targets': (16384, 196608, 67, 'hub'),   # SA2's widths
    'C=1': (5000, 40000, 1, 'random'),
    'C=3': (5000, 40000, 3, 'random'),
    'C=8': (5000, 40000, 8, 'random'),
    'C=128': (5000, 40000, 128, 'random'),
    'no rows': (300, 0, 8, 'random'),
    'n=1': (1, 3000, 67, 'random'),
    # a range longer than one window of the sort's bitmap
    'every row on one target': (64, 300000, 8, 'one'),
    'out-of-range targets left out': (700, 20000, 16, 'outside'),
}


def _gather_grad_inputs(name, dtype):
    n, r, c, how = GATHER_GRAD_CASES[name]
    rng = np.random.default_rng(r + c)
    if how == 'hub':
        index = rng.integers(0, n - 100, r)              # the last 100 rows get none
        index[:5000] = 7                                 # a hub row
    elif how == 'one':
        index = np.full(r, 5)
    else:
        index = rng.integers(0, n, r)
        if how == 'outside':
            index[::97] = -1
            index[1::89] = n + 3
    grad = torch.from_numpy(rng.normal(size=(r, c)).astype(np.float32)).to(dtype)
    return grad, torch.from_numpy(index.astype(np.int64)), n


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('case', list(GATHER_GRAD_CASES))
def test_gather_grad_kernel_equals_plain_and_repeats_its_bits(cuda, case, dtype):
    """K12 (the row gather's backward) sums each target's contributions
    in source order without atomics: the same bits on every run, and the
    plain version's bits on the CPU (an f32 index_add_ in order), at SA2's
    grouping widths with a hub row and empty targets, at widths whose rows
    are not a multiple of 16 bytes, without rows, into one target, and with
    every row on one target."""
    from hvpr_tpu_torch.ops.gather_rows import (gather_rows_backward,
                                                gather_rows_backward_plain)
    grad, index, n = _gather_grad_inputs(case, dtype)
    before = _kernels.launch_counts()['gather_grad']
    got = gather_rows_backward(grad.to(cuda), index.to(cuda), n)
    again = gather_rows_backward(grad.to(cuda), index.to(cuda), n)
    torch.cuda.synchronize()
    assert _kernels.launch_counts()['gather_grad'] == before + 2
    assert got.dtype == dtype and got.shape == (n, grad.shape[1])
    assert torch.equal(got, again)
    keep = (index >= 0) & (index < n)
    assert torch.equal(got.cpu(), gather_rows_backward_plain(grad[keep], index[keep], n))
    if case == 'hub and empty targets':
        assert not got[-100:].any()


@pytest.mark.parametrize('case', list(GATHER_GRAD_CASES))
def test_gather_grad_ranges_equal_plain(cuda, case):
    """K12's set-up (count, scan, place, sort on the device) builds the
    plain version's ranges: each target's offsets and its rows ascending."""
    from hvpr_tpu_torch.ops.gather_rows import gather_grad_ranges, gather_grad_ranges_plain
    _, index, n = _gather_grad_inputs(case, torch.float32)
    offsets, order = gather_grad_ranges(index.to(cuda), n)
    want_offsets, want_order = gather_grad_ranges_plain(index, n)
    assert torch.equal(offsets.cpu().long(), want_offsets)
    assert torch.equal(order.cpu().long(), want_order)


def test_three_interpolate_backward_repeats_its_bits(cuda):
    """The FP modules' 3-NN interpolation at hvpr.yaml's first FP level
    (16,384 points from 4096, C = 128, bf16): two backwards give the same
    bits with torch's deterministic algorithms off, each launching K12
    once."""
    from hvpr_tpu_torch.ops import pointnet2 as pn2
    rng = np.random.default_rng(3)
    unknown = torch.from_numpy(rng.uniform(-40, 40, (2, 16384, 3)).astype(np.float32)).to(cuda)
    known = unknown[:, ::4].contiguous()
    mask = torch.ones(2, 4096, dtype=torch.bool, device=cuda)
    dist, idx = pn2.three_nn(unknown, known, mask)
    weight = pn2.three_nn_interpolate_weights(dist).to(torch.bfloat16)
    feats = torch.from_numpy(rng.normal(size=(2, 4096, 128)).astype(np.float32)).to(cuda)
    dout = torch.from_numpy(rng.normal(size=(2, 16384, 128)).astype(np.float32)).to(cuda)
    assert not torch.are_deterministic_algorithms_enabled()
    grads = []
    for _ in range(2):
        f = feats.to(torch.bfloat16).requires_grad_()
        before = _kernels.launch_counts()['gather_grad']
        (pn2.three_interpolate(f, idx, weight).float() * dout).sum().backward()
        torch.cuda.synchronize()
        assert _kernels.launch_counts()['gather_grad'] == before + 1
        grads.append(f.grad)
    assert torch.equal(grads[0], grads[1])


# K13's cases: name -> (boxes_a, boxes_b) as numpy (N, 7) / (M, 7) f32, or
# 'scan' (the NMS's own candidates) and 'nms' (the whole NMS on them)
def _boxes(xy, size, heading, z=-1.0, dz=1.56):
    n = len(xy)
    out = np.zeros((n, 7), np.float32)
    out[:, :2] = xy
    out[:, 2] = z
    out[:, 3:5] = size
    out[:, 5] = dz
    out[:, 6] = heading
    return out


def _iou_case(name):
    rng = np.random.default_rng(IOU_CASES.index(name))
    half_pi = np.float32(math.pi / 2)
    if name == 'identical boxes':
        a = _boxes(rng.uniform(-30, 30, (300, 2)), rng.uniform(0.5, 5, (300, 2)),
                   rng.uniform(-math.pi, math.pi, 300))
        return a, np.concatenate([a, a[::-1]])
    if name == 'nested boxes':
        big = _boxes([[0, 0]] * 8, [[10, 6]] * 8, np.arange(8) * 0.4)
        small = _boxes(rng.uniform(-1, 1, (64, 2)), rng.uniform(0.2, 3, (64, 2)),
                       rng.uniform(-math.pi, math.pi, 64))
        return big, small
    if name == 'touching at an edge':          # shared edges, anti-parallel in CCW order
        a = _boxes([[0, 0], [0, 0], [5, 5]], [[4, 2], [4, 2], [2, 2]], [0, half_pi, 0.3])
        d = np.array([np.cos(0.3), np.sin(0.3)], np.float32) * 2
        b = _boxes([[4, 0], [0, 2], [-4, 0], [0, 4], [0, -2], [5 + d[0], 5 + d[1]]],
                   [[4, 2], [4, 2], [4, 2], [2, 4], [4, 2], [2, 2]],
                   [0, 0, math.pi, half_pi, 0, 0.3])
        return a, b
    if name == 'touching at a corner':
        a = _boxes([[0, 0], [1, 1]], [[2, 2], [2, 2]], [0, 0])
        b = _boxes([[2, 2], [-2, -2], [2, -2], [3, 3], [1 + 2 ** 0.5, 1]],
                   [[2, 2], [2, 2], [2, 2], [2, 2], [2, 2]],
                   [0, 0, half_pi, math.pi, math.pi / 4])
        return a, b
    if name == 'quarter turns and near them':
        k = np.arange(-4, 5)
        turns = np.concatenate([k * half_pi, k * half_pi + 1e-7, k * half_pi - 3e-7,
                                half_pi + rng.normal(0, 1e-4, 9)]).astype(np.float32)
        a = _boxes(np.repeat([[1.0, -2.0]], len(turns), 0), [[3.9, 1.6]] * len(turns), turns)
        b = _boxes(np.repeat([[1.0, -2.0], [2.95, -2.0], [1.0, -1.2]], 12, 0),
                   [[3.9, 1.6]] * 36, np.tile(turns[:12], 3))
        return a, b
    if name == 'zero-size boxes':
        size = np.array([[0, 0], [0, 1.6], [3.9, 0], [3.9, 1.6]] * 8, np.float32)
        a = _boxes(rng.uniform(-2, 2, (32, 2)), size, rng.uniform(-math.pi, math.pi, 32))
        return a, a[::-1].copy()
    if name == 'a crowd: every pair clipped':
        a = _boxes(rng.uniform(-1, 1, (700, 2)), rng.uniform(2, 4, (700, 2)),
                   rng.uniform(-math.pi, math.pi, 700))
        return a, a
    if name == 'thin: 37,000 anchors x 40 boxes':
        x, y = np.meshgrid(np.linspace(0.16, 68.96, 185), np.linspace(-39.52, 39.52, 100))
        xy = np.stack([x.ravel(), y.ravel()], 1)
        anchors = _boxes(np.concatenate([xy, xy]), [[3.9, 1.6]] * 37000,
                         np.repeat([0.0, half_pi], 18500))
        gt = _boxes(rng.uniform([0, -39], [69, 39], (40, 2)),
                    rng.uniform([3, 1.4], [5, 2], (40, 2)),
                    rng.uniform(-math.pi, math.pi, 40), z=rng.uniform(-2, 0, 40))
        return anchors, gt
    n, m = {'N = 0': (0, 5), 'M = 0': (5, 0), 'N = M = 1': (1, 1), 'N = 1': (1, 300),
            'M = 1': (300, 1)}[name]
    a = _boxes(rng.uniform(-5, 5, (n, 2)), rng.uniform(1, 4, (n, 2)), rng.uniform(-3, 3, n))
    b = _boxes(rng.uniform(-5, 5, (m, 2)), rng.uniform(1, 4, (m, 2)), rng.uniform(-3, 3, m))
    return a, b


IOU_CASES = ['scan', 'nms', 'identical boxes', 'nested boxes', 'touching at an edge',
             'touching at a corner', 'quarter turns and near them', 'zero-size boxes',
             'a crowd: every pair clipped', 'thin: 37,000 anchors x 40 boxes', 'N = 0',
             'M = 0', 'N = M = 1', 'N = 1', 'M = 1']


@functools.lru_cache(maxsize=1)
def _cell_nms_calls():
    """[(boxes (A, 7), scores (A,), thresh, pre, post)] of every NMS of one
    batch of the benchmark cell hvpr.infer.b8: its seeded traffic and
    weights (the seed of the benchmark's CUDA tests)."""
    bench = str(Path(__file__).resolve().parents[1] / 'benchmark')
    if bench not in sys.path:
        sys.path.insert(0, bench)
    from harness.program import Program
    from harness.spec import Cell
    from traffic.scans import pool
    from hvpr_tpu_torch.models.model_utils import model_nms_utils

    cell, seed = Cell('hvpr.infer.b8'), 2 ** 31 + 11
    program = Program(cell, seed, 'cuda')
    batches, _ = pool(cell.traffic, seed, cell.config['DATA_CONFIG']['POINT_CLOUD_RANGE'])
    points = torch.from_numpy(batches[0]).cuda()
    calls, real = [], model_nms_utils.nms_bev_fixed

    def spy(boxes, scores, thresh, pre_maxsize, post_maxsize, **kw):
        calls.append((boxes.clone(), scores.clone(), thresh, pre_maxsize, post_maxsize))
        return real(boxes, scores, thresh, pre_maxsize, post_maxsize, **kw)

    model_nms_utils.nms_bev_fixed = spy
    try:
        program.detect(points, torch.ones(points.shape[:2], dtype=torch.bool, device='cuda'))
    finally:
        model_nms_utils.nms_bev_fixed = real
        program.close()
    return calls


@pytest.mark.parametrize('case', IOU_CASES)
def test_rotated_iou_kernel_equals_plain(cuda, case):
    """K13 against the plain version by torch.equal: the boxes' records
    (corners, half-planes, areas), boxes_overlap_bev, boxes_iou_bev and
    boxes_iou3d (its plain height arithmetic on K13's overlaps), one
    launch a call and none for an empty set. 'scan': the
    4,096 live candidates of a scan of the benchmark cell, as the NMS
    takes them; 'nms': nms_bev_fixed on every scan of that batch."""
    from hvpr_tpu_torch.ops.nms import nms_bev_fixed, preselect
    if case == 'nms':
        for boxes, scores, thresh, pre, post in _cell_nms_calls():
            got, want = _both(nms_bev_fixed, boxes, scores, thresh, pre, post)
            for g, w in zip(got, want):
                assert torch.equal(g, w)
        return
    if case == 'scan':
        boxes, scores, _, pre, _ = _cell_nms_calls()[0]
        order, _ = preselect(scores, pre)
        assert order.numel() == 4096
        a = b = boxes[order]
    else:
        a, b = (torch.from_numpy(x).to(cuda) for x in _iou_case(case))
    for boxes in (a, b):            # the boxes' records as the kernel makes them
        assert torch.equal(records_on_card(boxes), box_records(boxes))
    launches = 0 if a.shape[0] == 0 or b.shape[0] == 0 else 1
    for fn in (boxes_overlap_bev, boxes_iou_bev, boxes_iou3d):
        before = _kernels.launch_counts()['rotated_iou']
        got = fn(a, b)
        torch.cuda.synchronize()
        assert _kernels.launch_counts()['rotated_iou'] == before + launches
        with _kernels.plain_versions():
            want = fn(a, b)
        assert got.shape == want.shape == (a.shape[0], b.shape[0])
        assert got.dtype == want.dtype == torch.float32
        assert torch.equal(got, want), (fn.__name__, (got != want).sum().item())


@pytest.mark.parametrize('case', list(RULEBOOK_CASES))
def test_sparse_rulebook_kernel_equals_plain(cuda, case):
    """K14 against the plain rulebook (the per-tap lookups) on the same CUDA
    tensors, by torch.equal on every tap's rows and hits: submanifold and
    strided convs (the stage conv, conv4's padding, conv_out; M = the
    2V-like cap, not V), sites on every grid face, invalid slots (with junk
    coordinates), an empty sample and a full one; one launch a call."""
    args = rulebook_case(case, cuda)
    before = _kernels.launch_counts()['sparse_rulebook']
    got, want = _both(tap_rulebook, *args)
    assert _kernels.launch_counts()['sparse_rulebook'] == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w), (case, (g != w).sum().item())


def test_sparse_backbone_launches_k14_a_conv_and_equals_plain(cuda, monkeypatch):
    """VoxelBackBone8xSparse at upstream geometry (SECOND's 41 x 1600 x 1408
    sparse shape) on 4 scans of 20,000 points, the benchmark cell
    second.infer.b4's: K14 once a conv (12), the per-tap loop never, and the
    same encoded_spconv_tensor bits as through the plain versions."""
    from hvpr_tpu_torch.models.backbones_3d.sparse_backbone import VoxelBackBone8xSparse
    from hvpr_tpu_torch.ops import sparse_conv
    from hvpr_tpu_torch.ops.voxelizer import VoxelGeneratorNumpy
    from hvpr_tpu_torch.utils.scans import realistic_scans

    pcr, v, p = [0, -40, -3, 70.4, 40, 1], 40000, 5
    gen = VoxelGeneratorNumpy([0.05, 0.05, 0.1], pcr, p, v)
    points = realistic_scans(np.random.default_rng(0), 4, 20000, pcr)
    batch = {'voxels': np.zeros((4, v, p, 4), np.float32),
             'voxel_coords': np.zeros((4, v, 3), np.int32),
             'voxel_num_points': np.zeros((4, v), np.int32)}
    for i in range(4):
        vox, coords, cnt = gen.generate(points[i])
        batch['voxels'][i, :len(vox)] = vox
        batch['voxel_coords'][i, :len(vox)] = coords
        batch['voxel_num_points'][i, :len(vox)] = cnt
    batch['voxel_mask'] = batch['voxel_num_points'] > 0
    batch = {k: torch.from_numpy(a).to(cuda) for k, a in batch.items()}
    torch.manual_seed(0)
    backbone = VoxelBackBone8xSparse({'UPSTREAM_GEOMETRY': True}, 4,
                                     grid_size=tuple(gen.grid_size)).to(cuda).eval()
    loops = [0]
    per_tap = sparse_conv._tap_lookups

    def counted(*args):
        loops[0] += 1
        return per_tap(*args)
    monkeypatch.setattr(sparse_conv, '_tap_lookups', counted)
    before = _kernels.launch_counts()['sparse_rulebook']
    with torch.no_grad():
        got = backbone(dict(batch))['encoded_spconv_tensor']
        torch.cuda.synchronize()
        assert _kernels.launch_counts()['sparse_rulebook'] == before + 12
        assert loops[0] == 0
        with _kernels.plain_versions():
            want = backbone(dict(batch))['encoded_spconv_tensor']
    assert loops[0] == 12
    assert got.shape == (4, 2, 200, 176, 128)
    assert torch.equal(got, want)
