"""Bucketed ball query (kernel K4), bucketed 3-NN (kernel K11) and
chunk-parallel FPS (kernel K5).

Port of ``hvpr_tpu/ops/pn2_select.py`` ``ball_query_bucket``,
``three_nn_bucket`` and ``fps_chunks_pallas``. On a CUDA tensor
:func:`ball_query_bucket` launches ``csrc/ball_query.cu`` (and
:func:`ball_query_bucket2` the same kernel for two radii in one sweep),
:func:`three_nn_bucket` ``csrc/three_nn.cu`` and :func:`fps_chunks`
``csrc/fps_chunks.cu``; on a CPU tensor each runs its plain version.

Ball query semantics (the TPU's lane buckets, bucket = point index mod 128):
for each centre, the first in-radius valid point of each of the ``nsample``
lowest-indexed non-empty buckets, in ascending index order; empty slots are
back-filled with the first hit (0 when there is none), and ``cnt`` counts the
genuine hits. Squared distances are ``(dx*dx + dy*dy) + dz*dz`` in f32 with
every product and sum rounded (no FMA), compared ``< float32(r*r)``.

3-NN semantics (``_sweep_kernel`` mode 'nn'): the key of a known point is
its squared distance, 1e30 when it is masked; each bucket keeps its least
key and the lowest index reaching it, and a bucket whose key stays 1e30
(all masked, or empty when S < 128) reports index 0. The 3 buckets of least
key win, ties to the lower bucket; distances are ``sqrt(min(key, 1e10))``.
The model's feature propagation keeps the exact ``pointnet2.three_nn``, as
the JAX package does.

FPS rules (``_fps_kernel``): each chunk starts at its first valid row, or at
its last row if none is valid; invalid rows score -BIG; each step takes the
row of largest running minimum distance, ties to the lowest row. K5 gives a
set of up to 8192 rows one block (up to 256 rows, one warp), its rows in
registers; a longer set (exact FPS over a whole scan) takes its long path,
a cluster of 8 blocks that holds 32,768 rows in registers and streams the
rest from device memory, so any set length runs.

Both are selection machinery: their outputs are integer indices and carry no
gradient.
"""

import ctypes

import torch

from ..utils import flops
from . import _kernels

NUM_BUCKETS = 128
_BIG = 1e30
_INF = 1e10              # ops/pointnet2.INF, the masked 3-NN distance cap
_FPS_MAX_ROWS = 8192     # rows of a set K5's one-block path holds; longer
                         # sets take its long path


def _round_up(x, m):
    return (x + m - 1) // m * m


def _sq_dist(a, b):
    """(dx*dx + dy*dy) + dz*dz over the last axis (3), every op rounded."""
    d = a - b
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    return (dx * dx + dy * dy) + dz * dz


def ball_query_bucket_plain(radius, nsample, xyz, new_xyz, mask, chunk=512):
    """Plain version: per-centre bucket minima of the in-radius indices, then
    the ``nsample`` smallest (the math of ``ball_query_bucket_xla``)."""
    b, n, _ = xyz.shape
    r2 = torch.tensor(float(radius) * float(radius), dtype=torch.float32)
    np_ = _round_up(n, NUM_BUCKETS)
    gidx = torch.arange(n, device=xyz.device, dtype=torch.float32)
    keys = []
    for s0 in range(0, new_xyz.shape[1], chunk):
        cent = new_xyz[:, s0:s0 + chunk].float()
        d2 = _sq_dist(cent[:, :, None, :], xyz.float()[:, None, :, :])   # (B, Sc, N)
        hit = (d2 < r2.to(d2.device)) & mask[:, None, :]
        key = torch.where(hit, gidx, _BIG)
        if np_ != n:
            key = torch.nn.functional.pad(key, (0, np_ - n), value=_BIG)
        keys.append(key.reshape(b, -1, np_ // NUM_BUCKETS, NUM_BUCKETS)
                    .amin(dim=2))                                      # (B, Sc, 128)
    key = torch.cat(keys, dim=1)
    k_sel = torch.sort(key, dim=-1).values[..., :nsample]
    found = k_sel < _BIG * 0.5
    idx = torch.where(found, k_sel, 0.0).to(torch.int32)
    idx = torch.where(found, idx, idx[..., 0:1])
    cnt = found.sum(dim=-1).to(torch.int32)
    return idx, cnt


def _check_nsamples(*nsamples):
    for nsample in nsamples:
        if not 1 <= nsample <= NUM_BUCKETS:
            raise ValueError(f'ball_query: nsample {nsample} outside [1, 128]')


def _ball_query_inputs(xyz, new_xyz, mask):
    """Check a kernel call's inputs; returns them contiguous with (B, N, S)."""
    xyz = xyz.detach().float().contiguous()
    new_xyz = new_xyz.detach().float().contiguous()
    mask = mask.contiguous()
    _kernels.check_cuda_input('ball_query xyz', xyz, torch.float32, 3)
    _kernels.check_cuda_input('ball_query new_xyz', new_xyz, torch.float32, 3)
    _kernels.check_cuda_input('ball_query mask', mask, torch.bool, 2)
    b, n, _ = xyz.shape
    if (xyz.shape[2] != 3 or new_xyz.shape[0] != b or new_xyz.shape[2] != 3
            or mask.shape != (b, n) or len({xyz.device, new_xyz.device,
                                            mask.device}) != 1):
        raise ValueError(f'ball_query: xyz {tuple(xyz.shape)}, new_xyz '
                         f'{tuple(new_xyz.shape)}, mask {tuple(mask.shape)}')
    return xyz, new_xyz, mask, (b, n, new_xyz.shape[1])


def _ball_query_outputs(nsample, b, s, device):
    return (torch.empty(b, s, nsample, dtype=torch.int32, device=device),
            torch.empty(b, s, dtype=torch.int32, device=device))


def _r2(radius):
    """f32(radius * radius), the bound the plain version compares with."""
    return ctypes.c_float(float(radius) * float(radius))


def _ball_query_plain(radius, nsample, xyz, new_xyz, mask):
    _check_nsamples(nsample)
    return ball_query_bucket_plain(radius, nsample, xyz.detach(), new_xyz.detach(), mask)


@_kernels.wrapper('ball_query', _ball_query_plain,
                  lambda out, radius, nsample, xyz, new_xyz, mask: flops.ball_query_work(
                      *xyz.shape[:2], new_xyz.shape[1], (nsample,),
                      float(flops.ball_stop(*out, nsample, xyz.shape[1]).sum())), on=2)
def ball_query_bucket(radius, nsample, xyz, new_xyz, mask):
    """Bucketed ball query.

    Args:
        radius: float; nsample: int, <= 128.
        xyz: (B, N, 3) f32 support points; new_xyz: (B, S, 3) f32 centres;
        mask: (B, N) bool support validity.
    Returns:
        idx (B, S, nsample) int32, cnt (B, S) int32.
    """
    _check_nsamples(nsample)
    xyz, new_xyz, mask, (b, n, s) = _ball_query_inputs(xyz, new_xyz, mask)
    idx, cnt = _ball_query_outputs(nsample, b, s, xyz.device)
    if b * s == 0:
        return idx, cnt
    _kernels.launch('ball_query', xyz, _kernels.ptr(xyz), _kernels.ptr(new_xyz),
                    _kernels.ptr(mask), _kernels.ptr(idx), _kernels.ptr(cnt), _r2(radius), b,
                    n, s, nsample)
    return idx, cnt


def _ball_query2_plain(radii, nsamples, xyz, new_xyz, mask):
    (r0, r1), (ns0, ns1) = radii, nsamples
    _check_nsamples(ns0, ns1)
    return tuple(ball_query_bucket_plain(r, ns, xyz.detach(), new_xyz.detach(), mask)
                 for r, ns in ((r0, ns0), (r1, ns1)))


def _ball_query2_work(out, radii, nsamples, xyz, new_xyz, mask):
    # a centre's sweep runs until both radii have their buckets
    return flops.ball_query_work(
        *xyz.shape[:2], new_xyz.shape[1], nsamples, float(torch.stack(
            [flops.ball_stop(idx, cnt, ns, xyz.shape[1])
             for (idx, cnt), ns in zip(out, nsamples)]).amax(dim=0).sum()))


@_kernels.wrapper('ball_query', _ball_query2_plain, _ball_query2_work, on=2)
def ball_query_bucket2(radii, nsamples, xyz, new_xyz, mask):
    """Both radii of a multi-scale grouping level in one sweep (one launch of
    K4): the same outputs as ``ball_query_bucket`` called once per radius.

    Args:
        radii, nsamples: two floats and two ints (each <= 128); the rest as
            :func:`ball_query_bucket`.
    Returns:
        ((idx, cnt) of radii[0], (idx, cnt) of radii[1]).
    """
    (r0, r1), (ns0, ns1) = radii, nsamples
    _check_nsamples(ns0, ns1)
    xyz, new_xyz, mask, (b, n, s) = _ball_query_inputs(xyz, new_xyz, mask)
    out0 = _ball_query_outputs(ns0, b, s, xyz.device)
    out1 = _ball_query_outputs(ns1, b, s, xyz.device)
    if b * s == 0:
        return out0, out1
    _kernels.launch('ball_query2', xyz, _kernels.ptr(xyz), _kernels.ptr(new_xyz),
                    _kernels.ptr(mask), _kernels.ptr(out0[0]), _kernels.ptr(out0[1]), _r2(r0),
                    ns0, _kernels.ptr(out1[0]), _kernels.ptr(out1[1]), _r2(r1), ns1, b, n, s)
    return out0, out1


def three_nn_bucket_plain(unknown, known, known_mask, chunk=512):
    """Plain version: per-unknown bucket minima of the keys over the whole
    known axis, the lowest index reaching each, then the 3 least buckets."""
    b, s, _ = known.shape
    sp = _round_up(s, NUM_BUCKETS)
    neg = torch.where(known_mask, 0.0, -_BIG).to(torch.float32)
    gidx = torch.arange(sp, device=known.device, dtype=torch.float32)
    keys, idxs = [], []
    for q0 in range(0, unknown.shape[1], chunk):
        u = unknown[:, q0:q0 + chunk].float()
        key = _sq_dist(u[:, :, None, :], known.float()[:, None, :, :]) - neg[:, None, :]
        if sp != s:
            key = torch.nn.functional.pad(key, (0, sp - s), value=_BIG)
        kr = key.reshape(b, -1, sp // NUM_BUCKETS, NUM_BUCKETS)
        kmin = kr.amin(dim=2)                                          # (B, Qc, 128)
        pr = gidx.reshape(sp // NUM_BUCKETS, NUM_BUCKETS)
        pmin = torch.where(kr <= kmin[:, :, None, :], pr, _BIG).amin(dim=2)
        keys.append(kmin)
        # a bucket that never drops below 1e30 keeps the sweep's initial index
        idxs.append(torch.where(kmin < _BIG, pmin, 0.0))
    key, pidx = torch.cat(keys, dim=1), torch.cat(idxs, dim=1)
    key3, pos = torch.sort(key, dim=-1, stable=True)
    d2 = torch.clamp(key3[..., :3], max=_INF)
    idx = torch.gather(pidx, -1, pos[..., :3]).to(torch.int32).clamp(0, s - 1)
    return torch.sqrt(torch.clamp(d2, min=0.0)), idx


@_kernels.wrapper('three_nn_bucket',
                  lambda unknown, known, known_mask: three_nn_bucket_plain(
                      unknown.detach(), known.detach(), known_mask),
                  lambda out, unknown, known, known_mask: flops.three_nn_work(
                      *unknown.shape[:2], known.shape[1]), on=1)
def three_nn_bucket(unknown, known, known_mask):
    """Bucketed 3-NN, with the interface of ``pointnet2.three_nn``.

    Args:
        unknown: (B, N, 3) f32 query points; known: (B, S, 3) f32;
        known_mask: (B, S) bool.
    Returns:
        dist (B, N, 3) f32 and idx (B, N, 3) int32, neither with a gradient.
    """
    unknown = unknown.detach().float().contiguous()
    known = known.detach().float().contiguous()
    known_mask = known_mask.contiguous()
    _kernels.check_cuda_input('three_nn unknown', unknown, torch.float32, 3)
    _kernels.check_cuda_input('three_nn known', known, torch.float32, 3)
    _kernels.check_cuda_input('three_nn known_mask', known_mask, torch.bool, 2)
    b, s, _ = known.shape
    n = unknown.shape[1]
    if (known.shape[2] != 3 or unknown.shape[0] != b or unknown.shape[2] != 3
            or known_mask.shape != (b, s) or len({unknown.device, known.device,
                                                  known_mask.device}) != 1):
        raise ValueError(f'three_nn: unknown {tuple(unknown.shape)}, known '
                         f'{tuple(known.shape)}, known_mask {tuple(known_mask.shape)}')
    dist = torch.empty(b, n, 3, dtype=torch.float32, device=known.device)
    idx = torch.empty(b, n, 3, dtype=torch.int32, device=known.device)
    if b * n == 0:
        return dist, idx
    # the known points packed as (x, y, z, 0), masked ones and the padding
    # to a whole tile at +inf
    s_pad = _kernels.entry('three_nn_padded')(s)
    packed = torch.empty(b, s_pad, 4, dtype=torch.float32, device=known.device)
    _kernels.launch('three_nn_bucket', known, unknown.data_ptr(), known.data_ptr(),
                    known_mask.data_ptr(), packed.data_ptr(), dist.data_ptr(), idx.data_ptr(),
                    b, n, s)
    return dist, idx


def fps_chunks_plain(pts, valid, nsamp):
    """Plain version of :func:`fps_chunks`: the same loop over all chunks at
    once, (R, L) vectors per step."""
    r, l, _ = pts.shape
    p = pts.float()
    rows = torch.arange(l, device=pts.device)
    mind = torch.where(valid, _BIG, -_BIG).to(torch.float32)
    last = torch.where(valid, rows, l - 1).amin(dim=1)                  # (R,)
    out = torch.empty(r, nsamp, dtype=torch.int32, device=pts.device)
    ar = torch.arange(r, device=pts.device)
    for i in range(nsamp):
        out[:, i] = last.to(torch.int32)
        d = _sq_dist(p, p[ar, last][:, None, :])                       # (R, L)
        mind = torch.minimum(mind, d)
        mx = mind.amax(dim=1, keepdim=True)
        last = torch.where(mind == mx, rows, l - 1).amin(dim=1)
    return out


@_kernels.wrapper('fps_chunks',
                  lambda pts, valid, nsamp: fps_chunks_plain(pts.detach(), valid, nsamp),
                  lambda out, pts, valid, nsamp: flops.fps_work(*pts.shape[:2], nsamp))
def fps_chunks(pts, valid, nsamp):
    """Exact FPS inside each of R independent point sets.

    Args:
        pts: (R, L, 3) f32 point sets (Morton-sorted chunks, by the caller).
        valid: (R, L) bool.
        nsamp: samples per set.
    Returns:
        (R, nsamp) int32 local row indices.
    """
    pts = pts.detach().float().contiguous()
    valid = valid.contiguous()
    _kernels.check_cuda_input('fps_chunks pts', pts, torch.float32, 3)
    _kernels.check_cuda_input('fps_chunks valid', valid, torch.bool, 2)
    r, l, _ = pts.shape
    if pts.shape[2] != 3 or valid.shape != (r, l) or valid.device != pts.device:
        raise ValueError(f'fps_chunks: pts {tuple(pts.shape)}, valid '
                         f'{tuple(valid.shape)}')
    if l < 1:
        raise ValueError('fps_chunks: a set needs at least one row')
    out = torch.empty(r, nsamp, dtype=torch.int32, device=pts.device)
    if r * nsamp == 0:
        return out
    if l <= _FPS_MAX_ROWS:
        _kernels.launch('fps_chunks', pts, _kernels.ptr(pts), _kernels.ptr(valid),
                        _kernels.ptr(out), r, l, nsamp)
    else:
        # the running minima of the rows past the on-chip head
        tail = torch.empty(r, max(1, l - _kernels.entry('fps_long_head')()),
                           dtype=torch.float32, device=pts.device)
        _kernels.launch('fps_long', pts, _kernels.ptr(pts), _kernels.ptr(valid),
                        _kernels.ptr(tail), _kernels.ptr(out), r, l, nsamp)
    return out
