"""PointNet++ primitives as fixed-shape, mask-aware PyTorch ops.

Port of ``hvpr_tpu/ops/pointnet2.py``: furthest point sampling (exact, or
Morton-chunked through :func:`ops.pn2_select.fps_chunks`, kernel K5 on the
card), ball query (the lane-bucket rule through
:func:`ops.pn2_select.ball_query_bucket`, kernel K4 on the card, both radii
of a multi-scale level in one sweep, or the reference's first-by-index rule
in plain torch), grouping, and the 3-NN
feature propagation (plain torch: it is XLA in the JAX package on every
backend, not a TPU kernel). Grouping and interpolation gather through
:func:`ops.gather_rows.gather_rows`, whose backward sums without atomics
(kernel K12 on the card), so that a train step gives the same bits on
every run.

Padded points carry a validity mask: they are never sampled or grouped.
Selection outputs are integer indices and carry no gradient; the 3-NN
weights are computed from detached coordinates.
"""

import torch

from .gather_rows import gather_rows
from .pn2_select import _sq_dist, ball_query_bucket, ball_query_bucket2, fps_chunks

INF = 1e10


def _morton2(x, y):
    """Interleave two 10-bit ints into a 2D Morton (Z-order) code."""
    def split(v):
        v = (v | (v << 8)) & 0x00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F
        v = (v | (v << 2)) & 0x33333333
        v = (v | (v << 1)) & 0x55555555
        return v
    return split(x) | (split(y) << 1)


def _morton_order(xyz, mask):
    """(B, N) stable argsort of each scan's BEV Morton code over its valid
    extent (10 bits per axis); invalid points sort last."""
    big = torch.tensor(INF, dtype=xyz.dtype, device=xyz.device)
    lo = torch.where(mask[..., None], xyz, big).amin(dim=1)[:, :2]       # (B, 2)
    hi = torch.where(mask[..., None], xyz, -big).amax(dim=1)[:, :2]
    span = torch.clamp(hi - lo, min=1e-3)
    q = torch.clamp((xyz[..., :2] - lo[:, None]) / span[:, None] * 1023.0,
                    0, 1023).to(torch.int32)
    key = _morton2(q[..., 0], q[..., 1])
    key = torch.where(mask, key, 2 ** 30)
    return torch.argsort(key, dim=1, stable=True)


def furthest_point_sample(xyz, mask, npoint, num_chunks=1):
    """Farthest point sampling: exact (``num_chunks=1``), or Morton-chunked.

    For ``num_chunks=G > 1`` (reduced by halving until G divides N and
    npoint) the points are sorted by BEV Morton code and split into G
    contiguous chunks; each runs exact FPS for npoint/G samples, all chunks
    at once. Samples that land on invalid points (tail chunks) are replaced
    by the first valid sample.

    Args:
        xyz: (B, N, 3); mask: (B, N) bool; npoint, num_chunks: ints.
    Returns:
        (B, npoint) int64 indices.
    """
    xyz = xyz.detach().float()
    b, n, _ = xyz.shape
    g = max(1, num_chunks)
    while n % g or npoint % g:
        g //= 2
    if g <= 1:
        return fps_chunks(xyz, mask, npoint).long()

    order = _morton_order(xyz, mask)                                  # (B, N)
    pts_c = torch.gather(xyz, 1, order[..., None].expand(-1, -1, 3)
                         ).reshape(b * g, n // g, 3)
    m_c = torch.gather(mask, 1, order).reshape(b * g, n // g)
    local = fps_chunks(pts_c, m_c, npoint // g).long().reshape(b, g, npoint // g)
    base = torch.arange(g, device=xyz.device)[:, None] * (n // g)
    idx = torch.gather(order, 1, (local + base).reshape(b, -1))       # (B, npoint)
    ok = torch.gather(mask, 1, idx)
    fallback = torch.gather(idx, 1, ok.to(torch.int8).argmax(dim=1, keepdim=True))
    return torch.where(ok, idx, fallback)


def ball_query(radius, nsample, xyz, new_xyz, mask, semantics='auto'):
    """For each centre, up to ``nsample`` points within ``radius``.

    ``semantics``: ``'auto'`` and ``'bucket'`` take the lane-bucket rule of
    :func:`ops.pn2_select.ball_query_bucket` (the TPU's shipped choice, kept
    on every device); ``'first'`` takes the first ``nsample`` in-radius
    points by index (the reference CUDA rule), in plain torch.

    Returns:
        idx (B, S, nsample) int64 (empty slots repeat the first hit, 0 when
        none); cnt (B, S) int32 genuine neighbours.
    """
    if semantics not in ('auto', 'first', 'bucket'):
        raise ValueError(semantics)
    if semantics != 'first':
        idx, cnt = ball_query_bucket(radius, nsample, xyz, new_xyz, mask)
        return idx.long(), cnt
    xyz, new_xyz = xyz.detach().float(), new_xyz.detach().float()
    n = xyz.shape[1]
    d2 = _sq_dist(new_xyz[:, :, None, :], xyz[:, None, :, :])
    in_ball = (d2 < radius * radius) & mask[:, None, :]
    key = torch.where(in_ball, torch.arange(n, device=xyz.device), n)
    key, _ = torch.sort(key, dim=-1)
    key = key[..., :nsample]
    found = key < n
    cnt = found.sum(dim=-1).to(torch.int32)
    idx = torch.where(found, key, key[..., 0:1])
    return torch.where(found[..., 0:1], idx, 0), cnt


def ball_query_msg(radii, nsamples, xyz, new_xyz, mask, semantics='auto'):
    """:func:`ball_query` for each (radius, nsample) of a multi-scale
    grouping level, over the same points and centres: [(idx, cnt), ...].
    Under the lane-bucket rule a level of two radii is one sweep
    (:func:`ops.pn2_select.ball_query_bucket2`, one launch of K4 on the
    card), with the outputs of one call per radius."""
    if semantics not in ('auto', 'first', 'bucket'):
        raise ValueError(semantics)
    if semantics != 'first' and len(radii) == 2:
        return [(idx.long(), cnt)
                for idx, cnt in ball_query_bucket2(radii, nsamples, xyz, new_xyz, mask)]
    return [ball_query(r, ns, xyz, new_xyz, mask, semantics=semantics)
            for r, ns in zip(radii, nsamples)]


def group_points(features, idx):
    """Gather (B, N, C) features at (B, S, K) or (B, S) indices; the
    gradient sums each point's contributions in a fixed order
    (:func:`ops.gather_rows.gather_rows`, kernel K12 on the card)."""
    b = features.shape[0]
    out = gather_rows(features, idx.reshape(b, -1))
    return out.reshape(*idx.shape, features.shape[-1])


def three_nn(unknown, known, known_mask):
    """3 nearest valid known points of each unknown point.

    The matmul form ``|u|^2 + |k|^2 - 2 u.k`` on coordinates centred on the
    valid-known mean, as the JAX package computes it.

    Returns:
        dist (B, N, 3) f32 distances; idx (B, N, 3) int64.
    """
    u = unknown.detach().float()
    k = known.detach().float()
    m = known_mask[..., None]
    ctr = (torch.where(m, k, 0.0).sum(dim=1, keepdim=True)
           / torch.clamp(known_mask.sum(dim=1), min=1)[:, None, None])
    uc = u - ctr
    kc = torch.where(m, k - ctr, 0.0)
    d2 = ((uc * uc).sum(dim=-1)[:, :, None] + (kc * kc).sum(dim=-1)[:, None, :]
          - 2.0 * torch.bmm(uc, kc.transpose(1, 2)))                  # (B, N, S)
    d2 = torch.where(known_mask[:, None, :], d2, INF)
    neg_d, idx = torch.topk(-d2, 3, dim=-1)
    return torch.sqrt(torch.clamp(-neg_d, min=0.0)), idx


def three_interpolate(features, idx, weight):
    """(B, S, C) features, (B, N, 3) idx and weights -> (B, N, C)."""
    return (group_points(features, idx) * weight[..., None]).sum(dim=2)


def three_nn_interpolate_weights(dist):
    """PointNet++ 3-NN weights: 1/d^2, normalized."""
    recip = 1.0 / torch.clamp(dist ** 2, min=1e-8)
    return recip / recip.sum(dim=-1, keepdim=True)
