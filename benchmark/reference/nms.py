"""Rotated BEV IoU by polygon clipping, and greedy NMS, for judging detections.

The intersection of two rotated rectangles is one clipped against the
other's four half-planes (Sutherland-Hodgman), its area by the shoelace
formula, all in float64. Only pairs whose circumscribed circles meet are
clipped; the rest have no overlap. The NMS is the textbook greedy one:
candidates scoring at or above the threshold, the best ``pre_max`` of them
in descending order (equal scores keep the lower index first), each kept
unless a kept box before it overlaps it by more than ``iou_thresh``, the
first ``post_max`` survivors returned.
"""

import numpy as np
import torch

PAIR_BLOCK = 1 << 20


def corners(boxes):
    """(N, 7) boxes -> (N, 4, 2) BEV corners, counter-clockwise."""
    x, y, dx, dy, r = boxes[:, 0], boxes[:, 1], boxes[:, 3], boxes[:, 4], boxes[:, 6]
    lx = torch.stack([dx, dx, -dx, -dx], dim=-1) * 0.5
    ly = torch.stack([-dy, dy, dy, -dy], dim=-1) * 0.5
    c, s = torch.cos(r)[:, None], torch.sin(r)[:, None]
    return torch.stack([x[:, None] + lx * c - ly * s, y[:, None] + lx * s + ly * c], dim=-1)


def _clip(poly, n, a, b):
    """Clip (P, 8, 2) polygons of ``n`` (P,) vertices to the left of the
    directed lines a -> b (P, 2): the new polygons and counts."""
    slots = poly.shape[1]
    i = torch.arange(slots, device=poly.device)
    live = i[None, :] < n[:, None]
    nxt_i = torch.where(i[None, :] + 1 < n[:, None], i[None, :] + 1, 0)
    nxt = torch.gather(poly, 1, nxt_i[..., None].expand(-1, -1, 2))
    d = (b - a)[:, None, :]

    def side(p):
        return d[..., 0] * (p[..., 1] - a[:, None, 1]) - d[..., 1] * (p[..., 0] - a[:, None, 0])

    sc, sn = side(poly), side(nxt)
    inside_c, inside_n = sc >= 0, sn >= 0
    t = sc / torch.where(sc == sn, torch.ones_like(sc), sc - sn)
    cross = poly + (nxt - poly) * t[..., None]
    cand = torch.stack([poly, cross], dim=2).reshape(poly.shape[0], 2 * slots, 2)
    valid = torch.stack([live & inside_c, live & (inside_c != inside_n)],
                        dim=2).reshape(poly.shape[0], 2 * slots)
    order = torch.argsort((~valid).to(torch.int8), dim=1, stable=True)[:, :slots]
    return torch.gather(cand, 1, order[..., None].expand(-1, -1, 2)), \
        valid.sum(dim=1).clamp(max=slots)


def _area(poly, n):
    slots = poly.shape[1]
    i = torch.arange(slots, device=poly.device)
    nxt_i = torch.where(i[None, :] + 1 < n[:, None], i[None, :] + 1, 0)
    nxt = torch.gather(poly, 1, nxt_i[..., None].expand(-1, -1, 2))
    cr = poly[..., 0] * nxt[..., 1] - poly[..., 1] * nxt[..., 0]
    return 0.5 * torch.where(i[None, :] < n[:, None], cr, 0.0).sum(dim=1)


def pair_iou(ca, cb, area_a, area_b):
    """IoU of the pairs (P, 4, 2) x (P, 4, 2) of corners."""
    poly = torch.cat([ca, torch.zeros_like(ca)], dim=1)
    n = torch.full((ca.shape[0],), 4, dtype=torch.int64, device=ca.device)
    for e in range(4):
        poly, n = _clip(poly, n, cb[:, e], cb[:, (e + 1) % 4])
    inter = _area(poly, n).clamp(min=0.0)
    return inter / (area_a + area_b - inter).clamp(min=1e-12)


def overlapping_pairs(boxes):
    """(i, j, iou) over the pairs i < j of (K, 7) boxes whose IoU may be
    above 0, IoU in float64."""
    b = boxes.double()
    k = b.shape[0]
    radius = 0.5 * torch.sqrt(b[:, 3] ** 2 + b[:, 4] ** 2)
    cs = corners(b)
    area = b[:, 3] * b[:, 4]
    ii, jj, vals = [], [], []
    rows = max(1, PAIR_BLOCK // max(k, 1))
    for r0 in range(0, k, rows):
        r1 = min(k, r0 + rows)
        dist = torch.cdist(b[r0:r1, :2], b[:, :2])
        near = dist <= radius[r0:r1, None] + radius[None, :]
        rows_i = torch.arange(r0, r1, device=b.device)
        near &= rows_i[:, None] < torch.arange(k, device=b.device)[None, :]
        i, j = torch.nonzero(near, as_tuple=True)
        i = i + r0
        for p0 in range(0, i.numel(), PAIR_BLOCK):
            pi, pj = i[p0:p0 + PAIR_BLOCK], j[p0:p0 + PAIR_BLOCK]
            ii.append(pi)
            jj.append(pj)
            vals.append(pair_iou(cs[pi], cs[pj], area[pi], area[pj]))
    if not ii:
        empty = torch.zeros(0, dtype=torch.int64)
        return empty, empty, torch.zeros(0, dtype=torch.float64)
    return torch.cat(ii).cpu(), torch.cat(jj).cpu(), torch.cat(vals).cpu()


def greedy_nms(scores, boxes, score_thresh, iou_thresh, pre_max, post_max):
    """Indices (into ``scores``) of the kept boxes, in score order."""
    live = torch.nonzero(scores >= score_thresh).squeeze(1)
    order = live[torch.sort(scores[live], descending=True, stable=True).indices][:pre_max]
    if order.numel() == 0:
        return order.cpu()
    i, j, iou = overlapping_pairs(boxes[order])
    hit = (iou > iou_thresh).numpy()
    i, j = i.numpy()[hit], j.numpy()[hit]
    by_row = np.argsort(i, kind='stable')
    i, j = i[by_row], j[by_row]
    starts = np.searchsorted(i, np.arange(order.numel() + 1))
    alive = np.ones(order.numel(), dtype=bool)
    kept = []
    for r in range(order.numel()):
        if not alive[r]:
            continue
        kept.append(r)
        if len(kept) == post_max:
            break
        alive[j[starts[r]:starts[r + 1]]] = False
    return order.cpu()[torch.as_tensor(kept, dtype=torch.int64)]
