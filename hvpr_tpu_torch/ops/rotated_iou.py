"""Rotated BEV / 3D IoU of box sets (plain PyTorch).

Port of ``hvpr_tpu/ops/rotated_iou.py`` (``boxes_iou_bev``, ``boxes_iou3d``):
the intersection area of two convex quads by Green's theorem over the
boundary of the intersection,

    2 * Area(P n Q) = sum over edges e of P of cross(s_e, t_e)
                    + sum over edges e of Q of cross(s_e, t_e),

where [s_e, t_e] is the part of edge e inside the other quad, found by
clipping the edge's parameter interval against the other box's 4 half-planes.
P's edges clip against a closed Q, Q's against the open interior of P, so a
shared boundary counts once. Every intermediate is an (N, M) plane.
"""

import torch

# robustness margin on half-plane tests, edge_length * meters (as in JAX)
_EPS = 1e-3


def box_to_corners_bev(boxes):
    """(..., 5) [x, y, dx, dy, heading] -> (..., 4, 2) corners, CCW."""
    x, y, dx, dy, r = boxes.unbind(-1)
    cosa, sina = torch.cos(r), torch.sin(r)
    lx = torch.stack([dx, dx, -dx, -dx], dim=-1) * 0.5
    ly = torch.stack([-dy, dy, dy, -dy], dim=-1) * 0.5
    cx = x[..., None] + lx * cosa[..., None] - ly * sina[..., None]
    cy = y[..., None] + lx * sina[..., None] + ly * cosa[..., None]
    return torch.stack([cx, cy], dim=-1)


def _edge_contributions(cp, cq, strict):
    """(N, M) sum of cross(s_e, t_e) over the 4 edges of each P clipped to Q."""
    q2 = torch.roll(cq, -1, dims=1)
    ux = q2[..., 0] - cq[..., 0]                    # (M, 4)
    uy = q2[..., 1] - cq[..., 1]
    c = uy * cq[..., 0] - ux * cq[..., 1]
    total = 0.0
    for e in range(4):
        ax, ay = cp[:, e, 0], cp[:, e, 1]
        bx, by = cp[:, (e + 1) % 4, 0], cp[:, (e + 1) % 4, 1]
        dxe, dye = bx - ax, by - ay
        t_lo = torch.zeros((), dtype=cp.dtype, device=cp.device)
        t_hi = torch.ones((), dtype=cp.dtype, device=cp.device)
        empty = torch.zeros((), dtype=torch.bool, device=cp.device)
        degenerate = torch.zeros((), dtype=torch.bool, device=cp.device)
        for h in range(4):
            fa = ux[None, :, h] * ay[:, None] - uy[None, :, h] * ax[:, None] + c[None, :, h]
            fb = ux[None, :, h] * by[:, None] - uy[None, :, h] * bx[:, None] + c[None, :, h]
            if strict:
                a_out, b_out = fa < _EPS, fb < _EPS
            else:
                a_out, b_out = fa < -_EPS, fb < -_EPS
                # an anti-parallel boundary-collinear edge: the quads only
                # abut along it, so its zero-area traversal is dropped
                anti = (ux[None, :, h] * dxe[:, None]
                        + uy[None, :, h] * dye[:, None]) < 0
                near = (fa.abs() < _EPS) & (fb.abs() < _EPS)
                degenerate = degenerate | (near & anti)
            empty = empty | (a_out & b_out)
            denom = fa - fb
            t_cross = fa / torch.where(denom == 0, 1.0, denom)
            t_lo = torch.maximum(t_lo, torch.where(a_out & ~b_out, t_cross, 0.0))
            t_hi = torch.minimum(t_hi, torch.where(b_out & ~a_out, t_cross, 1.0))
        keep = (~empty) & (~degenerate) & (t_hi > t_lo)
        p0x = ax[:, None] + t_lo * dxe[:, None]
        p0y = ay[:, None] + t_lo * dye[:, None]
        p1x = ax[:, None] + t_hi * dxe[:, None]
        p1y = ay[:, None] + t_hi * dye[:, None]
        total = total + torch.where(keep, p0x * p1y - p0y * p1x, 0.0)
    return total


def boxes_overlap_bev(boxes_a, boxes_b):
    """(N, 7+) x (M, 7+) -> (N, M) rotated BEV intersection areas."""
    cols = [0, 1, 3, 4, 6]
    ca = box_to_corners_bev(boxes_a[:, cols])
    cb = box_to_corners_bev(boxes_b[:, cols])
    two_area = (_edge_contributions(ca, cb, strict=False)
                + _edge_contributions(cb, ca, strict=True).t())
    cap = torch.minimum((boxes_a[:, 3] * boxes_a[:, 4])[:, None],
                        (boxes_b[:, 3] * boxes_b[:, 4])[None, :])
    return torch.minimum(torch.clamp(0.5 * two_area, min=0.0), cap)


def boxes_iou_bev(boxes_a, boxes_b):
    """Pairwise rotated BEV IoU, (N, 7) x (M, 7) -> (N, M)."""
    overlap = boxes_overlap_bev(boxes_a, boxes_b)
    area_a = (boxes_a[:, 3] * boxes_a[:, 4])[:, None]
    area_b = (boxes_b[:, 3] * boxes_b[:, 4])[None, :]
    return overlap / torch.clamp(area_a + area_b - overlap, min=1e-6)


def boxes_iou3d(boxes_a, boxes_b):
    """Pairwise 3D IoU (z-center boxes), (N, 7) x (M, 7) -> (N, M)."""
    overlap_bev = boxes_overlap_bev(boxes_a, boxes_b)
    a_zmin = (boxes_a[:, 2] - boxes_a[:, 5] / 2)[:, None]
    a_zmax = (boxes_a[:, 2] + boxes_a[:, 5] / 2)[:, None]
    b_zmin = (boxes_b[:, 2] - boxes_b[:, 5] / 2)[None, :]
    b_zmax = (boxes_b[:, 2] + boxes_b[:, 5] / 2)[None, :]
    overlap_h = torch.clamp(torch.minimum(a_zmax, b_zmax)
                            - torch.maximum(a_zmin, b_zmin), min=0.0)
    overlap_3d = overlap_bev * overlap_h
    vol_a = (boxes_a[:, 3] * boxes_a[:, 4] * boxes_a[:, 5])[:, None]
    vol_b = (boxes_b[:, 3] * boxes_b[:, 4] * boxes_b[:, 5])[None, :]
    return overlap_3d / torch.clamp(vol_a + vol_b - overlap_3d, min=1e-6)
