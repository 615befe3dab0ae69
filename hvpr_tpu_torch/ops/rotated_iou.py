"""Rotated BEV / 3D IoU of box sets (kernel K13 on the card).

Port of ``hvpr_tpu/ops/rotated_iou.py`` (``boxes_iou_bev``, ``boxes_iou3d``):
the intersection area of two convex quads by Green's theorem over the
boundary of the intersection,

    2 * Area(P n Q) = sum over edges e of P of cross(s_e, t_e)
                    + sum over edges e of Q of cross(s_e, t_e),

where [s_e, t_e] is the part of edge e inside the other quad, found by
clipping the edge's parameter interval against the other box's 4 half-planes.
P's edges clip against a closed Q, Q's against the open interior of P, so a
shared boundary counts once. In the plain version (``*_plain``) every
intermediate is an (N, M) plane.

On CUDA float32 boxes :func:`boxes_overlap_bev` and :func:`boxes_iou_bev`
launch ``csrc/rotated_iou.cu`` (K13) once a call, after torch's cosine and
sine of the headings: the kernel makes each box's corners, half-planes and
area with the plain version's ops (:func:`box_records`) and repeats the
plain arithmetic pair by pair in its order, rounding as each torch op
does, so it gives the plain version's numbers bit for bit; it skips the
clip, whose result is then exactly 0, for the pairs that a half-plane of
each box separates. On CPU tensors the plain version runs; other dtypes
than float32 on the card raise. No caller differentiates through the IoU:
the kernel has no backward and refuses inputs that require grad. While the
recorder of ``utils/profiler.py`` is on, a call counts its pairs
(``nms.iou_pairs``) and, read at the record's drain, the pairs that took
the full clip (``nms.iou_clipped``).

``boxes_overlap_bev_cpu`` and ``boxes_bev_iou_cpu`` take numpy boxes on
the host (the KITTI evaluator) and run the native C++ library of
:mod:`hvpr_tpu_torch.native` where it builds, else a numpy twin of the same
formula (the JAX package's host fallback).
"""

import numpy as np
import torch

from ..native import geometry as native_geometry
from ..utils import flops, profiler
from . import _kernels

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


def half_planes(corners):
    """(M, 4, 2) corners -> (ux, uy, c), each (M, 4): edge k's direction and
    offset, ``ux * y - uy * x + c`` positive inside the box."""
    q2 = torch.roll(corners, -1, dims=1)
    ux = q2[..., 0] - corners[..., 0]
    uy = q2[..., 1] - corners[..., 1]
    c = uy * corners[..., 0] - ux * corners[..., 1]
    return ux, uy, c


def _edge_contributions(cp, planes_q, strict):
    """(N, M) sum of cross(s_e, t_e) over the 4 edges of each P (corners
    ``cp``) clipped to the half-planes ``planes_q`` of each Q."""
    ux, uy, c = planes_q
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


def boxes_overlap_bev_plain(boxes_a, boxes_b):
    """The plain version of :func:`boxes_overlap_bev`."""
    cols = [0, 1, 3, 4, 6]
    ca = box_to_corners_bev(boxes_a[:, cols])
    cb = box_to_corners_bev(boxes_b[:, cols])
    two_area = (_edge_contributions(ca, half_planes(cb), strict=False)
                + _edge_contributions(cb, half_planes(ca), strict=True).t())
    cap = torch.minimum((boxes_a[:, 3] * boxes_a[:, 4])[:, None],
                        (boxes_b[:, 3] * boxes_b[:, 4])[None, :])
    return torch.minimum(torch.clamp(0.5 * two_area, min=0.0), cap)


def boxes_iou_bev_plain(boxes_a, boxes_b):
    """The plain version of :func:`boxes_iou_bev`."""
    overlap = boxes_overlap_bev_plain(boxes_a, boxes_b)
    area_a = (boxes_a[:, 3] * boxes_a[:, 4])[:, None]
    area_b = (boxes_b[:, 3] * boxes_b[:, 4])[None, :]
    return overlap / torch.clamp(area_a + area_b - overlap, min=1e-6)


def box_records(boxes):
    """(N, 7+) boxes -> (N, 21): the BEV corners (8), the half-planes' ux,
    uy, c (4 each) and the area dx * dy, by the plain version's ops: what
    kernel K13 makes of each box (:func:`records_on_card`)."""
    corners = box_to_corners_bev(boxes[:, [0, 1, 3, 4, 6]])
    ux, uy, c = half_planes(corners)
    area = boxes[:, 3] * boxes[:, 4]
    return torch.cat([corners.reshape(boxes.shape[0], 8), ux, uy, c, area[:, None]], dim=1)


def _card_boxes(name, boxes, device):
    """(boxes, cos, sin of the headings): K13's inputs, checked. The sine
    and cosine are torch's, as the plain version takes them."""
    if boxes.device != device:
        raise ValueError(f'rotated_iou: {name} on {boxes.device}, expected {device}')
    if boxes.dtype != torch.float32:
        raise ValueError(f'rotated_iou: {name} is {boxes.dtype}, expected torch.float32')
    if boxes.dim() != 2 or boxes.shape[1] < 7 or (boxes.numel() and boxes.stride(1) != 1):
        raise ValueError(f'rotated_iou: {name} of shape {tuple(boxes.shape)} and strides '
                         f'{boxes.stride()}, expected (N, 7+) rows of adjacent floats')
    heading = boxes[:, 6]
    return boxes, torch.cos(heading), torch.sin(heading)


def records_on_card(boxes):
    """K13's records of (N, 7+) CUDA boxes as the kernel makes them, (N,
    21) like :func:`box_records`: for holding the kernel to it."""
    boxes, cosa, sina = _card_boxes('boxes', boxes, boxes.device)
    out = torch.empty(boxes.shape[0], 25, dtype=torch.float32, device=boxes.device)
    _kernels.launch('rotated_iou_records', out, _kernels.ptr(boxes), boxes.stride(0),
                    _kernels.ptr(cosa), _kernels.ptr(sina), boxes.shape[0], _kernels.ptr(out))
    return out[:, :21]


def _pairs_plain(boxes_a, boxes_b, iou):
    return (boxes_iou_bev_plain if iou else boxes_overlap_bev_plain)(boxes_a, boxes_b)


@_kernels.wrapper('rotated_iou', _pairs_plain,
                  lambda out, boxes_a, boxes_b, iou: flops.rotated_iou_work(
                      boxes_a.shape[0], boxes_b.shape[0], iou), no_backward=True)
def _pairs(boxes_a, boxes_b, iou):
    """(N, M) overlaps, or IoUs when ``iou``: K13 on the card, the plain
    version on the CPU."""
    a, cos_a, sin_a = _card_boxes('boxes_a', boxes_a, boxes_a.device)
    b, cos_b, sin_b = ((a, cos_a, sin_a) if boxes_b is boxes_a
                       else _card_boxes('boxes_b', boxes_b, boxes_a.device))
    n, m = a.shape[0], b.shape[0]
    out = torch.empty(n, m, dtype=torch.float32, device=a.device)
    if n == 0 or m == 0:
        return out
    # the pairs that took the full clip, counted on the device while the
    # recorder is on and read with the spans (utils/profiler.py)
    clipped = (torch.zeros((), dtype=torch.int64, device=a.device)
               if profiler.recording() else None)
    _kernels.launch('rotated_iou', out, _kernels.ptr(a), a.stride(0), _kernels.ptr(cos_a),
                    _kernels.ptr(sin_a), _kernels.ptr(b), b.stride(0), _kernels.ptr(cos_b),
                    _kernels.ptr(sin_b), _kernels.ptr(out), n, m, int(iou),
                    None if clipped is None else _kernels.ptr(clipped))
    if clipped is not None:
        profiler.count('nms.iou_pairs', n * m)
        profiler.count_device('nms.iou_clipped', clipped)
    return out


def boxes_overlap_bev(boxes_a, boxes_b):
    """(N, 7+) x (M, 7+) -> (N, M) rotated BEV intersection areas."""
    return _pairs(boxes_a, boxes_b, False)


def boxes_iou_bev(boxes_a, boxes_b):
    """Pairwise rotated BEV IoU, (N, 7) x (M, 7) -> (N, M)."""
    return _pairs(boxes_a, boxes_b, True)


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


def _corners_bev_np(boxes):
    """numpy twin of :func:`box_to_corners_bev`."""
    x, y, dx, dy, r = (boxes[..., i] for i in range(5))
    cosa, sina = np.cos(r), np.sin(r)
    lx = np.stack([dx, dx, -dx, -dx], axis=-1) * 0.5
    ly = np.stack([-dy, dy, dy, -dy], axis=-1) * 0.5
    cx = x[..., None] + lx * cosa[..., None] - ly * sina[..., None]
    cy = y[..., None] + lx * sina[..., None] + ly * cosa[..., None]
    return np.stack([cx, cy], axis=-1)


def _edge_contributions_np(cp, cq, strict):
    """numpy twin of :func:`_edge_contributions`, with the JAX package's
    numpy arithmetic (the clip parameters in float64)."""
    q2 = np.roll(cq, -1, axis=1)
    ux = q2[..., 0] - cq[..., 0]
    uy = q2[..., 1] - cq[..., 1]
    c = uy * cq[..., 0] - ux * cq[..., 1]
    total = 0.0
    for e in range(4):
        ax, ay = cp[:, e, 0], cp[:, e, 1]
        bx, by = cp[:, (e + 1) % 4, 0], cp[:, (e + 1) % 4, 1]
        dxe, dye = bx - ax, by - ay
        t_lo, t_hi = np.zeros(()), np.ones(())
        empty = degenerate = np.zeros((), dtype=bool)
        for h in range(4):
            fa = ux[None, :, h] * ay[:, None] - uy[None, :, h] * ax[:, None] + c[None, :, h]
            fb = ux[None, :, h] * by[:, None] - uy[None, :, h] * bx[:, None] + c[None, :, h]
            if strict:
                a_out, b_out = fa < _EPS, fb < _EPS
            else:
                a_out, b_out = fa < -_EPS, fb < -_EPS
                anti = (ux[None, :, h] * dxe[:, None] + uy[None, :, h] * dye[:, None]) < 0
                near = (np.abs(fa) < _EPS) & (np.abs(fb) < _EPS)
                degenerate = degenerate | (near & anti)
            empty = empty | (a_out & b_out)
            denom = fa - fb
            t_cross = fa / np.where(denom == 0, 1.0, denom)
            t_lo = np.maximum(t_lo, np.where(a_out & ~b_out, t_cross, 0.0))
            t_hi = np.minimum(t_hi, np.where(b_out & ~a_out, t_cross, 1.0))
        keep = (~empty) & (~degenerate) & (t_hi > t_lo)
        p0x = ax[:, None] + t_lo * dxe[:, None]
        p0y = ay[:, None] + t_lo * dye[:, None]
        p1x = ax[:, None] + t_hi * dxe[:, None]
        p1y = ay[:, None] + t_hi * dye[:, None]
        total = total + np.where(keep, p0x * p1y - p0y * p1x, 0.0)
    return total


def _overlap_bev_np(boxes_a, boxes_b):
    ca = _corners_bev_np(boxes_a[:, [0, 1, 3, 4, 6]])
    cb = _corners_bev_np(boxes_b[:, [0, 1, 3, 4, 6]])
    two_area = (_edge_contributions_np(ca, cb, strict=False)
                + _edge_contributions_np(cb, ca, strict=True).T)
    cap = np.minimum((boxes_a[:, 3] * boxes_a[:, 4])[:, None],
                     (boxes_b[:, 3] * boxes_b[:, 4])[None, :])
    return np.clip(0.5 * two_area, 0.0, cap).astype(np.float32)


def boxes_overlap_bev_cpu(boxes_a, boxes_b):
    """Host rotated-BEV intersection areas of numpy (N, 7) x (M, 7) boxes
    -> (N, M) float32, for the KITTI evaluator: the native C++ library when
    it builds, else the numpy twin of :func:`boxes_overlap_bev`."""
    boxes_a = np.asarray(boxes_a, dtype=np.float32)
    boxes_b = np.asarray(boxes_b, dtype=np.float32)
    if boxes_a.shape[0] == 0 or boxes_b.shape[0] == 0:
        return np.zeros((boxes_a.shape[0], boxes_b.shape[0]), dtype=np.float32)
    if native_geometry.available():
        return native_geometry.boxes_overlap_bev(boxes_a, boxes_b)
    return _overlap_bev_np(boxes_a, boxes_b)


def boxes_bev_iou_cpu(boxes_a, boxes_b):
    """Host rotated BEV IoU of numpy (N, 7) x (M, 7) boxes -> (N, M)
    float32: the native C++ library when it builds, else the numpy twin."""
    boxes_a = np.asarray(boxes_a, dtype=np.float32)
    boxes_b = np.asarray(boxes_b, dtype=np.float32)
    if boxes_a.shape[0] == 0 or boxes_b.shape[0] == 0:
        return np.zeros((boxes_a.shape[0], boxes_b.shape[0]), dtype=np.float32)
    if native_geometry.available():
        return native_geometry.boxes_iou_bev(boxes_a, boxes_b)
    overlap = _overlap_bev_np(boxes_a, boxes_b)
    area_a = (boxes_a[:, 3] * boxes_a[:, 4])[:, None]
    area_b = (boxes_b[:, 3] * boxes_b[:, 4])[None, :]
    return overlap / np.clip(area_a + area_b - overlap, 1e-6, None)
