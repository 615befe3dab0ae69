"""Greedy rotated BEV NMS with fixed-size outputs (plain PyTorch).

Port of ``hvpr_tpu/ops/nms.py`` ``nms_bev_fixed``/``_nms_topk``: exact top-k
pre-selection (a stable descending sort, so equal scores keep the lower
index first, as ``lax.top_k`` does), then greedy suppression as the unique
fixed point of ``keep <- valid & ~any_i(A[i, j] & keep[i])`` with
``A[i, j] = iou(i, j) > thresh and i < j`` over the score-sorted boxes.

Boxes scored ``-inf`` neither suppress nor survive, so only the live
candidates enter the IoU matrix: the result is the one the JAX package gets
at ``pre_maxsize`` (its ``NMS_STAGE_SIZES`` ladder exists to save TPU time on
exactly this and needs no port).

Each call is a span ``nms`` with the children ``nms.iou`` and
``nms.suppress`` (``utils/profiler.py``); it counts its live candidates
(``nms.live``), its rounds of suppression (``nms.rounds``) and its reads of
device values on the host (``host_syncs``: rounds + 3).
"""

import torch

from ..utils import profiler
from .rotated_iou import boxes_iou_bev


def preselect(scores, pre_maxsize):
    """The live candidates among the ``pre_maxsize`` best scores of one
    sample: (order, valid), indices in descending score order and which of
    them score above ``-inf`` (at least one row, as many as are live)."""
    k = min(pre_maxsize, scores.shape[0])
    order = torch.sort(scores, descending=True, stable=True).indices[:k]
    valid = scores[order] > -torch.inf
    n_live = max(1, profiler.host_read(int, valid.sum()))
    profiler.count('nms.live', n_live)
    return order[:n_live], valid[:n_live]


def suppress(iou, valid, thresh):
    """(K,) bool survivors of greedy suppression over score-sorted boxes
    with (K, K) IoUs ``iou``: the fixed point of the module docstring."""
    n_live = valid.shape[0]
    row = torch.arange(n_live, device=iou.device)
    suppressed_by = ((iou > thresh) & (row[:, None] < row[None, :])).float()
    valid_f = valid.float()
    cur = valid_f
    rounds = 0
    for rounds in range(1, n_live + 1):
        new = valid_f * ((cur @ suppressed_by) <= 0.0).float()
        if profiler.host_read(torch.equal, new, cur):
            break
        cur = new
    profiler.count('nms.rounds', rounds)
    return cur > 0.0


def compact(keep, order, post_maxsize):
    """(keep_idx, keep_mask) of :func:`nms_bev_fixed` from the survivors
    ``keep`` of the boxes at ``order``."""
    kept = profiler.host_read(torch.nonzero, keep).squeeze(1)[:post_maxsize]
    first = profiler.host_read(int, order[0])
    keep_idx = torch.full((post_maxsize,), first, dtype=torch.int64, device=order.device)
    keep_idx[:kept.numel()] = order[kept]
    keep_mask = torch.zeros(post_maxsize, dtype=torch.bool, device=order.device)
    keep_mask[:kept.numel()] = True
    return keep_idx, keep_mask


def nms_bev_fixed(boxes, scores, thresh, pre_maxsize=4096, post_maxsize=500,
                  scan=None, cls=None):
    """Rotated BEV NMS of one sample.

    Args:
        boxes: (N, 7) [x, y, z, dx, dy, dz, heading].
        scores: (N,) float; rows that must not enter carry ``-inf``.
        thresh: IoU suppression threshold.
        scan, cls: the scan of the batch and the class, attributes of the
            call's ``nms`` span.
    Returns:
        keep_idx (post_maxsize,) int64 indices into the inputs (slots past
        the kept ones hold the index of the top-scored box), keep_mask
        (post_maxsize,) bool, num_kept () int64 survivors before the cap.
    """
    with profiler.span('nms', scores, scan=scan, cls=cls):
        order, valid = preselect(scores, pre_maxsize)
        boxes_k = boxes[order]
        with profiler.span('nms.iou', boxes_k):
            iou = boxes_iou_bev(boxes_k, boxes_k)
        with profiler.span('nms.suppress', iou):
            keep = suppress(iou, valid, thresh)
        keep_idx, keep_mask = compact(keep, order, post_maxsize)
        return keep_idx, keep_mask, keep.sum()
