"""Sub-stage profile of the eval post-processing on the card (port of
``tools/profile_post.py``).

    python -m hvpr_tpu_torch.tools.profile_post [--batch 8] [--iters 5]
        [--out FILE] [--device cuda]

Post-processing is the stage that holds most of a batch's time on the card
with many candidates. This times its parts, each over the batch (a loop
over the scans, as ``post_processing`` runs them), on seeded class logits
(normal, mean -4, std 1.5: ~11% of the anchors clear SCORE_THRESH) and
boxes over the point-cloud range, one (B, A) set at the anchors of
hvpr.yaml's head: ``sigmoid+thresh``; ``top_k`` (``ops/nms.py``
``preselect``: the live candidates among the NMS_PRE_MAXSIZE best);
``gather boxes``; ``iou`` (``ops/rotated_iou.py`` over the K x K
candidates); ``suppress loop`` (``ops/nms.py`` ``suppress``, the
host-synced fixed-point loop); ``compaction``; and ``nms_bev_fixed``
whole. Each row has its ms, GFLOP, GB and utilization (null on the CPU).
"""

import math

import numpy as np
import torch

from .. import resolve_device
from ..models.dense_heads.anchor_head_single import build_anchors
from ..models import DatasetMeta
from ..ops import nms
from ..ops.rotated_iou import boxes_iou_bev
from .profile_stages import (cli, counted, device_record, load_config, median_ms,
                             region_row)


def inputs(cfg, batch, device, seed=0):
    """(class logits (B, A, C), boxes (B, A, 7)) at the anchors of ``cfg``'s head."""
    meta = DatasetMeta(cfg.DATA_CONFIG, cfg.CLASS_NAMES)
    anchors, _ = build_anchors(cfg.MODEL.DENSE_HEAD, meta.grid_size, meta.point_cloud_range)
    a = sum(int(np.prod(x.shape[:-1])) for x in anchors)
    pcr = meta.point_cloud_range
    rng = np.random.default_rng(seed)
    logits = rng.normal(-4.0, 1.5, (batch, a, len(cfg.CLASS_NAMES))).astype(np.float32)
    boxes = np.zeros((batch, a, 7), np.float32)
    boxes[..., 0] = rng.uniform(pcr[0], pcr[3], (batch, a))
    boxes[..., 1] = rng.uniform(pcr[1], pcr[4], (batch, a))
    boxes[..., 2] = -1.0
    boxes[..., 3:6] = [3.9, 1.6, 1.56]
    boxes[..., 6] = rng.uniform(-math.pi, math.pi, (batch, a))
    return torch.from_numpy(logits).to(device), torch.from_numpy(boxes).to(device)


def run(cfg=None, batch=8, device='cuda', iters=5, seed=0):
    """{'batch', 'anchors', 'candidates_per_scan', 'stages': rows, ...}."""
    cfg = load_config() if cfg is None else cfg
    device = resolve_device(device)
    record, peaks = device_record(device)
    post = cfg.MODEL.POST_PROCESSING
    nms_cfg = post.NMS_CONFIG
    pre, post_max = int(nms_cfg.NMS_PRE_MAXSIZE), int(nms_cfg.NMS_POST_MAXSIZE)
    iou_thresh = float(nms_cfg.NMS_THRESH)
    logits, boxes = inputs(cfg, batch, device, seed)

    def threshold():
        s = torch.sigmoid(logits).amax(dim=-1)
        return torch.where(s >= post.SCORE_THRESH, s, -torch.inf)

    scores = threshold()
    picked = [nms.preselect(s, pre) for s in scores]
    boxes_k = [b[order] for b, (order, _) in zip(boxes, picked)]
    ious = [boxes_iou_bev(bk, bk) for bk in boxes_k]
    keeps = [nms.suppress(iou, valid, iou_thresh) for iou, (_, valid) in zip(ious, picked)]
    regions = [
        ('sigmoid+thresh', threshold),
        ('top_k', lambda: [nms.preselect(s, pre) for s in scores]),
        ('gather boxes', lambda: [b[order] for b, (order, _) in zip(boxes, picked)]),
        ('iou', lambda: [boxes_iou_bev(bk, bk) for bk in boxes_k]),
        ('suppress loop', lambda: [nms.suppress(iou, valid, iou_thresh)
                                   for iou, (_, valid) in zip(ious, picked)]),
        ('compaction', lambda: [nms.compact(keep, order, post_max)
                                for keep, (order, _) in zip(keeps, picked)]),
        ('nms_bev_fixed', lambda: [nms.nms_bev_fixed(b, s, iou_thresh, pre, post_max)
                                   for b, s in zip(boxes, scores)]),
    ]
    rows = []
    with torch.no_grad():
        for name, fn in regions:
            _, c = counted(fn)
            rows.append(region_row(name, median_ms(fn, device, iters), c, peaks))
    return {'batch': batch, 'anchors': logits.shape[1], 'nms_pre_maxsize': pre,
            'candidates_per_scan': [int(v.sum()) for _, v in picked], 'stages': rows,
            **record}


def main(argv=None):
    return cli(__doc__.splitlines()[0], run, 8, 5, argv)


if __name__ == '__main__':
    main()
