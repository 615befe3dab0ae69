"""The numbers that decide ``correct`` for an inference cell.

For each sampled scan the reference recomputes the dense head from the raw
points and the weights, and the program's head outputs and detections are
judged against it:

- ``cls_gap``: rms of the class-logit error over every anchor and class,
  over the standard deviation of the reference's logits across them (a
  bias common to all anchors is not a scale of the head's work);
- ``box_gap``: the largest over the 7 box residuals of the rms error over
  the standard deviation of the reference's residual. The program's
  decoded boxes are encoded again on the anchors; the heading is compared
  modulo pi, so that a direction bin is judged apart;
- ``dir_flips``: the share of anchors whose heading lies on the other
  direction bin from the reference's;
- ``det_unmatched``: detections that are not, bit for bit, the box of a
  candidate anchor (score at or above SCORE_THRESH) with its class label and
  its score; an exact comparison;
- ``det_mismatch``: the detections against a greedy rotated NMS (float64
  IoU, :mod:`.nms`) of the program's own candidates: the symmetric
  difference of the two sets of anchors over the size of the judge's set.

An anchor's score and label are OpenPCDet's with MULTI_CLASSES_NMS off,
as the program post-processes: the largest of the sigmoids of its class
logits, and that class + 1 (:func:`scores_and_labels`). Each number is the
largest over the sampled scans.
"""

import math

import numpy as np
import torch

from .model import encode
from .nms import greedy_nms

LIMIT_KEYS = ('cls_gap', 'box_gap', 'dir_flips', 'det_mismatch', 'det_unmatched')
SCORE_RTOL = 2.0 ** -20


def _rms(x):
    return float(torch.sqrt(torch.mean(x.double() ** 2)))


def _std(x):
    return float(x.double().std())


def scores_and_labels(cls):
    """(A,) scores and (A,) int64 labels of (A, C) class logits: the best
    class's sigmoid and that class + 1."""
    scores, best = torch.sigmoid(cls.float()).max(dim=-1)
    return scores, best + 1


def head_gaps(prog_cls, prog_boxes, ref, anchors):
    """cls_gap, box_gap and dir_flips of one scan."""
    cls_gap = _rms(prog_cls - ref['cls']) / max(_std(ref['cls']), 1e-30)
    enc = encode(prog_boxes.double(), anchors.double())
    res = ref['res'].double()
    gaps = [_rms(enc[:, c] - res[:, c]) / max(_std(res[:, c]), 1e-30) for c in range(6)]
    d = prog_boxes[:, 6].double() - ref['boxes'][:, 6].double()
    d = d - 2 * math.pi * torch.round(d / (2 * math.pi))
    flips = d.abs() > math.pi / 2
    cont = d - math.pi * torch.round(d / math.pi)
    gaps.append(_rms(cont) / max(_std(res[:, 6]), 1e-30))
    return cls_gap, max(gaps), float(flips.double().mean())


def detection_gaps(prog_cls, prog_boxes, det, post_cfg):
    """det_unmatched, det_mismatch, the judge's and the program's
    detection counts of one scan; ``det`` holds the program's pred_boxes,
    pred_scores, pred_labels, pred_mask on the host."""
    nms = post_cfg['NMS_CONFIG']
    thresh = float(post_cfg['SCORE_THRESH'])
    scores, best = scores_and_labels(prog_cls)
    judge = greedy_nms(scores, prog_boxes, thresh, float(nms['NMS_THRESH']),
                       int(nms['NMS_PRE_MAXSIZE']), int(nms['NMS_POST_MAXSIZE']))
    cand = torch.nonzero(scores >= thresh).squeeze(1)
    cand_boxes = prog_boxes[cand].float().cpu().numpy()
    row_of = {cand_boxes[i].tobytes(): int(cand[i]) for i in range(len(cand_boxes))}
    host_scores, host_labels = scores.cpu(), best.cpu()
    mask = det['pred_mask'].numpy().astype(bool)
    boxes = det['pred_boxes'].numpy()[mask][:, :7].astype(np.float32)
    det_scores = det['pred_scores'].numpy()[mask]
    labels = det['pred_labels'].numpy()[mask]
    unmatched, found = 0, set()
    for box, score, label in zip(boxes, det_scores, labels):
        a = row_of.get(np.ascontiguousarray(box).tobytes())
        if a is None or int(label) != int(host_labels[a]) or a in found \
                or abs(float(score) - float(host_scores[a])) > SCORE_RTOL * abs(float(score)):
            unmatched += 1
            continue
        found.add(a)
    want = set(int(a) for a in judge)
    mismatch = len(found ^ want) / max(1, len(want))
    return unmatched, mismatch, len(want), len(boxes)


def compare(samples, reference, post_cfg):
    """The numbers of :data:`LIMIT_KEYS` (largest over the scans) and the
    judge's and the program's detection counts of each scan. ``samples``:
    [(points (N, 4) numpy, program cls (A, C), program boxes (A, 7),
    program detections dict)]."""
    worst = dict.fromkeys(LIMIT_KEYS, 0.0)
    kept, returned = [], []
    for points, cls, boxes, det in samples:
        ref = reference.forward(points)
        cls = cls.to(reference.device)
        boxes = boxes.to(reference.device)
        gaps = head_gaps(cls, boxes, ref, reference.anchors)
        unmatched, mismatch, n, n_program = detection_gaps(cls, boxes, det, post_cfg)
        kept.append(n)
        returned.append(n_program)
        for key, val in zip(LIMIT_KEYS, (*gaps, mismatch, unmatched)):
            worst[key] = max(worst[key], float(val))
        del ref
    return worst, kept, returned
