"""Config-driven NMS wrappers (port of ``class_agnostic_nms`` and
``multi_classes_nms`` in ``hvpr_tpu/models/model_utils/model_nms_utils.py``)."""

import torch

from ...ops.nms import nms_bev_fixed


def _thresholded(scores, score_thresh):
    if score_thresh is None:
        return scores
    return torch.where(scores >= score_thresh, scores, -torch.inf)


def class_agnostic_nms(box_scores, box_preds, nms_config, score_thresh=None):
    """One sample: score threshold -> top NMS_PRE_MAXSIZE -> rotated NMS ->
    NMS_POST_MAXSIZE slots.

    Returns keep_idx (post,), keep_mask (post,), num_kept () before the cap.
    """
    return nms_bev_fixed(
        box_preds[:, :7], _thresholded(box_scores, score_thresh),
        float(nms_config['NMS_THRESH']),
        pre_maxsize=int(nms_config['NMS_PRE_MAXSIZE']),
        post_maxsize=int(nms_config['NMS_POST_MAXSIZE']))


def multi_classes_nms(cls_scores, box_preds, nms_config, score_thresh=None):
    """One sample, one rotated NMS per class over that class's thresholded
    scores, each with its own NMS_PRE_MAXSIZE and NMS_POST_MAXSIZE.

    Args:
        cls_scores: (A, C) scores; box_preds: (A, 7+) boxes.
    Returns:
        boxes (C*post, 7+), scores (C*post,), labels (C*post,) int32
        (class c's slots are c + 1), mask (C*post,) bool, num_capped ()
        survivors dropped by the per-class caps, summed over the classes.
    """
    post_max = int(nms_config['NMS_POST_MAXSIZE'])
    outs = []
    num_capped = torch.zeros((), dtype=torch.int64, device=cls_scores.device)
    for c in range(cls_scores.shape[1]):
        keep_idx, keep_mask, num_kept = nms_bev_fixed(
            box_preds[:, :7], _thresholded(cls_scores[:, c], score_thresh),
            float(nms_config['NMS_THRESH']),
            pre_maxsize=int(nms_config['NMS_PRE_MAXSIZE']), post_maxsize=post_max)
        num_capped = num_capped + torch.clamp(num_kept - post_max, min=0)
        outs.append((box_preds[keep_idx], cls_scores[keep_idx, c],
                     torch.full_like(keep_idx, c + 1, dtype=torch.int32), keep_mask))
    boxes, scores, labels, mask = (torch.cat(t) for t in zip(*outs))
    return boxes, scores, labels, mask, num_capped
