"""Config-driven NMS wrapper (port of ``class_agnostic_nms`` in
``hvpr_tpu/models/model_utils/model_nms_utils.py``)."""

import torch

from ...ops.nms import nms_bev_fixed


def class_agnostic_nms(box_scores, box_preds, nms_config, score_thresh=None):
    """One sample: score threshold -> top NMS_PRE_MAXSIZE -> rotated NMS ->
    NMS_POST_MAXSIZE slots.

    Returns keep_idx (post,), keep_mask (post,), num_kept () before the cap.
    """
    scores = box_scores
    if score_thresh is not None:
        scores = torch.where(box_scores >= score_thresh, box_scores, -torch.inf)
    return nms_bev_fixed(
        box_preds[:, :7], scores, float(nms_config['NMS_THRESH']),
        pre_maxsize=int(nms_config['NMS_PRE_MAXSIZE']),
        post_maxsize=int(nms_config['NMS_POST_MAXSIZE']))
