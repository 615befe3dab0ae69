"""Axis-aligned IoU target assigner.

Port of ``hvpr_tpu/models/dense_heads/target_assigner/
axis_aligned_target_assigner.py`` without ``POS_FRACTION`` subsampling
(``POS_FRACTION: -1``, hvpr.yaml's setting: no subsampling, no randomness).
Per class, anchors match the gt of highest nearest-BEV IoU; labels take the
reference's overwrite order: -1 < positives (>= matched threshold) <
background (< unmatched threshold) < force-matched best anchors of each gt.
Padded gt rows (all zeros) are masked out.
"""

import torch

from ....utils.box_utils import boxes3d_nearest_bev_iou


class AxisAlignedTargetAssigner:

    def __init__(self, model_cfg, class_names, box_coder, match_height=False):
        anchor_cfg = model_cfg['ANCHOR_GENERATOR_CONFIG']
        target_cfg = model_cfg['TARGET_ASSIGNER_CONFIG']
        if match_height:
            raise NotImplementedError('MATCH_HEIGHT is not ported')
        pos_fraction = target_cfg.get('POS_FRACTION', None)
        if pos_fraction is not None and float(pos_fraction) >= 0:
            raise NotImplementedError('POS_FRACTION subsampling is not ported')
        if target_cfg.get('NORM_BY_NUM_EXAMPLES', False):
            raise NotImplementedError('NORM_BY_NUM_EXAMPLES is not ported')
        self.box_coder = box_coder
        self.class_names = list(class_names)
        self.anchor_class_names = [c['class_name'] for c in anchor_cfg]
        self.matched = {c['class_name']: c['matched_threshold'] for c in anchor_cfg}
        self.unmatched = {c['class_name']: c['unmatched_threshold'] for c in anchor_cfg}

    def assign_targets(self, anchors_list, gt_boxes_with_classes):
        """
        Args:
            anchors_list: per class, a (nz, ny, nx, ns, nr, 7) tensor.
            gt_boxes_with_classes: (B, M, 8) [x..heading, class]; padded rows 0.
        Returns:
            dict of box_cls_labels (B, A) int64, box_reg_targets (B, A, code),
            reg_weights (B, A); anchors in (ny, nx, class, size, rot) order.
        """
        gt_boxes = gt_boxes_with_classes[..., :7]
        gt_classes = gt_boxes_with_classes[..., 7].long()
        gt_valid = gt_boxes_with_classes.abs().sum(dim=-1) > 0
        b = gt_boxes.shape[0]
        per_class = []
        for name, anchors in zip(self.anchor_class_names, anchors_list):
            nz, ny, nx, ns, nr, _ = anchors.shape
            flat = anchors.reshape(-1, 7)
            cls_mask = gt_valid & (gt_classes == self.class_names.index(name) + 1)
            outs = [self._assign_single(flat, gt_boxes[i], gt_classes[i], cls_mask[i],
                                        self.matched[name], self.unmatched[name])
                    for i in range(b)]
            per_class.append([torch.stack(t).reshape(b, nz * ny * nx, ns * nr, *t[0].shape[1:])
                              for t in zip(*outs)])
        labels, targets, weights = (torch.cat(t, dim=2) for t in zip(*per_class))
        return {'box_cls_labels': labels.reshape(b, -1),
                'box_reg_targets': targets.reshape(b, -1, targets.shape[-1]),
                'reg_weights': weights.reshape(b, -1)}

    def _assign_single(self, anchors, gt_boxes, gt_classes, cls_mask,
                       matched_threshold, unmatched_threshold):
        iou = boxes3d_nearest_bev_iou(anchors, gt_boxes)
        iou = torch.where(cls_mask[None, :], iou, -1.0)                   # (A, M)
        any_gt = cls_mask.any()
        a2g_max, a2g_arg = iou.max(dim=1)
        g2a_max = iou.amax(dim=0)
        g2a_max = torch.where(cls_mask & (g2a_max > 0), g2a_max, -1.0)
        force = ((iou == g2a_max[None, :]) & (g2a_max[None, :] > 0)).any(dim=1)
        matched_cls = gt_classes[a2g_arg]
        labels = torch.full_like(matched_cls, -1)
        labels = torch.where(a2g_max >= matched_threshold, matched_cls, labels)
        labels = torch.where(a2g_max < unmatched_threshold, 0, labels)
        labels = torch.where(force, matched_cls, labels)
        labels = torch.where(any_gt, labels, 0)
        fg = labels > 0
        targets = self.box_coder.encode(gt_boxes[a2g_arg], anchors)
        targets = torch.where(fg[:, None], targets, 0.0)
        return labels, targets, fg.float()
