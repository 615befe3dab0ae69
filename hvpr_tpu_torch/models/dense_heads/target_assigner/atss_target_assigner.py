"""ATSS (Adaptive Training Sample Selection) target assigner.

Port of ``hvpr_tpu/models/dense_heads/target_assigner/atss_target_assigner.py``.
Each anchor set (class) runs its own selection, as upstream's loop over
sets: per gt, the ``topk`` anchors nearest its centre are candidates; a
candidate is positive when its IoU reaches the mean + unbiased std + 1e-6
of the candidates' IoUs and its centre lies inside the gt's BEV box; an
anchor takes its best-IoU positive gt, and each gt's best-IoU anchor is
forced to it (gt index order decides a shared best anchor: the highest
index wins). Padded gt rows (all zeros) are masked, never stripped. The
per-set outputs interleave per BEV location, the head's prediction layout.
Nearest-first ties take the lower anchor index, as ``lax.top_k`` does.
"""

import torch

from ....ops.rotated_iou import boxes_iou3d, boxes_iou_bev


class ATSSTargetAssigner:

    def __init__(self, topk, box_coder, match_height=False):
        self.topk = int(topk)
        self.box_coder = box_coder
        self.match_height = match_height

    def assign_targets(self, anchors_list, gt_boxes_with_classes, global_step=None):
        """anchors_list: per set a (nz, ny, nx, ns, nr, C) tensor; gt: (B, M, 8).
        Returns box_cls_labels (B, A), box_reg_targets (B, A, code) and
        reg_weights (B, A). ``global_step`` is taken for the axis-aligned
        assigner's call and unused: ATSS draws nothing."""
        gt_boxes = gt_boxes_with_classes[..., :7]
        gt_classes = gt_boxes_with_classes[..., 7].long()
        gt_valid = gt_boxes_with_classes.abs().sum(dim=-1) > 0
        b = gt_boxes.shape[0]
        per_set = []
        for anchors in anchors_list:
            nz, ny, nx, ns, nr, c = anchors.shape
            flat = anchors.reshape(-1, c)
            outs = [self._assign_single(flat, gt_boxes[i], gt_classes[i], gt_valid[i])
                    for i in range(b)]
            per_set.append([torch.stack(t).reshape(b, nz * ny * nx, ns * nr, *t[0].shape[1:])
                            for t in zip(*outs)])
        labels, targets, weights = (torch.cat(t, dim=2) for t in zip(*per_set))
        return {'box_cls_labels': labels.reshape(b, -1),
                'box_reg_targets': targets.reshape(b, -1, targets.shape[-1]),
                'reg_weights': weights.reshape(b, -1)}

    def _assign_single(self, anchors, gt_boxes, gt_classes, gt_valid):
        num_anchors = anchors.shape[0]
        m = gt_boxes.shape[0]
        iou = (boxes_iou3d if self.match_height else boxes_iou_bev)(anchors[:, :7], gt_boxes)
        iou = torch.where(gt_valid[None, :], iou, 0.0)                   # (A, M)
        d = anchors[:, None, 0:3] - gt_boxes[None, :, 0:3]
        dist = torch.where(gt_valid[None, :], torch.sqrt((d * d).sum(dim=-1)), 1e9)

        k = min(self.topk, num_anchors)
        topk_idx = torch.sort(dist.t(), dim=1, stable=True).indices[:, :k]   # (M, k)
        cand_iou = torch.gather(iou.t(), 1, topk_idx)
        thresh = cand_iou.mean(dim=1) + cand_iou.std(dim=1) + 1e-6      # unbiased std

        dx = anchors[:, None, 0] - gt_boxes[None, :, 0]
        dy = anchors[:, None, 1] - gt_boxes[None, :, 1]
        cosa = torch.cos(gt_boxes[None, :, 6])
        sina = torch.sin(gt_boxes[None, :, 6])
        lx = dx * cosa + dy * sina
        ly = -dx * sina + dy * cosa
        center_in = ((lx.abs() <= gt_boxes[None, :, 3] / 2)
                     & (ly.abs() <= gt_boxes[None, :, 4] / 2))

        is_cand = torch.zeros(m, num_anchors, dtype=torch.bool, device=anchors.device)
        is_cand.scatter_(1, topk_idx, True)
        pos = is_cand.t() & (iou >= thresh[None, :]) & center_in & gt_valid[None, :]

        masked_iou = torch.where(pos, iou, -1.0)
        best_gt = masked_iou.argmax(dim=1)
        fg = masked_iou.amax(dim=1) > 0

        # each gt's best anchor is forced to it when it overlaps at all
        gt_best_anchor = iou.argmax(dim=0)                               # (M,)
        force_ok = gt_valid & (iou.amax(dim=0) > 0)
        forced_gt = torch.full((num_anchors,), -1, dtype=torch.long, device=anchors.device)
        forced_gt = forced_gt.scatter_reduce(
            0, gt_best_anchor, torch.where(force_ok, torch.arange(m, device=anchors.device),
                                           -1), reduce='amax')
        best_gt = torch.where(forced_gt >= 0, forced_gt, best_gt)
        fg = fg | (forced_gt >= 0)

        labels = torch.where(fg, gt_classes[best_gt], 0)
        targets = self.box_coder.encode(gt_boxes[best_gt], anchors)
        targets = torch.where(fg[:, None], targets, 0.0)
        return labels, targets, fg.float()
