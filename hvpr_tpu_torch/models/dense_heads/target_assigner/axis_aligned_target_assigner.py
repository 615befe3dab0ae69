"""Axis-aligned IoU target assigner.

Port of ``hvpr_tpu/models/dense_heads/target_assigner/
axis_aligned_target_assigner.py``. Per class, anchors match the gt of
highest IoU: the nearest-BEV IoU, or with ``MATCH_HEIGHT`` the rotated 3D
IoU (``ops.rotated_iou.boxes_iou3d``). Labels take the reference's
overwrite order: -1 < positives (>= matched threshold) < background (<
unmatched threshold) < force-matched best anchors of each gt. Padded gt
rows (all zeros) are masked out. Anchors may be wider than 7 columns (the
zero padding of a sincos coder): the IoU reads the first 7.

``NORM_BY_NUM_EXAMPLES`` divides the regression weights by the count of
labels >= 0 (a class and a sample at a time, clipped at 1).

``POS_FRACTION`` >= 0 (0.0 included) subsamples with ``SAMPLE_SIZE``:
:meth:`AxisAlignedTargetAssigner.subsample` keeps the foregrounds of the
``int(POS_FRACTION * SAMPLE_SIZE)`` smallest uniforms, fills the rest of
the budget with the backgrounds of the smallest uniforms (the kept
foregrounds excluded, so a force-match is never clobbered), and marks
every other foreground and background -1; with fewer candidates than the
budget every candidate is kept. These are the JAX package's rules.

The uniforms differ from the JAX package's. It derives its keys inside the
jitted step from threefry, ``PRNGKey(17)`` folded with the bits of the gt
boxes' sum, the global step, the class index and then split per sample.
The port does not reimplement threefry: each (global step, class, sample)
seeds its own ``torch.Generator`` on the labels' device from the constant
17, the step, the class index and the sample index
(:func:`subsample_generator`), and draws the foreground's uniforms, then
the background's. A repeated batch is resampled by its global step, as in
the JAX package; the same step, class and sample draw the same uniforms
on every run, through the kernels or the plain versions. Given the same
uniforms, the port's labels equal the JAX package's (the tests feed it
the uniforms that ``jax.random`` drew).
"""

import torch

from ....ops.rotated_iou import boxes_iou3d
from ....utils.box_utils import boxes3d_nearest_bev_iou

SUBSAMPLE_SEED = 17


def subsample_generator(device, global_step, cls_idx, sample):
    """The generator of one (global step, class, sample)'s subsampling
    uniforms, seeded from :data:`SUBSAMPLE_SEED` and the three indices."""
    seed = SUBSAMPLE_SEED
    for v in (global_step, cls_idx, sample):
        seed = (seed * 1_000_003 + int(v)) % (1 << 63)
    return torch.Generator(device=device).manual_seed(seed)


class AxisAlignedTargetAssigner:

    def __init__(self, model_cfg, class_names, box_coder, match_height=False):
        anchor_cfg = model_cfg['ANCHOR_GENERATOR_CONFIG']
        target_cfg = model_cfg['TARGET_ASSIGNER_CONFIG']
        self.box_coder = box_coder
        self.match_height = match_height
        self.class_names = list(class_names)
        self.anchor_class_names = [c['class_name'] for c in anchor_cfg]
        self.matched = {c['class_name']: c['matched_threshold'] for c in anchor_cfg}
        self.unmatched = {c['class_name']: c['unmatched_threshold'] for c in anchor_cfg}
        self.norm_by_num_examples = bool(target_cfg.get('NORM_BY_NUM_EXAMPLES', False))
        # an explicit None check: POS_FRACTION 0.0 caps the foregrounds at
        # zero and samples backgrounds only
        pos_fraction = target_cfg.get('POS_FRACTION', None)
        pos_fraction = -1.0 if pos_fraction is None else float(pos_fraction)
        self.pos_fraction = pos_fraction if pos_fraction >= 0 else None
        self.sample_size = int(target_cfg.get('SAMPLE_SIZE', 512))

    def assign_targets(self, anchors_list, gt_boxes_with_classes, global_step=None):
        """
        Args:
            anchors_list: per class, a (nz, ny, nx, ns, nr, C) tensor, C >= 7.
            gt_boxes_with_classes: (B, M, 8) [x..heading, class]; padded rows 0.
            global_step: the train step's index (0 when None); seeds the
                POS_FRACTION subsampling with the class and sample indices.
        Returns:
            dict of box_cls_labels (B, A) int64, box_reg_targets (B, A, code),
            reg_weights (B, A); anchors in (ny, nx, class, size, rot) order.
        """
        gt_boxes = gt_boxes_with_classes[..., :7]
        gt_classes = gt_boxes_with_classes[..., 7].long()
        gt_valid = gt_boxes_with_classes.abs().sum(dim=-1) > 0
        b = gt_boxes.shape[0]
        step = 0 if global_step is None else int(global_step)
        per_class = []
        for cls_idx, (name, anchors) in enumerate(zip(self.anchor_class_names,
                                                      anchors_list)):
            nz, ny, nx, ns, nr, c = anchors.shape
            flat = anchors.reshape(-1, c)
            cls_mask = gt_valid & (gt_classes == self.class_names.index(name) + 1)
            outs = [self._assign_single(flat, gt_boxes[i], gt_classes[i], cls_mask[i],
                                        self.matched[name], self.unmatched[name],
                                        (step, cls_idx, i))
                    for i in range(b)]
            per_class.append([torch.stack(t).reshape(b, nz * ny * nx, ns * nr, *t[0].shape[1:])
                              for t in zip(*outs)])
        labels, targets, weights = (torch.cat(t, dim=2) for t in zip(*per_class))
        return {'box_cls_labels': labels.reshape(b, -1),
                'box_reg_targets': targets.reshape(b, -1, targets.shape[-1]),
                'reg_weights': weights.reshape(b, -1)}

    def _assign_single(self, anchors, gt_boxes, gt_classes, cls_mask,
                       matched_threshold, unmatched_threshold, draw):
        if self.match_height:
            iou = boxes_iou3d(anchors[:, :7], gt_boxes)
        else:
            iou = boxes3d_nearest_bev_iou(anchors[:, :7], gt_boxes)
        iou = torch.where(cls_mask[None, :], iou, -1.0)                   # (A, M)
        any_gt = cls_mask.any()
        a2g_max, a2g_arg = iou.max(dim=1)
        g2a_max = iou.amax(dim=0)
        g2a_max = torch.where(cls_mask & (g2a_max > 0), g2a_max, -1.0)
        force = ((iou == g2a_max[None, :]) & (g2a_max[None, :] > 0)).any(dim=1)
        matched_cls = gt_classes[a2g_arg]
        labels = torch.full_like(matched_cls, -1)
        labels = torch.where(a2g_max >= matched_threshold, matched_cls, labels)
        bg = a2g_max < unmatched_threshold
        labels = torch.where(bg, 0, labels)
        labels = torch.where(force, matched_cls, labels)
        labels = torch.where(any_gt, labels, 0)
        if self.pos_fraction is not None:
            gen = subsample_generator(anchors.device, *draw)
            u_fg, u_bg = (torch.rand(anchors.shape[0], generator=gen, device=anchors.device)
                          for _ in range(2))
            labels = self.subsample(labels, bg | ~any_gt, u_fg, u_bg)
        fg = labels > 0
        targets = self.box_coder.encode(gt_boxes[a2g_arg], anchors)
        targets = torch.where(fg[:, None], targets, 0.0)
        weights = fg.float()
        if self.norm_by_num_examples:
            weights = weights / torch.clamp((labels >= 0).sum().float(), min=1.0)
        return labels, targets, weights

    def subsample(self, labels, bg_candidates, u_fg, u_bg):
        """(A,) labels after the POS_FRACTION / SAMPLE_SIZE subsampling,
        given (A,) ``bg_candidates`` and the (A,) uniforms of the
        foregrounds and of the backgrounds: the foregrounds of the
        ``int(pos_fraction * sample_size)`` smallest ``u_fg`` stay, the
        rest become -1; the backgrounds of the smallest ``u_bg`` among the
        candidates that are not kept foregrounds fill the budget left
        (label 0), the other candidates become -1."""
        cap = int(self.pos_fraction * self.sample_size)
        fg = labels > 0
        fg_keep = fg & (_rank(torch.where(fg, u_fg, float('inf'))) < cap)
        labels = torch.where(fg & ~fg_keep, -1, labels)
        num_bg = self.sample_size - fg_keep.sum()
        bg_cand = bg_candidates & ~fg_keep
        bg_keep = bg_cand & (_rank(torch.where(bg_cand, u_bg, float('inf'))) < num_bg)
        return torch.where(bg_cand, torch.where(bg_keep, 0, -1), labels)


def _rank(values):
    """Each entry's position in the stable ascending order of ``values``:
    the argsort of the argsort, as the JAX package takes it."""
    return torch.argsort(torch.argsort(values, stable=True), stable=True)
