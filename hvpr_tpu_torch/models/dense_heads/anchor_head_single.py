"""Single 1x1-conv anchor head with the HVPR dual-path losses.

Port of ``hvpr_tpu/models/dense_heads/anchor_head_single.py``: the cls / box /
direction 1x1 convs run fused as one matmul over the NHWC map (kernels
concatenated along the output axis, the map read once). In eval the anchors
decode the residuals and the direction bins fix the heading. In training the
heads run on both maps (memory and point) and ``get_loss`` sums focal,
smooth-L1 and direction losses of both paths with the memory-mimicking MSE
against the stop-gradient point features. The targets come from the
axis-aligned or the ATSS assigner (TARGET_ASSIGNER_CONFIG.NAME
``AxisAlignedTargetAssigner`` or ``ATSS``). Anchors are flattened
in (ny, nx, class, size, rot) order. DENSE_HEAD.COMPUTE_DTYPE bf16 rounds the
map and the kernels to bf16 and accumulates in f32, as the JAX head's
``preferred_element_type=f32`` matmul does.
"""

import math

import numpy as np
import torch
from torch import nn

from ...utils import box_coder_utils, common_utils, loss_utils
from .target_assigner.anchor_generator import AnchorGenerator
from .target_assigner.atss_target_assigner import ATSSTargetAssigner
from .target_assigner.axis_aligned_target_assigner import AxisAlignedTargetAssigner


def build_anchors(model_cfg, grid_size, point_cloud_range):
    """Per-class anchor grids (numpy constants)."""
    anchor_cfg = model_cfg['ANCHOR_GENERATOR_CONFIG']
    generator = AnchorGenerator(anchor_range=point_cloud_range,
                                anchor_generator_config=anchor_cfg)
    feature_map_size = [[int(grid_size[0]) // c['feature_map_stride'],
                         int(grid_size[1]) // c['feature_map_stride']]
                        for c in anchor_cfg]
    return generator.generate_anchors(feature_map_size)


def residual_coder(target_cfg):
    """TARGET_ASSIGNER_CONFIG's box coder (ResidualCoder only)."""
    if target_cfg['BOX_CODER'] != 'ResidualCoder':
        raise NotImplementedError(target_cfg['BOX_CODER'])
    return box_coder_utils.ResidualCoder(num_dir_bins=target_cfg.get('NUM_DIR_BINS', 6),
                                         **target_cfg.get('BOX_CODER_CONFIG', {}))


def register_anchors(head, anchors_list):
    """The per-class anchor grids as ``head``'s buffers: ``anchors`` (A, 7)
    flattened in (ny, nx, class, size, rot) order, and ``class_anchors_{i}``
    each class's grid (the target assigner's input)."""
    per_loc = []
    for a in anchors_list:
        nz, ny, nx, ns, nr, c = a.shape
        per_loc.append(a.reshape(nz * ny * nx, ns * nr, c))
    flat = np.concatenate(per_loc, axis=1).reshape(-1, per_loc[0].shape[-1])
    head.register_buffer('anchors', torch.from_numpy(flat), persistent=False)
    for i, a in enumerate(anchors_list):
        head.register_buffer(f'class_anchors_{i}', torch.from_numpy(a), persistent=False)
    head.num_anchor_classes = len(anchors_list)


def class_anchors(head):
    return [getattr(head, f'class_anchors_{i}') for i in range(head.num_anchor_classes)]


def apply_direction(batch_box, dir_labels, dir_offset, dir_limit_offset, num_bins):
    """Decoded boxes with each heading moved into its predicted direction bin."""
    period = 2 * np.pi / num_bins
    dir_rot = common_utils.limit_period(batch_box[..., 6] - dir_offset, dir_limit_offset,
                                        period)
    heading = dir_rot + dir_offset + period * dir_labels.to(batch_box.dtype)
    return torch.cat([batch_box[..., :6], heading[..., None], batch_box[..., 7:]], dim=-1)


class AnchorHeadSingle(nn.Module):
    """Keys follow the reference: ``conv_cls``, ``conv_box``, ``conv_dir_cls``."""

    def __init__(self, model_cfg, input_channels, num_class, class_names,
                 grid_size, point_cloud_range):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = num_class
        target_cfg = model_cfg['TARGET_ASSIGNER_CONFIG']
        self.box_coder = residual_coder(target_cfg)
        anchors_list, num_per_loc = build_anchors(model_cfg, grid_size,
                                                  point_cloud_range)
        register_anchors(self, anchors_list)
        na = sum(num_per_loc)
        if target_cfg['NAME'] == 'AxisAlignedTargetAssigner':
            self.target_assigner = AxisAlignedTargetAssigner(
                model_cfg, class_names, self.box_coder,
                match_height=target_cfg.get('MATCH_HEIGHT', False))
        elif target_cfg['NAME'] == 'ATSS':
            self.target_assigner = ATSSTargetAssigner(
                target_cfg['TOPK'], self.box_coder,
                match_height=target_cfg.get('MATCH_HEIGHT', False))
        else:
            raise NotImplementedError(target_cfg['NAME'])
        loss_w = model_cfg['LOSS_CONFIG']['LOSS_WEIGHTS']
        self.cls_loss_func = loss_utils.SigmoidFocalClassificationLoss(alpha=0.25, gamma=2.0)
        self.reg_loss_func = loss_utils.WeightedSmoothL1Loss(
            code_weights=loss_w['code_weights'])
        self.dir_loss_func = loss_utils.WeightedCrossEntropyLoss()

        self.conv_cls = nn.Conv2d(input_channels, na * num_class, 1)
        self.conv_box = nn.Conv2d(input_channels, na * self.box_coder.code_size, 1)
        pi = 0.01
        nn.init.constant_(self.conv_cls.bias, -math.log((1 - pi) / pi))
        nn.init.normal_(self.conv_box.weight, mean=0.0, std=0.001)
        self.use_dir = model_cfg.get('USE_DIRECTION_CLASSIFIER', False)
        self.conv_dir_cls = (nn.Conv2d(input_channels,
                                       na * int(model_cfg['NUM_DIR_BINS']), 1)
                             if self.use_dir else None)
        name = str(model_cfg.get('COMPUTE_DTYPE', 'fp32')).lower()
        self.compute_dtype = (torch.bfloat16 if name in ('bf16', 'bfloat16')
                              else torch.float32)

    def _heads(self, feat):
        """The three 1x1 convs as one matmul over the (B, H, W, C) map."""
        convs = [self.conv_cls, self.conv_box]
        if self.use_dir:
            convs.append(self.conv_dir_cls)
        w = torch.cat([cv.weight[:, :, 0, 0] for cv in convs], dim=0).t()
        bias = torch.cat([cv.bias for cv in convs])
        dt = self.compute_dtype
        out = feat.to(dt).float() @ w.to(dt).float() + bias
        n_cls = self.conv_cls.out_channels
        n_box = self.conv_box.out_channels
        dir_ = out[..., n_cls + n_box:] if self.use_dir else None
        return out[..., :n_cls], out[..., n_cls:n_cls + n_box], dir_

    def generate_predicted_boxes(self, cls_preds, box_preds, dir_preds):
        b = cls_preds.shape[0]
        num_anchors = self.anchors.shape[0]
        batch_cls = cls_preds.reshape(b, num_anchors, -1)
        batch_box = self.box_coder.decode(box_preds.reshape(b, num_anchors, -1),
                                          self.anchors[None])
        if dir_preds is not None:
            batch_box = apply_direction(
                batch_box, dir_preds.reshape(b, num_anchors, -1).argmax(dim=-1),
                self.model_cfg['DIR_OFFSET'], self.model_cfg['DIR_LIMIT_OFFSET'],
                int(self.model_cfg['NUM_DIR_BINS']))
        return batch_cls, batch_box

    def forward(self, batch_dict):
        cls_preds, box_preds, dir_preds = self._heads(
            batch_dict['spatial_features_2d'])
        if self.training:
            feat_pt = batch_dict.get('spatial_features_point_2d')
            pt = self._heads(feat_pt) if feat_pt is not None else (None,) * 3
            targets = self.target_assigner.assign_targets(class_anchors(self),
                                                          batch_dict['gt_boxes'])
            batch_dict['loss'], batch_dict['tb_dict'] = self.get_loss(
                (cls_preds, box_preds, dir_preds), pt, targets, batch_dict)
            return batch_dict
        batch_cls, batch_box = self.generate_predicted_boxes(
            cls_preds, box_preds, dir_preds)
        batch_dict['batch_cls_preds'] = batch_cls
        batch_dict['batch_box_preds'] = batch_box
        batch_dict['cls_preds_normalized'] = False
        return batch_dict

    # ------------------------------------------------------------------ losses

    def _cls_loss(self, cls_preds, labels):
        b = cls_preds.shape[0]
        cls_preds = cls_preds.reshape(b, -1, self.num_class)
        positives = labels > 0
        cls_weights = ((labels == 0) | positives).float()
        pos_normalizer = torch.clamp(positives.sum(dim=1, keepdim=True).float(), min=1.0)
        cls_weights = cls_weights / pos_normalizer
        cls_targets = torch.where(labels >= 0, labels, 0)
        if self.num_class == 1:
            cls_targets = torch.where(positives, 1, cls_targets)
        one_hot = torch.nn.functional.one_hot(cls_targets, self.num_class + 1)[..., 1:]
        loss = self.cls_loss_func(cls_preds, one_hot.to(cls_preds.dtype), cls_weights)
        return loss.sum() / b

    def _box_loss(self, box_preds, dir_preds, targets):
        b = box_preds.shape[0]
        labels = targets['box_cls_labels']
        reg_targets = targets['box_reg_targets']
        positives = labels > 0
        reg_weights = positives.float()
        reg_weights = reg_weights / torch.clamp(
            positives.sum(dim=1, keepdim=True).float(), min=1.0)
        box_preds = box_preds.reshape(b, -1, self.box_coder.code_size)
        preds_sin, targets_sin = loss_utils.add_sin_difference(box_preds, reg_targets)
        loc_loss = self.reg_loss_func(preds_sin, targets_sin, reg_weights).sum() / b
        dir_loss = box_preds.new_zeros(())
        if dir_preds is not None:
            num_bins = int(self.model_cfg['NUM_DIR_BINS'])
            dir_targets = loss_utils.get_direction_target(
                self.anchors, reg_targets, self.model_cfg['DIR_OFFSET'], num_bins)
            w = positives.float()
            w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1.0)
            dir_loss = self.dir_loss_func(dir_preds.reshape(b, -1, num_bins),
                                          dir_targets, w).sum() / b
        return loc_loss, dir_loss

    def get_loss(self, preds, preds_pt, targets, batch_dict):
        """Total loss and its terms: both paths' cls / loc / dir losses and
        the memory-mimicking MSE, mean over valid pillars' elements divided
        again by the pillar count, as the reference does. The detection
        terms are normalized per scan and averaged over the local batch, so
        over several processes the mean of the ranks' terms is the global
        batch's; the pillar count is the global batch's, and each rank's
        memory term is the world size times its share."""
        lw = self.model_cfg['LOSS_CONFIG']['LOSS_WEIGHTS']
        labels = targets['box_cls_labels']
        terms = {}
        for sfx, (cls_p, box_p, dir_p) in (('', preds), ('_pt', preds_pt)):
            if cls_p is None:
                zero = preds[0].new_zeros(())
                terms.update({f'rpn_loss_cls{sfx}': zero, f'rpn_loss_loc{sfx}': zero,
                              f'rpn_loss_dir{sfx}': zero})
                continue
            loc, dir_ = self._box_loss(box_p, dir_p, targets)
            terms[f'rpn_loss_cls{sfx}'] = self._cls_loss(cls_p, labels) * lw['cls_weight']
            terms[f'rpn_loss_loc{sfx}'] = loc * lw['loc_weight']
            terms[f'rpn_loss_dir{sfx}'] = dir_ * lw['dir_weight']
        mem_loss = preds[0].new_zeros(())
        if 'memory_positive_features' in batch_dict:
            target = batch_dict['point_positive_features'].detach()
            memory = batch_dict['memory_positive_features']
            vmask = batch_dict['voxel_mask'][..., None].to(memory.dtype)
            nv = batch_dict['voxel_mask'].sum().to(memory.dtype)
            world = common_utils.get_dist_info()[1]
            if world > 1:
                # nv is the whole batch's count, as under the JAX mesh step:
                # each rank's term is scaled so that their mean is the
                # global term (the mean the gradient all-reduce takes)
                nv = common_utils.all_reduce_sum(nv)
            nv = torch.clamp(nv, min=1.0)
            mse = (((memory - target) ** 2) * vmask).sum() / (nv * memory.shape[-1])
            mem_loss = mse / nv * lw['mem_weight']
            if world > 1:
                mem_loss = mem_loss * world
        rpn = terms['rpn_loss_cls'] + terms['rpn_loss_loc'] + terms['rpn_loss_dir']
        rpn_pt = (terms['rpn_loss_cls_pt'] + terms['rpn_loss_loc_pt']
                  + terms['rpn_loss_dir_pt'])
        tb = dict(terms, mem_loss=mem_loss, rpn_loss=rpn, rpn_loss_point=rpn_pt)
        return rpn + rpn_pt + mem_loss, tb
