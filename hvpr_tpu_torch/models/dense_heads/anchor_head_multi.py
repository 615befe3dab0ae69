"""Grouped multi-head anchor head (``AnchorHeadMulti``).

Port of ``hvpr_tpu/models/dense_heads/anchor_head_multi.py``: a plain
single-path head for multi-class configs. An optional shared conv
(SHARED_CONV_NUM_FILTER) runs over the BEV map, then each RPN head
(RPN_HEAD_CFGS, one class group each; the groups must list CLASS_NAMES in
order) its own conv trunk (HEAD_CONV_FILTERS) and, per class of its group,
1x1 cls / box / direction convs. A class's cls logits fill only its own
column of the (anchor, class) logits, the other columns being -1e9, and the
heads' anchors concatenate per BEV location in class order: the axis-aligned
assigner's layout. The losses are the focal, smooth-L1 and direction losses
of one path. The box coder and the anchors' width follow BOX_CODER as in
``AnchorHeadSingle``.

Keys: ``shared_conv`` = [conv, bn, relu]; ``rpn_heads.{h}.head_convs.{k}``
= [conv, bn, relu]; ``rpn_heads.{h}.convs.{n}`` the 1x1 convs in the order
the JAX module declares them (per class: cls, box, then dir if
USE_DIRECTION_CLASSIFIER).
"""

import math

import torch
from torch import nn

from ...utils import box_coder_utils, loss_utils
from ..model_utils.layers import ConvBNReLU
from .anchor_head_single import (apply_direction, build_anchors, class_anchors,
                                 register_anchors)
from .target_assigner.axis_aligned_target_assigner import AxisAlignedTargetAssigner


def _conv1x1(conv, x):
    """A 1x1 ``nn.Conv2d`` over an NHWC map, as a matmul."""
    return x @ conv.weight[:, :, 0, 0].t() + conv.bias


class SingleHead(nn.Module):
    """One class group's head: optional conv trunk + per-class 1x1 convs."""

    def __init__(self, input_channels, class_anchor_counts, global_class_indices,
                 num_global_classes, code_size, num_dir_bins, use_dir,
                 head_conv_filters=()):
        super().__init__()
        self.class_anchor_counts = list(class_anchor_counts)
        self.global_class_indices = list(global_class_indices)
        self.num_global_classes = num_global_classes
        self.code_size = code_size
        self.num_dir_bins = num_dir_bins
        self.use_dir = use_dir
        self.head_convs = nn.ModuleList()
        c = input_channels
        for ch in head_conv_filters:
            self.head_convs.append(ConvBNReLU(c, ch))
            c = ch
        pi = 0.01
        convs = []
        for na_c in self.class_anchor_counts:
            cls = nn.Conv2d(c, na_c, 1)
            nn.init.constant_(cls.bias, -math.log((1 - pi) / pi))
            box = nn.Conv2d(c, na_c * code_size, 1)
            nn.init.normal_(box.weight, mean=0.0, std=0.001)
            nn.init.zeros_(box.bias)
            convs += [cls, box]
            if use_dir:
                convs.append(nn.Conv2d(c, na_c * num_dir_bins, 1))
        self.convs = nn.ModuleList(convs)

    def forward(self, feat):
        """(B, H, W, C) -> cls (B, H, W, na_g, num classes), box (..., code),
        dir (..., bins) or None."""
        x = feat
        if len(self.head_convs):
            x = x.permute(0, 3, 1, 2)
            for conv in self.head_convs:
                x = conv(x)
            x = x.permute(0, 2, 3, 1)
        b, h, w, _ = x.shape
        per = 3 if self.use_dir else 2
        cls_parts, box_parts, dir_parts = [], [], []
        for k, (na_c, gcls) in enumerate(zip(self.class_anchor_counts,
                                             self.global_class_indices)):
            convs = self.convs[per * k:per * (k + 1)]
            cls_c = _conv1x1(convs[0], x)                               # (b, h, w, na_c)
            column = torch.arange(self.num_global_classes, device=x.device) == gcls
            cls_parts.append(torch.where(column, cls_c[..., None], -1e9))
            box_parts.append(_conv1x1(convs[1], x).reshape(b, h, w, na_c, self.code_size))
            if self.use_dir:
                dir_parts.append(_conv1x1(convs[2], x).reshape(b, h, w, na_c,
                                                               self.num_dir_bins))
        return (torch.cat(cls_parts, dim=3), torch.cat(box_parts, dim=3),
                torch.cat(dir_parts, dim=3) if self.use_dir else None)


class AnchorHeadMulti(nn.Module):

    def __init__(self, model_cfg, input_channels, num_class, class_names,
                 grid_size, point_cloud_range):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = num_class
        class_names = list(class_names)
        target_cfg = model_cfg['TARGET_ASSIGNER_CONFIG']
        self.box_coder = box_coder_utils.build_box_coder(target_cfg)
        anchors_list, num_per_loc = build_anchors(model_cfg, grid_size, point_cloud_range,
                                                  anchor_ndim=self.box_coder.code_size)
        register_anchors(self, anchors_list)
        self.target_assigner = AxisAlignedTargetAssigner(
            model_cfg, class_names, self.box_coder,
            match_height=target_cfg.get('MATCH_HEIGHT', False))

        shared = model_cfg.get('SHARED_CONV_NUM_FILTER')
        self.shared_conv = ConvBNReLU(input_channels, int(shared)) if shared else None
        c_in = int(shared) if shared else input_channels
        head_cfgs = model_cfg.get('RPN_HEAD_CFGS')
        if head_cfgs is None:
            head_cfgs = [{'HEAD_CLS_NAME': class_names}]
        covered = [n for h in head_cfgs for n in h['HEAD_CLS_NAME']]
        if covered != class_names:
            raise ValueError(f'RPN_HEAD_CFGS classes {covered} must equal CLASS_NAMES '
                             f'{class_names} in order')
        self.use_dir = model_cfg.get('USE_DIRECTION_CLASSIFIER', False)
        self.num_dir_bins = int(model_cfg.get('NUM_DIR_BINS', 2))
        self.rpn_heads = nn.ModuleList(
            SingleHead(c_in, [num_per_loc[class_names.index(n)] for n in h['HEAD_CLS_NAME']],
                       [class_names.index(n) for n in h['HEAD_CLS_NAME']], num_class,
                       self.box_coder.code_size, self.num_dir_bins, self.use_dir,
                       list(h.get('HEAD_CONV_FILTERS', [])))
            for h in head_cfgs)

        code_weights = model_cfg['LOSS_CONFIG']['LOSS_WEIGHTS']['code_weights']
        self.cls_loss_func = loss_utils.SigmoidFocalClassificationLoss(alpha=0.25, gamma=2.0)
        self.reg_loss_func = loss_utils.WeightedSmoothL1Loss(code_weights=code_weights)
        self.dir_loss_func = loss_utils.WeightedCrossEntropyLoss()

    def forward(self, batch_dict):
        feat = batch_dict['spatial_features_2d']
        if self.shared_conv is not None:
            feat = self.shared_conv(feat.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        outs = [head(feat) for head in self.rpn_heads]
        b = feat.shape[0]
        cls_preds = torch.cat([o[0] for o in outs], dim=3).reshape(b, -1, self.num_class)
        box_preds = torch.cat([o[1] for o in outs], dim=3).reshape(
            b, -1, self.box_coder.code_size)
        dir_preds = (torch.cat([o[2] for o in outs], dim=3).reshape(b, -1, self.num_dir_bins)
                     if self.use_dir else None)
        if self.training:
            targets = self.target_assigner.assign_targets(
                class_anchors(self), batch_dict['gt_boxes'],
                global_step=batch_dict.get('global_step'))
            batch_dict['loss'], batch_dict['tb_dict'] = self.get_loss(
                cls_preds, box_preds, dir_preds, targets)
            return batch_dict
        batch_cls, batch_box = self.generate_predicted_boxes(cls_preds, box_preds, dir_preds)
        batch_dict['batch_cls_preds'] = batch_cls
        batch_dict['batch_box_preds'] = batch_box
        batch_dict['cls_preds_normalized'] = False
        return batch_dict

    def get_loss(self, cls_preds, box_preds, dir_preds, targets):
        lw = self.model_cfg['LOSS_CONFIG']['LOSS_WEIGHTS']
        labels = targets['box_cls_labels']
        b = cls_preds.shape[0]
        positives = labels > 0
        pos_norm = torch.clamp(positives.sum(dim=1, keepdim=True).float(), min=1.0)
        cls_weights = ((labels == 0) | positives).float() / pos_norm
        one_hot = torch.nn.functional.one_hot(torch.where(labels >= 0, labels, 0),
                                              self.num_class + 1)[..., 1:]
        cls_loss = self.cls_loss_func(cls_preds, one_hot.to(cls_preds.dtype),
                                      cls_weights).sum() / b * lw['cls_weight']
        preds_sin, targets_sin = loss_utils.add_sin_difference(
            box_preds, targets['box_reg_targets'])
        loc_loss = self.reg_loss_func(preds_sin, targets_sin,
                                      positives.float() / pos_norm).sum() / b * lw['loc_weight']
        dir_loss = cls_preds.new_zeros(())
        if dir_preds is not None:
            dir_targets = loss_utils.get_direction_target(
                self.anchors, targets['box_reg_targets'],
                self.model_cfg.get('DIR_OFFSET', 0.78539), self.num_dir_bins)
            w = positives.float()
            w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1.0)
            dir_loss = self.dir_loss_func(dir_preds, dir_targets, w).sum() / b * lw['dir_weight']
        total = cls_loss + loc_loss + dir_loss
        zero = cls_preds.new_zeros(())
        return total, {'rpn_loss_cls': cls_loss, 'rpn_loss_loc': loc_loss,
                       'rpn_loss_dir': dir_loss, 'rpn_loss': total,
                       'rpn_loss_point': zero, 'mem_loss': zero}

    def generate_predicted_boxes(self, cls_preds, box_preds, dir_preds):
        batch_box = self.box_coder.decode(box_preds, self.anchors[None])
        if dir_preds is not None:
            batch_box = apply_direction(batch_box, dir_preds.argmax(dim=-1),
                                        self.model_cfg.get('DIR_OFFSET', 0.78539),
                                        self.model_cfg.get('DIR_LIMIT_OFFSET', 0.0),
                                        self.num_dir_bins)
        return cls_preds, batch_box
