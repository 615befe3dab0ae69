"""Single 1x1-conv anchor head, eval branch.

Port of ``hvpr_tpu/models/dense_heads/anchor_head_single.py``: the cls / box /
direction 1x1 convs run fused as one matmul over the NHWC map (kernels
concatenated along the output axis, the map read once), then anchors decode
the residuals and the direction bins fix the heading. Anchors are flattened
in (ny, nx, class, size, rot) order. DENSE_HEAD.COMPUTE_DTYPE bf16 rounds the
map and the kernels to bf16 and accumulates in f32, as the JAX head's
``preferred_element_type=f32`` matmul does.
"""

import math

import numpy as np
import torch
from torch import nn

from ...utils import box_coder_utils, common_utils
from .target_assigner.anchor_generator import AnchorGenerator


def build_anchors(model_cfg, grid_size, point_cloud_range):
    """Per-class anchor grids (numpy constants)."""
    anchor_cfg = model_cfg['ANCHOR_GENERATOR_CONFIG']
    generator = AnchorGenerator(anchor_range=point_cloud_range,
                                anchor_generator_config=anchor_cfg)
    feature_map_size = [[int(grid_size[0]) // c['feature_map_stride'],
                         int(grid_size[1]) // c['feature_map_stride']]
                        for c in anchor_cfg]
    return generator.generate_anchors(feature_map_size)


class AnchorHeadSingle(nn.Module):
    """Keys follow the reference: ``conv_cls``, ``conv_box``, ``conv_dir_cls``."""

    def __init__(self, model_cfg, input_channels, num_class, class_names,
                 grid_size, point_cloud_range):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = num_class
        target_cfg = model_cfg['TARGET_ASSIGNER_CONFIG']
        if target_cfg['BOX_CODER'] != 'ResidualCoder':
            raise NotImplementedError(target_cfg['BOX_CODER'])
        self.box_coder = box_coder_utils.ResidualCoder(
            num_dir_bins=target_cfg.get('NUM_DIR_BINS', 6),
            **target_cfg.get('BOX_CODER_CONFIG', {}))
        anchors_list, num_per_loc = build_anchors(model_cfg, grid_size,
                                                  point_cloud_range)
        per_loc = []
        for a in anchors_list:
            nz, ny, nx, ns, nr, c = a.shape
            per_loc.append(a.reshape(nz * ny * nx, ns * nr, c))
        flat = np.concatenate(per_loc, axis=1).reshape(-1, per_loc[0].shape[-1])
        self.register_buffer('anchors', torch.from_numpy(flat), persistent=False)
        na = sum(num_per_loc)

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
            dir_offset = self.model_cfg['DIR_OFFSET']
            dir_limit_offset = self.model_cfg['DIR_LIMIT_OFFSET']
            num_bins = int(self.model_cfg['NUM_DIR_BINS'])
            dir_labels = dir_preds.reshape(b, num_anchors, -1).argmax(dim=-1)
            period = 2 * np.pi / num_bins
            dir_rot = common_utils.limit_period(
                batch_box[..., 6] - dir_offset, dir_limit_offset, period)
            heading = dir_rot + dir_offset + period * dir_labels.to(batch_box.dtype)
            batch_box = torch.cat([batch_box[..., :6], heading[..., None],
                                   batch_box[..., 7:]], dim=-1)
        return batch_cls, batch_box

    def forward(self, batch_dict):
        cls_preds, box_preds, dir_preds = self._heads(
            batch_dict['spatial_features_2d'])
        batch_cls, batch_box = self.generate_predicted_boxes(
            cls_preds, box_preds, dir_preds)
        batch_dict['batch_cls_preds'] = batch_cls
        batch_dict['batch_box_preds'] = batch_box
        batch_dict['cls_preds_normalized'] = False
        return batch_dict
