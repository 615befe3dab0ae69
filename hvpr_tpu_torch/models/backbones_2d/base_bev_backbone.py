"""BEV conv backbones: the plain pyramid and the scale-aware one.

Port of ``BaseBEVBackbone`` and ``BaseBEVBackboneScale`` in
``hvpr_tpu/models/backbones_2d/base_bev_backbone.py``.

``BaseBEVBackbone`` (PointPillars, SECOND): per level a strided conv block
of LAYER_NUMS extra convs, then an upsampling to the common resolution, a
transpose conv where UPSAMPLE_STRIDES is 1 or more and a strided conv where
it is below 1; the levels are concatenated, and one more transpose conv
follows when UPSAMPLE_STRIDES has an entry more than LAYER_NUMS. Training
runs the same single pass with batch statistics.

``BaseBEVBackboneScale`` (HVPR): per level a strided
conv block, the scale stream's strided conv, SFM_LAYER_NUMS rounds of conv
-> CBAM gate by the scale map -> residual, and a transpose-conv upsampling;
the levels are concatenated. In training (``DUAL_PASS: stacked``, the only
dual pass ported) one pass runs over [memory map ; point map] stacked on the
batch axis with per-split BN statistics, the scale stream once and tiled. Takes and returns NHWC tensors
(the JAX layout); inside, the NHWC maps permuted to NCHW are channels_last
memory for cuDNN. These convs are XLA convolutions in the JAX package, not
TPU kernels, so they run on cuDNN here. BACKBONE_2D.COMPUTE_DTYPE bf16 runs
them in bf16 with f32 params and BN.
"""

import torch
from torch import nn

from ..model_utils.layers import ConvBNReLU, DeconvBNReLU, run_sequence
from .spatial_attention import SpatialAttention


def _compute_dtype(model_cfg):
    name = str(model_cfg.get('COMPUTE_DTYPE', 'fp32')).lower()
    return torch.bfloat16 if name in ('bf16', 'bfloat16') else None


def _block(c_in, features, stride, layer_num, dtype):
    """One pyramid level: [pad, conv, bn, relu] + [conv, bn, relu] *
    ``layer_num`` (index 0 is an identity standing for the reference's
    ZeroPad2d; the conv pads itself)."""
    layers = [nn.Identity(), *ConvBNReLU(c_in, features, stride=stride, dtype=dtype)]
    for _ in range(layer_num):
        layers.extend(ConvBNReLU(features, features, dtype=dtype))
    return nn.Sequential(*layers)


class BaseBEVBackbone(nn.Module):
    """Module keys follow the reference: ``blocks.i`` as :func:`_block`,
    ``deblocks.i`` = [conv or transpose conv, bn, relu]."""

    def __init__(self, model_cfg, input_channels):
        super().__init__()
        layer_nums = list(model_cfg.get('LAYER_NUMS', []))
        strides = list(model_cfg.get('LAYER_STRIDES', []))
        filters = list(model_cfg.get('NUM_FILTERS', []))
        up_strides = list(model_cfg.get('UPSAMPLE_STRIDES', []))
        up_filters = list(model_cfg.get('NUM_UPSAMPLE_FILTERS', []))
        dt = _compute_dtype(model_cfg)

        blocks, deblocks = [], []
        c_in = input_channels
        for i, n in enumerate(layer_nums):
            blocks.append(_block(c_in, filters[i], strides[i], n, dt))
            c_in = filters[i]
            if not up_strides:
                continue
            s = up_strides[i]
            if s >= 1:
                deblocks.append(DeconvBNReLU(filters[i], up_filters[i], int(s), dtype=dt))
            else:
                k = int(round(1 / s))
                deblocks.append(ConvBNReLU(filters[i], up_filters[i], kernel_size=k,
                                           stride=k, padding=0, dtype=dt))
        out_ch = sum(up_filters) if up_filters else (filters[-1] if filters
                                                     else input_channels)
        if len(up_strides) > len(layer_nums):
            # the reference's last deblock, in f32 as the JAX module's is
            deblocks.append(DeconvBNReLU(out_ch, out_ch, int(up_strides[-1])))
        self.blocks = nn.ModuleList(blocks)
        self.deblocks = nn.ModuleList(deblocks)
        self.num_bev_features = out_ch
        self.num_levels = len(layer_nums)

    def forward(self, batch_dict):
        x = batch_dict['spatial_features'].permute(0, 3, 1, 2)
        ups = []
        for i, block in enumerate(self.blocks):
            x = run_sequence(block, x)
            ups.append(self.deblocks[i](x) if self.deblocks else x)
        x = torch.cat(ups, dim=1) if len(ups) > 1 else ups[0]
        if len(self.deblocks) > self.num_levels:
            x = self.deblocks[-1](x)
        batch_dict['spatial_features_2d'] = x.permute(0, 2, 3, 1)
        return batch_dict


class BaseBEVBackboneScale(nn.Module):
    """Module keys follow the reference: ``blocks.i`` as :func:`_block`,
    ``scale_layers.i`` = [pad,
    conv, bn, relu], ``sfmblocks_down.i`` and ``deblocks.i`` = [conv, bn,
    relu], ``attention.spatial``."""

    def __init__(self, model_cfg, input_channels, scale_channels):
        super().__init__()
        layer_nums = list(model_cfg['LAYER_NUMS'])
        strides = list(model_cfg['LAYER_STRIDES'])
        filters = list(model_cfg['NUM_FILTERS'])
        scale_filters = list(model_cfg['NUM_SCALE_FILTERS'])
        up_strides = list(model_cfg['UPSAMPLE_STRIDES'])
        up_filters = list(model_cfg['NUM_UPSAMPLE_FILTERS'])
        self.sfm_layer_nums = list(model_cfg['SFM_LAYER_NUMS'])
        self.dt = _compute_dtype(model_cfg)
        dt = self.dt

        blocks, sfm, scale, deblocks = [], [], [], []
        c_in, s_in = input_channels, scale_channels
        for i, n in enumerate(layer_nums):
            blocks.append(_block(c_in, filters[i], strides[i], n, dt))
            sfm.append(ConvBNReLU(filters[i], filters[i], dtype=dt))
            scale.append(nn.Sequential(nn.Identity(), *ConvBNReLU(
                s_in, scale_filters[i], stride=strides[i], dtype=dt)))
            deblocks.append(DeconvBNReLU(filters[i], up_filters[i],
                                         int(up_strides[i]), dtype=dt))
            c_in, s_in = filters[i], scale_filters[i]
        self.blocks = nn.ModuleList(blocks)
        self.sfmblocks_down = nn.ModuleList(sfm)
        self.scale_layers = nn.ModuleList(scale)
        self.deblocks = nn.ModuleList(deblocks)
        self.attention = SpatialAttention()
        self.num_bev_features = sum(up_filters)
        self.model_cfg = model_cfg

    def _level(self, i, x, y, splits=1):
        x_att = x
        for _ in range(self.sfm_layer_nums[i]):
            t = self.attention(self.sfmblocks_down[i](x_att, splits), y, splits)
            if self.dt is not None:
                t = t.to(self.dt)
            x_att = t + x_att
        return x_att

    def forward(self, batch_dict):
        x = batch_dict['spatial_features'].permute(0, 3, 1, 2)
        y = batch_dict['spatial_scale_features'].permute(0, 3, 1, 2)
        if self.training:
            return self._train_forward(batch_dict, x, y)
        ups = []
        for i, block in enumerate(self.blocks):
            x = block(x)
            y = self.scale_layers[i](y)
            ups.append(self.deblocks[i](self._level(i, x, y)))
        batch_dict['spatial_features_2d'] = torch.cat(ups, dim=1).permute(0, 2, 3, 1)
        return batch_dict

    def _train_forward(self, batch_dict, x, y):
        mode = str(self.model_cfg.get('DUAL_PASS', 'stacked'))
        if mode != 'stacked':
            raise NotImplementedError(f'DUAL_PASS {mode!r} is not ported')
        b = x.shape[0]
        xx = torch.cat([x, batch_dict['spatial_features_point'].permute(0, 3, 1, 2)])
        ups = []
        for i, block in enumerate(self.blocks):
            xx = run_sequence(block, xx, splits=2)
            y = self.scale_layers[i](y)
            lvl = self._level(i, xx, torch.cat([y, y]), splits=2)
            ups.append(self.deblocks[i](lvl, 2))
        cat = torch.cat(ups, dim=1).permute(0, 2, 3, 1)
        batch_dict['spatial_features_2d'] = cat[:b]
        batch_dict['spatial_features_point_2d'] = cat[b:]
        return batch_dict
