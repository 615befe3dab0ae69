"""Pillar feature encoder over the flat pillar layout.

Port of the flat branches of ``hvpr_tpu/models/backbones_3d/vfe/pillar_vfe.py``
(``decorate_flat_features``, ``PFNLayer``, ``PillarVFE_Scale``). Rows stay
channel-major (C, R) with R = B*N sorted points. In eval the three segment
reductions of a forward (an xyz+count sum over 4 channels and the PFN max
sweeps over 16 and 64 channels at hvpr.yaml widths) go through
:func:`ops.segment_sweep.segment_sweep`, kernel K1 on the card. In training
(``module.train()``) they run the plain sweeps under autograd, as the JAX
package runs their XLA twins when ``train=True``, and the BatchNorms take
masked batch statistics (valid points, non-empty pillars).
"""

import torch
from torch import nn

from ....ops.scatter import segment_last_row
from ....ops.segment_sweep import segment_sweep, segment_sweep_plain
from ...model_utils.layers import DenseT, MaskedBatchNorm


def decorate_flat_features(batch_dict, voxel_size, point_cloud_range,
                           use_absolute_xyz=True, with_distance=False,
                           max_seg=32, train=False):
    """Decorated (C_dec, R) rows, the sentinel-carrying slots and the per-row
    xyz segment sums (3, R) of the scale stream. ``train`` takes the plain
    sweep (differentiable) instead of the kernel."""
    pts_t = batch_dict['flat_points']
    slot = batch_dict['flat_slot']
    write = batch_dict['flat_write']
    b, v = batch_dict['voxel_num_points'].shape
    num_slots = b * v
    dev, dt = pts_t.device, pts_t.dtype
    vsz = torch.tensor(voxel_size, dtype=dt, device=dev)[:, None]
    origin = torch.tensor(point_cloud_range[0:3], dtype=dt, device=dev)[:, None]

    safe_slot = torch.where(write, slot, num_slots).to(torch.int32)
    xyz_t = pts_t[:3]
    stacked = torch.cat([torch.where(write[None, :], xyz_t, 0.0),
                         write[None, :].to(dt)], dim=0).contiguous()
    sweep = segment_sweep_plain if train else segment_sweep
    sums4 = sweep(stacked, safe_slot, max_seg, 'sum')
    sums_t, cnt_row = sums4[:3], sums4[3:4]
    means_t = sums_t / torch.clamp(cnt_row, min=1.0)
    f_cluster = xyz_t - means_t

    cell = torch.floor((xyz_t - origin) / vsz)
    f_center = xyz_t - (cell * vsz + vsz / 2 + origin)

    parts = [pts_t if use_absolute_xyz else pts_t[3:], f_cluster, f_center]
    if with_distance:
        parts.append(torch.linalg.norm(xyz_t, dim=0, keepdim=True))
    features_t = torch.cat(parts, dim=0) * write[None, :]
    return features_t, safe_slot, sums_t


class PFNLayer(nn.Module):
    """Linear -> BN -> ReLU -> max over the points of each pillar (flat)."""

    def __init__(self, in_channels, out_channels, use_norm=True,
                 last_layer=False, max_seg=32):
        super().__init__()
        self.last_layer = last_layer
        self.max_seg = max_seg
        out_ch = out_channels if last_layer else out_channels // 2
        self.linear = DenseT(in_channels, out_ch, bias=not use_norm)
        self.norm = MaskedBatchNorm(out_ch) if use_norm else None

    def forward(self, inputs, point_mask, safe_slot):
        x = self.linear(inputs)
        if self.norm is not None:
            x = self.norm(x, point_mask)
        x = torch.relu(x)
        xm = torch.where(point_mask[None, :], x, -1e9).contiguous()
        sweep = segment_sweep_plain if self.training else segment_sweep
        seg = sweep(xm, safe_slot, self.max_seg, 'max')
        seg = torch.where(point_mask[None, :], seg, 0.0)
        if self.last_layer:
            return seg
        x = torch.where(point_mask[None, :], x, 0.0)
        return torch.cat([x, seg], dim=0)


class PillarVFE_Scale(nn.Module):
    """PFN layers over decorated points plus the scale-feature MLP over
    (count, |mean|, mean xyz) per pillar."""

    def __init__(self, model_cfg, num_point_features, voxel_size,
                 point_cloud_range, max_points_per_voxel=32):
        super().__init__()
        self.model_cfg = model_cfg
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.max_seg = max_points_per_voxel
        self.use_absolute_xyz = model_cfg.get('USE_ABSLOTE_XYZ', True)
        self.with_distance = model_cfg.get('WITH_DISTANCE', False)
        num_filters = list(model_cfg['NUM_FILTERS'])
        use_norm = model_cfg.get('USE_NORM', True)

        in_ch = num_point_features + 6
        if not self.use_absolute_xyz:
            in_ch -= 3
        if self.with_distance:
            in_ch += 1
        layers = []
        for i, out_ch in enumerate(num_filters):
            last = i == len(num_filters) - 1
            layers.append(PFNLayer(in_ch, out_ch, use_norm, last_layer=last,
                                   max_seg=max_points_per_voxel))
            in_ch = out_ch
        self.pfn_layers = nn.ModuleList(layers)

        scale_layers, in_ch = [], 5
        for out_ch in model_cfg['NUM_SCALE_FEATURES']:
            scale_layers.append(nn.Sequential(DenseT(in_ch, out_ch),
                                              MaskedBatchNorm(out_ch),
                                              nn.ReLU()))
            in_ch = out_ch
        self.pfn_scale_layers = nn.ModuleList(scale_layers)

    def get_output_feature_dim(self):
        return list(self.model_cfg['NUM_FILTERS'])[-1]

    def forward(self, batch_dict):
        features_t, safe_slot, sums_t = decorate_flat_features(
            batch_dict, self.voxel_size, self.point_cloud_range,
            use_absolute_xyz=self.use_absolute_xyz,
            with_distance=self.with_distance, max_seg=self.max_seg,
            train=self.training)
        counts = batch_dict['voxel_num_points']
        b, v = counts.shape
        write = batch_dict['flat_write']
        for layer in self.pfn_layers:
            features_t = layer(features_t, write, safe_slot)

        # one column gather extracts pillar features and xyz sums per slot
        last = segment_last_row(safe_slot, b * v)
        src = torch.cat([features_t, sums_t], dim=0)
        cols = src[:, torch.clamp(last, min=0)]
        cols = torch.where((last >= 0)[None, :], cols, 0.0)
        features = cols[:-3].t().reshape(b, v, -1)
        cnt = torch.clamp(counts.reshape(1, -1).to(cols.dtype), min=1.0)
        means_t = cols[-3:] / cnt                                       # (3, B*V)

        d_mean = torch.linalg.norm(means_t, dim=0, keepdim=True)
        scale_t = torch.cat([counts.reshape(1, -1).to(features.dtype),
                             d_mean, means_t], dim=0)                   # (5, B*V)
        voxel_mask = counts.reshape(-1) > 0
        for dense, norm, relu in self.pfn_scale_layers:
            scale_t = relu(norm(dense(scale_t), voxel_mask))

        batch_dict['pillar_features'] = features
        batch_dict['pillar_scale_features'] = scale_t.t().reshape(b, v, -1)
        return batch_dict
