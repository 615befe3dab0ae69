"""Pillar feature encoder over the flat and the padded pillar layouts.

Port of ``hvpr_tpu/models/backbones_3d/vfe/pillar_vfe.py``
(``decorate_flat_features``, ``decorate_pillar_features``, ``PFNLayer``,
``PillarVFE``, ``PillarVFE_Scale``, and ``MeanVFE``, the SECOND family's
per-voxel mean); a batch with ``flat_points`` (the device voxelizer)
takes the flat branch, one with ``voxels`` (host-voxelized, the data layer's
batches) the padded one. Both share the weights. Rows stay channel-major
(C, R): in the flat layout R = B*N sorted points, in the padded one
R = B*V*P pillar slots, where the max over the points of a pillar is a
masked max over the P axis and fully empty pillars get 0. The padded branch
is plain PyTorch, as the JAX package's is XLA: the pillar sums are sums
along P and the centres come from ``voxel_coords``, in the flat branch's
order, so both layouts give the same pillar features bit for bit. In eval
the segment reductions of a flat forward (an xyz+count sum over 4 channels
and one PFN max sweep a layer: over 16 and 64 channels at hvpr.yaml
widths, over 64 at pointpillar.yaml's single layer) go through
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


def _sums_along_p(x):
    """(B, V, P, C) points, zero past each pillar's count -> every point's
    pillar sum along P, in the flat layout's order: a running sum forward
    plus one backward less the point, each a doubling sweep along P with
    zeros past either end, so the sums equal the flat sweep's bit for bit."""
    p = x.shape[2]

    def running(y, reverse):
        d = 1
        while d < p:
            pad = torch.zeros_like(y[:, :, :d])
            shifted = torch.cat([y[:, :, d:], pad] if reverse else [pad, y[:, :, :-d]], dim=2)
            y = y + shifted
            d *= 2
        return y

    return running(x, False) + running(x, True) - x


def decorate_pillar_features(voxels, num_points, coords, voxel_size,
                             point_cloud_range, use_absolute_xyz=True,
                             with_distance=False):
    """Padded-layout decoration: (B, V, P, C_in) host-voxelized points (zero
    past each pillar's count), (B, V) counts and (B, V, 3) (z, y, x) cells
    -> the decorated rows (C_dec, B*V*P) (zero on padded points), the point
    mask (B*V*P,) and the pillar xyz means (3, B*V).

    As in the JAX package, the means are the sums along P over the counts
    and the centres come from ``coords``; the sums are taken in the flat
    branch's order and the centres in its expression, so both layouts give
    the same pillar features bit for bit (the JAX package's two branches
    agree to f32 rounding)."""
    b, v, p, c = voxels.shape
    dev, dt = voxels.device, voxels.dtype
    vsz = torch.tensor(voxel_size, dtype=dt, device=dev)[:, None]
    origin = torch.tensor(point_cloud_range[0:3], dtype=dt, device=dev)[:, None]
    pts_t = voxels.reshape(-1, c).t()                                   # (C_in, R)
    xyz_t = pts_t[:3]
    sums_t = _sums_along_p(voxels[..., :3]).reshape(-1, 3).t()           # (3, R)
    counts = num_points.reshape(1, -1)                                  # (1, B*V)
    per_point = counts.repeat_interleave(p, dim=1).to(dt)
    f_cluster = xyz_t - sums_t / torch.clamp(per_point, min=1.0)

    cell = coords.flip(-1).reshape(-1, 3).t().repeat_interleave(p, dim=1).to(dt)
    f_center = xyz_t - (cell * vsz + vsz / 2 + origin)

    parts = [pts_t if use_absolute_xyz else pts_t[3:], f_cluster, f_center]
    if with_distance:
        parts.append(torch.linalg.norm(xyz_t, dim=0, keepdim=True))
    point_mask = (torch.arange(p, device=dev) < num_points[..., None]).reshape(-1)
    features_t = torch.cat(parts, dim=0) * point_mask[None, :]

    # the pillar sums are those of each pillar's last point, as in the flat branch
    last = torch.arange(b * v, device=dev) * p + torch.clamp(counts[0] - 1, min=0)
    pillar_sums = torch.where(counts > 0, sums_t[:, last], 0.0)
    return features_t, point_mask, pillar_sums / torch.clamp(counts.to(dt), min=1.0)


class PFNLayer(nn.Module):
    """Linear -> BN -> ReLU -> max over the points of each pillar."""

    def __init__(self, in_channels, out_channels, use_norm=True,
                 last_layer=False, max_seg=32):
        super().__init__()
        self.last_layer = last_layer
        self.max_seg = max_seg
        out_ch = out_channels if last_layer else out_channels // 2
        self.linear = DenseT(in_channels, out_ch, bias=not use_norm)
        self.norm = MaskedBatchNorm(out_ch) if use_norm else None

    def forward(self, inputs, point_mask, safe_slot=None, padded=None):
        """(C_in, R) rows and their (R,) mask; flat: ``safe_slot`` (R,) the
        rows' pillar slots; padded: ``padded`` = (B, V, P), the rows being
        the B*V*P pillar slots. The last layer returns one row per pillar,
        (C_out, R) flat and (B, V, C_out) padded."""
        x = self.linear(inputs)
        if self.norm is not None:
            x = self.norm(x, point_mask)
        x = torch.relu(x)
        if padded is not None:
            return self._padded_max(x, point_mask, padded)
        xm = torch.where(point_mask[None, :], x, -1e9).contiguous()
        sweep = segment_sweep_plain if self.training else segment_sweep
        seg = sweep(xm, safe_slot, self.max_seg, 'max')
        seg = torch.where(point_mask[None, :], seg, 0.0)
        if self.last_layer:
            return seg
        x = torch.where(point_mask[None, :], x, 0.0)
        return torch.cat([x, seg], dim=0)

    def _padded_max(self, x, point_mask, padded):
        b, v, p = padded
        c = x.shape[0]
        mask = point_mask.reshape(1, b, v, p)
        x = torch.where(mask, x.reshape(c, b, v, p), -1e9)
        x_max = x.amax(dim=-1, keepdim=True)                            # (C, B, V, 1)
        x_max = torch.where(x_max > -1e8, x_max, 0.0)   # fully empty pillars -> 0
        if self.last_layer:
            return x_max.squeeze(-1).permute(1, 2, 0)
        x = torch.where(mask, x, 0.0)
        return torch.cat([x, x_max.expand_as(x)], dim=0).reshape(2 * c, -1)


class PillarVFE(nn.Module):
    """PFN layers over decorated pillar points -> ``pillar_features``
    (B, V, C). The decorated rows are the points' own channels (with
    ``USE_ABSLOTE_XYZ``), their offsets from the pillar's mean and from its
    centre, and with ``WITH_DISTANCE`` their range: 10 with KITTI's 4-channel
    points, 11 with nuScenes' 5 (x, y, z, intensity, time lag)."""

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

    def get_output_feature_dim(self):
        return list(self.model_cfg['NUM_FILTERS'])[-1]

    def pillars(self, batch_dict):
        """(B, V, C) pillar features and (3, B*V) pillar xyz means of a
        flat (``flat_points``) or a padded (``voxels``) batch."""
        if 'flat_points' in batch_dict:
            b, v = batch_dict['voxel_num_points'].shape
            return self._flat_pillars(batch_dict, b, v)
        return self._padded_pillars(batch_dict)

    def forward(self, batch_dict):
        batch_dict['pillar_features'] = self.pillars(batch_dict)[0]
        return batch_dict

    def _flat_pillars(self, batch_dict, b, v):
        features_t, safe_slot, sums_t = decorate_flat_features(
            batch_dict, self.voxel_size, self.point_cloud_range,
            use_absolute_xyz=self.use_absolute_xyz,
            with_distance=self.with_distance, max_seg=self.max_seg,
            train=self.training)
        write = batch_dict['flat_write']
        for layer in self.pfn_layers:
            features_t = layer(features_t, write, safe_slot)

        # one column gather extracts pillar features and xyz sums per slot
        last = segment_last_row(safe_slot, b * v)
        src = torch.cat([features_t, sums_t], dim=0)
        cols = src[:, torch.clamp(last, min=0)]
        cols = torch.where((last >= 0)[None, :], cols, 0.0)
        cnt = torch.clamp(batch_dict['voxel_num_points'].reshape(1, -1).to(cols.dtype),
                          min=1.0)
        return cols[:-3].t().reshape(b, v, -1), cols[-3:] / cnt

    def _padded_pillars(self, batch_dict):
        voxels = batch_dict['voxels']
        x, point_mask, means_t = decorate_pillar_features(
            voxels, batch_dict['voxel_num_points'], batch_dict['voxel_coords'],
            self.voxel_size, self.point_cloud_range,
            use_absolute_xyz=self.use_absolute_xyz,
            with_distance=self.with_distance)
        for layer in self.pfn_layers:
            x = layer(x, point_mask, padded=voxels.shape[:3])
        return x, means_t


class PillarVFE_Scale(PillarVFE):
    """:class:`PillarVFE` plus the scale-feature MLP over (count, |mean|,
    mean xyz) per pillar -> ``pillar_scale_features``."""

    def __init__(self, model_cfg, num_point_features, voxel_size,
                 point_cloud_range, max_points_per_voxel=32):
        super().__init__(model_cfg, num_point_features, voxel_size,
                         point_cloud_range, max_points_per_voxel)
        scale_layers, in_ch = [], 5
        for out_ch in model_cfg['NUM_SCALE_FEATURES']:
            scale_layers.append(nn.Sequential(DenseT(in_ch, out_ch),
                                              MaskedBatchNorm(out_ch),
                                              nn.ReLU()))
            in_ch = out_ch
        self.pfn_scale_layers = nn.ModuleList(scale_layers)

    def get_scale_feature_dim(self):
        return int(list(self.model_cfg['NUM_SCALE_FEATURES'])[-1])

    def forward(self, batch_dict):
        counts = batch_dict['voxel_num_points']
        b, v = counts.shape
        features, means_t = self.pillars(batch_dict)
        d_mean = torch.linalg.norm(means_t, dim=0, keepdim=True)
        scale_t = torch.cat([counts.reshape(1, -1).to(features.dtype),
                             d_mean, means_t], dim=0)                   # (5, B*V)
        voxel_mask = counts.reshape(-1) > 0
        for dense, norm, relu in self.pfn_scale_layers:
            scale_t = relu(norm(dense(scale_t), voxel_mask))

        batch_dict['pillar_features'] = features
        batch_dict['pillar_scale_features'] = scale_t.t().reshape(b, v, -1)
        return batch_dict


class MeanVFE(nn.Module):
    """Per-voxel mean of the raw point features of a padded batch
    (``voxels`` (B, V, P, C)), the SECOND family's VFE; no weights."""

    def __init__(self, model_cfg, num_point_features, voxel_size=None,
                 point_cloud_range=None, max_points_per_voxel=32):
        super().__init__()
        self.num_point_features = num_point_features

    def get_output_feature_dim(self):
        return self.num_point_features

    def forward(self, batch_dict):
        voxels = batch_dict['voxels']
        counts = torch.clamp(batch_dict['voxel_num_points'][..., None].to(voxels.dtype),
                             min=1.0)
        batch_dict['pillar_features'] = voxels.sum(dim=2) / counts
        return batch_dict
