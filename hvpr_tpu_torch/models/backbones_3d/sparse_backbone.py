"""SECOND-family 3D backbone on sparse convolutions (active sites only).

Port of ``hvpr_tpu/models/backbones_3d/sparse_backbone.py``
(``SubMBlock``, ``SparseDownBlock``, ``_sites_from_batch``,
``VoxelBackBone8xSparse``), on :mod:`hvpr_tpu_torch.ops.sparse_conv`.
Compute scales with the active sites (~16,000-40,000 a KITTI scan), not
with the 40 x 1600 x 1408 grid.

The structure is OpenPCDet's VoxelBackBone8x: a submanifold stem
(``conv_input``, ``conv1``), three stages of a strided sparse conv and two
submanifold convs to stride 8 (``conv2``-``conv4``, channels NUM_FILTERS,
default 32-64-64), closed by ``conv_out``: a (3, 1, 1)-kernel,
(2, 1, 1)-stride, padding-0 sparse conv that halves z. A strided conv
dilates the active set, so every level keeps up to MAX_SITES sites
(default twice the input's site slots); the sites the cap drops are counted
into ``batch_dict['sparse_sites_dropped']`` (B,). The last level's sites are
densified into ``encoded_spconv_tensor`` (B, D, H/8, W/8, C), channels
last, the JAX layout that HeightCompression takes.

Every block is [conv weight, masked BN, ReLU], the reference's
SparseSequential, so the keys are ``conv_input.0.weight``,
``conv2.0.1.running_mean``, ...; a conv weight is (prod K, C_in, C_out) in
the JAX package's tap order, and BN takes its statistics over the valid
sites only (:class:`~hvpr_tpu_torch.models.model_utils.layers.MaskedBatchNorm`
on the channel-major view of the (B, V, C) sites).
"""

import numpy as np
import torch
from torch import nn

from ...ops.gather_rows import gather_rows
from ...ops.sparse_conv import (sparse_conv3d, sparse_conv3d_out_grid, spread_rows,
                                 subm_conv3d)
from ..model_utils.layers import MaskedBatchNorm


class SparseConvWeight(nn.Module):
    """The (prod K, C_in, C_out) weight of one sparse conv."""

    def __init__(self, taps, in_channels, out_channels):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(taps, in_channels, out_channels))
        nn.init.normal_(self.weight, std=(taps * in_channels) ** -0.5)


def site_batch_norm(bn, x, mask):
    """:class:`MaskedBatchNorm` over (B, V, C) sites, statistics from the
    sites where ``mask`` (B, V) is set."""
    b, v, c = x.shape
    return bn(x.reshape(b * v, c).t(), mask.reshape(b * v)).t().reshape(b, v, c)


class SubMBlock(nn.Sequential):
    """Submanifold conv + masked BN + ReLU on an active-site list."""

    def __init__(self, in_channels, features, kernel=3):
        super().__init__(SparseConvWeight(kernel ** 3, in_channels, features),
                         MaskedBatchNorm(features), nn.ReLU())

    def forward(self, feats, coords, valid, grid, cap=None):
        """-> (feats, coords, valid, grid, sites dropped (None: no new sites))."""
        x = subm_conv3d(feats, coords, valid, self[0].weight, grid)
        return self[2](site_batch_norm(self[1], x, valid)), coords, valid, grid, None


class SparseDownBlock(nn.Sequential):
    """Strided sparse conv (a new site list, at most ``cap`` sites) + masked
    BN + ReLU. Per-axis kernel, stride and padding: the stage convs are
    (3, 3, 3) / 2 / 1, ``conv_out`` is (3, 1, 1) / (2, 1, 1) / 0."""

    def __init__(self, in_channels, features, kernel=(3, 3, 3), stride=(2, 2, 2),
                 padding=(1, 1, 1)):
        super().__init__(SparseConvWeight(int(np.prod(kernel)), in_channels, features),
                         MaskedBatchNorm(features), nn.ReLU())
        self.kernel, self.stride, self.padding = tuple(kernel), tuple(stride), tuple(padding)

    def forward(self, feats, coords, valid, grid, cap):
        x, c, m, dropped = sparse_conv3d(feats, coords, valid, self[0].weight, grid,
                                         kernel=self.kernel, stride=self.stride,
                                         padding=self.padding, max_out=cap)
        out_grid = sparse_conv3d_out_grid(grid, self.kernel, self.stride, self.padding)
        return self[2](site_batch_norm(self[1], x, m)), c, m, out_grid, dropped


class SparseStage(nn.Sequential):
    """Blocks run in order on one site list (a strided block first starts a
    new one)."""

    def forward(self, feats, coords, valid, grid, cap):
        dropped = None
        for block in self:
            feats, coords, valid, grid, d = block(feats, coords, valid, grid, cap)
            dropped = d if d is not None else dropped
        return feats, coords, valid, grid, dropped


def _sites_from_batch(batch_dict, grid):
    """Active sites (feats, coords, valid) sorted by linear cell id (invalid
    sites last)."""
    if 'pillar_features' in batch_dict:
        feats = batch_dict['pillar_features']               # (B, V, C) of the VFE
    else:
        voxels = batch_dict['voxels']
        cnt = torch.clamp(batch_dict['voxel_num_points'][..., None].to(voxels.dtype),
                          min=1)
        feats = voxels.sum(dim=2) / cnt
    coords = batch_dict['voxel_coords']
    valid = batch_dict['voxel_mask']
    nz, ny, nx = grid
    c = coords.long()
    lin = c[..., 0] * (ny * nx) + c[..., 1] * nx + c[..., 2]
    lin = torch.where(valid, lin, lin.new_full((), nz * ny * nx))
    order = torch.argsort(lin, dim=1, stable=True)
    return (torch.take_along_dim(feats, order[..., None], dim=1),
            torch.take_along_dim(coords, order[..., None], dim=1),
            torch.take_along_dim(valid, order, dim=1))


class VoxelBackBone8xSparse(nn.Module):
    """Sparse 8x voxel encoder -> dense (B, D/8, H/8, W/8, C) volume."""

    def __init__(self, model_cfg, input_channels, grid_size=None):
        super().__init__()
        self.model_cfg = model_cfg
        self.grid_size = None if grid_size is None else tuple(int(g) for g in grid_size)
        channels = list(model_cfg.get('NUM_FILTERS', [32, 64, 64]))
        self.conv_input = SubMBlock(input_channels, 16)
        self.conv1 = SparseStage(SubMBlock(16, 16))
        c = 16
        self.stage_names = ['conv_input', 'conv1']
        for i, ch in enumerate(channels):
            setattr(self, f'conv{i + 2}', SparseStage(
                SparseDownBlock(c, ch), SubMBlock(ch, ch), SubMBlock(ch, ch)))
            self.stage_names.append(f'conv{i + 2}')
            c = ch
        self.num_point_features = int(model_cfg.get('OUT_CHANNELS', 128))
        self.conv_out = SparseDownBlock(c, self.num_point_features, kernel=(3, 1, 1),
                                        stride=(2, 1, 1), padding=(0, 0, 0))
        self.stage_names.append('conv_out')

    def forward(self, batch_dict):
        nx, ny, nz = (int(g) for g in (self.grid_size if self.grid_size is not None
                                       else batch_dict['grid_size']))
        grid = (nz, ny, nx)
        f, c, m = _sites_from_batch(batch_dict, grid)
        v = f.shape[1]
        # a stride-2 sparse conv dilates the active set (an input touches up
        # to 8 cells of the next level): 2 * V covers sparse far-range scans
        cap = int(self.model_cfg.get('MAX_SITES', 2 * v))
        total_dropped = torch.zeros(f.shape[0], dtype=torch.int32, device=f.device)
        for name in self.stage_names:
            f, c, m, grid, dropped = getattr(self, name)(f, c, m, grid, cap)
            if dropped is not None:
                total_dropped = total_dropped + dropped
        batch_dict['sparse_sites_dropped'] = total_dropped

        # densify the z-compressed stride-8 sites for HeightCompression: each
        # cell gathers its site's row, 0 where it has none (those cells'
        # reads spread over the sites and are masked out)
        dz, dy, dx = grid
        n = dz * dy * dx
        c64 = c.long()
        lin = c64[..., 0] * (dy * dx) + c64[..., 1] * dx + c64[..., 2]
        lin = torch.where(m, lin, lin.new_full((), n))
        b, vf = f.shape[:2]
        rowid = lin.new_full((b, n + 1), -1).scatter(1, lin, torch.where(
            m, torch.arange(vf, device=f.device).expand(b, vf), -1))[:, :n]
        filled = rowid >= 0
        rows = gather_rows(f, torch.where(filled, rowid, spread_rows(rowid.shape, vf,
                                                                      f.device)))
        dense = torch.where(filled[..., None], rows, 0.0).reshape(b, dz, dy, dx, f.shape[-1])
        batch_dict['encoded_spconv_tensor'] = dense
        batch_dict['encoded_spconv_tensor_stride'] = 8
        return batch_dict
