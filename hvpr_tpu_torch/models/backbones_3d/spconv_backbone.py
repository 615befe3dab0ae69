"""SECOND-family 3D voxel backbones on the dense voxel volume.

Port of ``hvpr_tpu/models/backbones_3d/spconv_backbone.py``
(``Conv3DBNReLU``, ``densify_voxels``, ``VoxelBackBone8x`` (registered as
``VoxelBackBone8xDense``), ``_ResBlock3D``, ``VoxelResBackBone8x``,
``UNetV2``): dense 3D convolutions (``nn.Conv3d``, NCDHW, cuDNN) over the
voxel grid with the per-voxel mean features scattered in. Exact for the
same weights as a sparse conv is at the active sites, but tractable only on
coarse grids; the sparse ``VoxelBackBone8x`` serves the production grids.

BN is the JAX package's flax BatchNorm: batch statistics over every cell,
the biased variance in the running var
(:class:`~hvpr_tpu_torch.models.model_utils.layers.SplitBatchNorm`).
The outputs are channels last, as the JAX package's:
``encoded_spconv_tensor`` (B, D/8, H/8, W/8, C) and, from UNetV2,
``voxel_unet_features`` (B, D, H, W, 16).

Keys: ``blocks.{i}`` = [conv, bn, relu] in the order the blocks run (the
residual blocks of VoxelResBackBone8x ``blocks.{2i+1}``, with ``conv1``
[conv, bn, relu], ``conv2`` and ``bn2``), and UNetV2's decoder
``ups.{j}`` = [transpose conv, bn].
"""

import torch
from torch import nn
from torch.nn import functional as F

from ..model_utils.layers import SplitBatchNorm


class Conv3DBNReLU(nn.Sequential):

    def __init__(self, in_channels, features, stride=1, kernel=3):
        super().__init__(
            nn.Conv3d(in_channels, features, kernel, stride=stride,
                      padding=(kernel - 1) // 2, bias=False),
            SplitBatchNorm(features), nn.ReLU())


def densify_voxels(batch_dict, grid_size):
    """Per-voxel mean features scattered into a dense (B, C, D, H, W)
    volume (NCDHW view of a channels-last canvas)."""
    nx, ny, nz = (int(g) for g in grid_size)
    voxels = batch_dict['voxels']                          # (B, V, P, C)
    counts = torch.clamp(batch_dict['voxel_num_points'][..., None].to(voxels.dtype),
                         min=1)
    feats = voxels.sum(dim=2) / counts                     # (B, V, C)
    coords = batch_dict['voxel_coords'].long()             # (B, V, 3) zyx
    mask = batch_dict['voxel_mask']
    b, _, c = feats.shape
    n = nz * ny * nx
    flat = coords[..., 0] * (ny * nx) + coords[..., 1] * nx + coords[..., 2]
    flat = torch.where(mask, flat, flat.new_full((), n))
    canvas = feats.new_zeros(b, n + 1, c).scatter(1, flat[..., None].expand(-1, -1, c),
                                                  feats)[:, :n]
    return canvas.reshape(b, nz, ny, nx, c).permute(0, 4, 1, 2, 3)


def _channels_last(x):
    """(B, C, D, H, W) -> the JAX layout (B, D, H, W, C)."""
    return x.permute(0, 2, 3, 4, 1)


class VoxelBackBone8x(nn.Module):
    """4-stage 3D conv backbone, 8x downsample (channels 16-32-64-64)."""

    def __init__(self, model_cfg, input_channels, grid_size=None):
        super().__init__()
        self.model_cfg = model_cfg
        self.grid_size = grid_size
        plan = [(16, 1), (16, 1), (32, 2), (32, 1), (64, 2), (64, 1), (64, 2), (64, 1)]
        blocks, c = [], input_channels
        for features, stride in plan:
            blocks.append(Conv3DBNReLU(c, features, stride=stride))
            c = features
        self.blocks = nn.Sequential(*blocks)
        self.num_point_features = c

    def forward(self, batch_dict):
        grid = self.grid_size if self.grid_size is not None else batch_dict['grid_size']
        x = self.blocks(densify_voxels(batch_dict, grid))
        batch_dict['encoded_spconv_tensor'] = _channels_last(x)
        batch_dict['encoded_spconv_tensor_stride'] = 8
        return batch_dict


class _ResBlock3D(nn.Module):

    def __init__(self, features):
        super().__init__()
        self.conv1 = Conv3DBNReLU(features, features)
        self.conv2 = nn.Conv3d(features, features, 3, padding=1, bias=False)
        self.bn2 = SplitBatchNorm(features)

    def forward(self, x):
        return F.relu(self.bn2(self.conv2(self.conv1(x))) + x)


class VoxelResBackBone8x(nn.Module):
    """Residual variant of VoxelBackBone8x."""

    def __init__(self, model_cfg, input_channels, grid_size=None):
        super().__init__()
        self.model_cfg = model_cfg
        self.grid_size = grid_size
        blocks, c = [], input_channels
        for features, stride in ((16, 1), (32, 2), (64, 2), (64, 2)):
            blocks += [Conv3DBNReLU(c, features, stride=stride), _ResBlock3D(features)]
            c = features
        self.blocks = nn.Sequential(*blocks)
        self.num_point_features = c

    def forward(self, batch_dict):
        grid = self.grid_size if self.grid_size is not None else batch_dict['grid_size']
        x = self.blocks(densify_voxels(batch_dict, grid))
        batch_dict['encoded_spconv_tensor'] = _channels_last(x)
        batch_dict['encoded_spconv_tensor_stride'] = 8
        return batch_dict


class UNetV2(nn.Module):
    """Encoder-decoder over the dense voxel volume with skip connections:
    the 8x encoded volume and per-voxel features at full resolution
    (``voxel_unet_features``)."""

    def __init__(self, model_cfg, input_channels, grid_size=None):
        super().__init__()
        self.model_cfg = model_cfg
        self.grid_size = grid_size
        self.blocks = nn.ModuleList([
            Conv3DBNReLU(input_channels, 16), Conv3DBNReLU(16, 32, stride=2),
            Conv3DBNReLU(32, 64, stride=2), Conv3DBNReLU(64, 64, stride=2)])
        self.ups = nn.ModuleList(
            nn.Sequential(nn.ConvTranspose3d(c_in, c_out, 2, stride=2, bias=False),
                          SplitBatchNorm(c_out))
            for c_in, c_out in ((64, 64), (64, 32), (32, 16)))
        self.num_point_features = 64

    def forward(self, batch_dict):
        grid = self.grid_size if self.grid_size is not None else batch_dict['grid_size']
        x0 = self.blocks[0](densify_voxels(batch_dict, grid))
        x1 = self.blocks[1](x0)
        x2 = self.blocks[2](x1)
        x3 = self.blocks[3](x2)
        x = x3
        for up, skip in zip(self.ups, (x2, x1, x0)):
            # odd encoder dims ceil-halve under stride 2, so the doubled
            # upsampling can exceed the skip by a cell an axis: crop to it
            x = up(x)[:, :, :skip.shape[2], :skip.shape[3], :skip.shape[4]]
            x = F.relu(x) + skip
        batch_dict['encoded_spconv_tensor'] = _channels_last(x3)
        batch_dict['encoded_spconv_tensor_stride'] = 8
        batch_dict['voxel_unet_features'] = _channels_last(x)
        return batch_dict
