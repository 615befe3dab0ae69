"""CBAM spatial attention gate, NCHW.

Port of ``hvpr_tpu/models/backbones_2d/spatial_attention.py``: pool the
scale map channelwise to [max, mean], 3x3 conv + BN, sigmoid, gate x. The
conv runs in f32 on the (possibly bf16) pooled map, as flax promotes it.
Keys follow the reference: ``spatial.conv``, ``spatial.norm``. In training
``splits`` gives the BN per-split statistics of the stacked dual pass.
"""

import torch
from torch import nn

from ..model_utils.layers import Conv2d, SplitBatchNorm


def channel_pool(x):
    """(B, C, H, W) -> (B, 2, H, W): channelwise [max, mean]."""
    return torch.cat([x.amax(dim=1, keepdim=True),
                      x.mean(dim=1, keepdim=True)], dim=1)


class _SpatialGate(nn.Module):

    def __init__(self):
        super().__init__()
        self.conv = Conv2d(2, 1, 3, padding=1, bias=True)
        self.norm = SplitBatchNorm(1)

    def forward(self, w, splits=1):
        return torch.sigmoid(self.norm(self.conv(channel_pool(w)), splits))


class SpatialAttention(nn.Module):
    """``sigmoid(BN(conv3x3(channel_pool(w)))) * x``."""

    def __init__(self):
        super().__init__()
        self.spatial = _SpatialGate()

    def forward(self, x, w, splits=1):
        return self.spatial(w, splits) * x
