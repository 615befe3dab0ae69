"""Height compression for the 3D-conv backbones.

Port of ``hvpr_tpu/models/backbones_2d/map_to_bev/height_compression.py``:
the z axis of the dense (B, D, H, W, C) volume ``encoded_spconv_tensor``
folds into the channels of the NHWC BEV map ``spatial_features``
(B, H, W, D*C). The channel order is the JAX package's, d*C + c (a
transpose to (B, H, W, D, C), then a reshape); upstream OpenPCDet's
``view(N, C*D, H, W)`` of an NCDHW tensor gives c*D + d instead, so a
reference checkpoint's first BEV conv would need its input channels
permuted.
"""

from torch import nn


class HeightCompression(nn.Module):

    def __init__(self, model_cfg, grid_size=None):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_bev_features = int(model_cfg['NUM_BEV_FEATURES'])

    def forward(self, batch_dict):
        x = batch_dict['encoded_spconv_tensor']              # (B, D, H, W, C)
        b, d, h, w, c = x.shape
        batch_dict['spatial_features'] = x.permute(0, 2, 3, 1, 4).reshape(b, h, w, d * c)
        batch_dict['spatial_features_stride'] = batch_dict.get(
            'encoded_spconv_tensor_stride', 8)
        return batch_dict
