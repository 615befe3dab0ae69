"""SECOND-style residual box codec (port of ``ResidualCoder`` in
``hvpr_tpu/utils/box_coder_utils.py``)."""

import torch


class ResidualCoder:
    """7-dof residual box codec, diagonal-normalized."""

    def __init__(self, code_size=7, encode_angle_by_sincos=False, **kwargs):
        if encode_angle_by_sincos:
            raise NotImplementedError('encode_angle_by_sincos is not ported')
        self.code_size = code_size

    def encode(self, boxes, anchors):
        """Encode (..., 7+C) boxes against (..., 7+C) anchors."""
        xa, ya, za = anchors[..., 0], anchors[..., 1], anchors[..., 2]
        dxa, dya, dza = torch.clamp(anchors[..., 3:6], min=1e-5).unbind(-1)
        xg, yg, zg = boxes[..., 0], boxes[..., 1], boxes[..., 2]
        dxg, dyg, dzg = torch.clamp(boxes[..., 3:6], min=1e-5).unbind(-1)
        diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
        cts = [boxes[..., i] - anchors[..., i] for i in range(7, boxes.shape[-1])]
        return torch.stack([(xg - xa) / diagonal, (yg - ya) / diagonal,
                            (zg - za) / dza, torch.log(dxg / dxa),
                            torch.log(dyg / dya), torch.log(dzg / dza),
                            boxes[..., 6] - anchors[..., 6], *cts], dim=-1)

    def decode(self, box_encodings, anchors):
        """Decode (..., code_size) encodings against (..., 7+C) anchors."""
        xa, ya, za, dxa, dya, dza, ra = anchors[..., :7].unbind(-1)
        xt, yt, zt, dxt, dyt, dzt = box_encodings[..., :6].unbind(-1)
        diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
        xg = xt * diagonal + xa
        yg = yt * diagonal + ya
        zg = zt * dza + za
        dxg = torch.exp(dxt) * dxa
        dyg = torch.exp(dyt) * dya
        dzg = torch.exp(dzt) * dza
        rg = box_encodings[..., 6] + ra
        cgs = [box_encodings[..., i] + anchors[..., i]
               for i in range(7, box_encodings.shape[-1])]
        return torch.stack([xg, yg, zg, dxg, dyg, dzg, rg, *cgs], dim=-1)
