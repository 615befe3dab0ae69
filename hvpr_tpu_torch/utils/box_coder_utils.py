"""Box residual codecs (port of ``hvpr_tpu/utils/box_coder_utils.py``).

``ResidualCoder``: the SECOND-style 7-dof residual, diagonal-normalized;
with ``encode_angle_by_sincos`` the heading residual is the pair
``cos rg - cos ra, sin rg - sin ra`` (code size 8) and decodes as
``atan2(sin t + sin ra, cos t + cos ra)``. ``PreviousResidualDecoder``
decodes the older (x, y, z, w, l, h, r) encoding (no encode).
``PointResidualCoder`` encodes boxes against points, with the class mean
sizes as anchor dimensions when ``use_mean_size``. A head builds its coder
by name (``TARGET_ASSIGNER_CONFIG.BOX_CODER``) with ``num_dir_bins`` and
``BOX_CODER_CONFIG`` as keyword arguments, as the JAX head does.
"""

import numpy as np
import torch


class ResidualCoder:
    """7-dof residual box codec, diagonal-normalized."""

    def __init__(self, code_size=7, encode_angle_by_sincos=False, **kwargs):
        self.code_size = code_size
        self.encode_angle_by_sincos = encode_angle_by_sincos
        if encode_angle_by_sincos:
            self.code_size += 1

    def encode(self, boxes, anchors):
        """Encode (..., 7+C) boxes against (..., 7+C) anchors."""
        xa, ya, za = anchors[..., 0], anchors[..., 1], anchors[..., 2]
        dxa, dya, dza = torch.clamp(anchors[..., 3:6], min=1e-5).unbind(-1)
        xg, yg, zg = boxes[..., 0], boxes[..., 1], boxes[..., 2]
        dxg, dyg, dzg = torch.clamp(boxes[..., 3:6], min=1e-5).unbind(-1)
        rg, ra = boxes[..., 6], anchors[..., 6]
        diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
        if self.encode_angle_by_sincos:
            rts = [torch.cos(rg) - torch.cos(ra), torch.sin(rg) - torch.sin(ra)]
        else:
            rts = [rg - ra]
        cts = [boxes[..., i] - anchors[..., i] for i in range(7, boxes.shape[-1])]
        return torch.stack([(xg - xa) / diagonal, (yg - ya) / diagonal,
                            (zg - za) / dza, torch.log(dxg / dxa),
                            torch.log(dyg / dya), torch.log(dzg / dza),
                            *rts, *cts], dim=-1)

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
        if self.encode_angle_by_sincos:
            cost, sint = box_encodings[..., 6], box_encodings[..., 7]
            rg = torch.atan2(sint + torch.sin(ra), cost + torch.cos(ra))
            extra_start = 8
        else:
            rg = box_encodings[..., 6] + ra
            extra_start = 7
        cgs = [box_encodings[..., i] + anchors[..., i - extra_start + 7]
               for i in range(extra_start, box_encodings.shape[-1])]
        return torch.stack([xg, yg, zg, dxg, dyg, dzg, rg, *cgs], dim=-1)


class PreviousResidualDecoder:
    """Decoder of the older (x, y, z, w, l, h, r) encoding."""

    def __init__(self, code_size=7, **kwargs):
        self.code_size = code_size

    @staticmethod
    def decode(box_encodings, anchors):
        xa, ya, za, dxa, dya, dza, ra = anchors[..., :7].unbind(-1)
        xt, yt, zt, wt, lt, ht, rt = box_encodings[..., :7].unbind(-1)
        diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
        cgs = [box_encodings[..., i] + anchors[..., i]
               for i in range(7, box_encodings.shape[-1])]
        return torch.stack([xt * diagonal + xa, yt * diagonal + ya, zt * dza + za,
                            torch.exp(lt) * dxa, torch.exp(wt) * dya,
                            torch.exp(ht) * dza, rt + ra, *cgs], dim=-1)


class PointResidualCoder:
    """Boxes against points, the heading as (cos, sin); with
    ``use_mean_size`` the class's mean size (``mean_size``, one row a
    class, classes counted from 1) normalizes as an anchor's dimensions."""

    def __init__(self, code_size=8, use_mean_size=True, **kwargs):
        self.code_size = code_size
        self.use_mean_size = use_mean_size
        if use_mean_size:
            self.mean_size = np.asarray(kwargs['mean_size'], dtype=np.float32)
            assert self.mean_size.min() > 0

    def _anchor_size(self, classes, like):
        mean_size = torch.as_tensor(self.mean_size, device=like.device)
        return mean_size[classes.long() - 1].unbind(-1)

    def encode(self, gt_boxes, points, gt_classes=None):
        xg, yg, zg = gt_boxes[..., 0], gt_boxes[..., 1], gt_boxes[..., 2]
        dxg, dyg, dzg = torch.clamp(gt_boxes[..., 3:6], min=1e-5).unbind(-1)
        rg = gt_boxes[..., 6]
        xa, ya, za = points[..., 0], points[..., 1], points[..., 2]
        if self.use_mean_size:
            dxa, dya, dza = self._anchor_size(gt_classes, gt_boxes)
            diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
            res = [(xg - xa) / diagonal, (yg - ya) / diagonal, (zg - za) / dza,
                   torch.log(dxg / dxa), torch.log(dyg / dya), torch.log(dzg / dza)]
        else:
            res = [xg - xa, yg - ya, zg - za, torch.log(dxg), torch.log(dyg),
                   torch.log(dzg)]
        cts = [gt_boxes[..., i] for i in range(7, gt_boxes.shape[-1])]
        return torch.stack([*res, torch.cos(rg), torch.sin(rg), *cts], dim=-1)

    def decode(self, box_encodings, points, pred_classes=None):
        xt, yt, zt, dxt, dyt, dzt, cost, sint = box_encodings[..., :8].unbind(-1)
        xa, ya, za = points[..., 0], points[..., 1], points[..., 2]
        if self.use_mean_size:
            dxa, dya, dza = self._anchor_size(pred_classes, box_encodings)
            diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
            res = [xt * diagonal + xa, yt * diagonal + ya, zt * dza + za,
                   torch.exp(dxt) * dxa, torch.exp(dyt) * dya, torch.exp(dzt) * dza]
        else:
            res = [xt + xa, yt + ya, zt + za, torch.exp(dxt), torch.exp(dyt),
                   torch.exp(dzt)]
        cgs = [box_encodings[..., i] for i in range(8, box_encodings.shape[-1])]
        return torch.stack([*res, torch.atan2(sint, cost), *cgs], dim=-1)


def build_box_coder(target_cfg):
    """TARGET_ASSIGNER_CONFIG's coder: the class named by BOX_CODER, given
    NUM_DIR_BINS and BOX_CODER_CONFIG."""
    name = target_cfg['BOX_CODER']
    coder = {'ResidualCoder': ResidualCoder,
             'PreviousResidualDecoder': PreviousResidualDecoder,
             'PointResidualCoder': PointResidualCoder}.get(name)
    if coder is None:
        raise NotImplementedError(f'BOX_CODER {name!r}')
    return coder(num_dir_bins=target_cfg.get('NUM_DIR_BINS', 6),
                 **target_cfg.get('BOX_CODER_CONFIG', {}))
