"""Detection losses (port of ``hvpr_tpu/utils/loss_utils.py``): sigmoid focal
classification, code-weighted smooth-L1 and L1, softmax cross-entropy over
the direction bins, the corner-distance loss of two box sets, and the
heading helpers of the anchor head."""

import math

import torch

from .box_utils import boxes_to_corners_3d
from .common_utils import limit_period


class SigmoidFocalClassificationLoss:
    """Sigmoid focal loss; returns the (B, A, K) weighted loss."""

    def __init__(self, gamma=2.0, alpha=0.25):
        self.alpha = alpha
        self.gamma = gamma

    def __call__(self, input, target, weights):
        pred = torch.sigmoid(input)
        alpha_weight = target * self.alpha + (1 - target) * (1 - self.alpha)
        pt = target * (1.0 - pred) + (1.0 - target) * pred
        focal_weight = alpha_weight * torch.pow(pt, self.gamma)
        bce = (torch.clamp(input, min=0) - input * target
               + torch.log1p(torch.exp(-input.abs())))
        return focal_weight * bce * weights[..., None]


class WeightedSmoothL1Loss:
    """Code-weighted smooth-L1 with transition ``beta`` (1/9 by default);
    NaN targets are ignored. Returns the (B, A, code) weighted loss."""

    def __init__(self, beta=1.0 / 9.0, code_weights=None):
        self.beta = beta
        self.code_weights = (None if code_weights is None
                             else torch.tensor(code_weights, dtype=torch.float32))

    @staticmethod
    def smooth_l1_loss(diff, beta):
        n = diff.abs()
        if beta < 1e-5:
            return n
        return torch.where(n < beta, 0.5 * n ** 2 / beta, n - 0.5 * beta)

    def __call__(self, input, target, weights=None):
        target = torch.where(torch.isnan(target), input, target)
        diff = input - target
        if self.code_weights is not None:
            diff = diff * self.code_weights.to(diff.device)
        loss = self.smooth_l1_loss(diff, self.beta)
        return loss if weights is None else loss * weights[..., None]


class WeightedL1Loss:
    """Code-weighted L1; NaN targets are ignored. Returns the (B, A, code)
    weighted loss."""

    def __init__(self, code_weights=None):
        self.code_weights = (None if code_weights is None
                             else torch.tensor(code_weights, dtype=torch.float32))

    def __call__(self, input, target, weights=None):
        target = torch.where(torch.isnan(target), input, target)
        diff = input - target
        if self.code_weights is not None:
            diff = diff * self.code_weights.to(diff.device)
        loss = diff.abs()
        return loss if weights is None else loss * weights[..., None]


class WeightedCrossEntropyLoss:
    """Softmax cross-entropy over the last axis against one-hot targets."""

    def __call__(self, input, target, weights):
        return -(target * torch.log_softmax(input, dim=-1)).sum(dim=-1) * weights


def add_sin_difference(boxes1, boxes2, dim=6):
    """Heading residual as sin(a - b) = sin a cos b - cos a sin b, split
    between the two boxes."""
    rad_pred = torch.sin(boxes1[..., dim:dim + 1]) * torch.cos(boxes2[..., dim:dim + 1])
    rad_tg = torch.cos(boxes1[..., dim:dim + 1]) * torch.sin(boxes2[..., dim:dim + 1])
    b1 = torch.cat([boxes1[..., :dim], rad_pred, boxes1[..., dim + 1:]], dim=-1)
    b2 = torch.cat([boxes2[..., :dim], rad_tg, boxes2[..., dim + 1:]], dim=-1)
    return b1, b2


def get_direction_target(anchors, reg_targets, dir_offset, num_bins):
    """(B, A, num_bins) one-hot direction-bin targets."""
    rot_gt = reg_targets[..., 6] + anchors[None, :, 6]
    offset_rot = limit_period(rot_gt - dir_offset, 0, 2 * math.pi)
    dir_cls = torch.clamp(torch.floor(offset_rot / (2 * math.pi / num_bins)).long(),
                          0, num_bins - 1)
    return torch.nn.functional.one_hot(dir_cls, num_bins).to(reg_targets.dtype)


def get_corner_loss_lidar(pred_bbox3d, gt_bbox3d):
    """(N,) corner-distance loss of (N, 7) predicted against (N, 7) gt
    boxes: per corner the smaller distance to the gt's corners and to those
    of the gt turned by pi, smooth-L1 (beta 1), the mean over the 8."""
    assert pred_bbox3d.shape[0] == gt_bbox3d.shape[0]
    pred = boxes_to_corners_3d(pred_bbox3d)
    gt = boxes_to_corners_3d(gt_bbox3d)
    flip = gt_bbox3d.clone()
    flip[:, 6] = flip[:, 6] + math.pi
    gt_flip = boxes_to_corners_3d(flip)
    corner_dist = torch.minimum(torch.linalg.vector_norm(pred - gt, dim=2),
                                torch.linalg.vector_norm(pred - gt_flip, dim=2))
    return WeightedSmoothL1Loss.smooth_l1_loss(corner_dist, beta=1.0).mean(dim=1)
