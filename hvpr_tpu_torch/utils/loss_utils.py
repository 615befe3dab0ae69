"""Detection losses (port of ``hvpr_tpu/utils/loss_utils.py``): sigmoid focal
classification, code-weighted smooth-L1, softmax cross-entropy over the
direction bins, and the heading helpers of the anchor head."""

import math

import torch

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

    def __call__(self, input, target, weights=None):
        target = torch.where(torch.isnan(target), input, target)
        diff = input - target
        if self.code_weights is not None:
            diff = diff * self.code_weights.to(diff.device)
        n = diff.abs()
        if self.beta < 1e-5:
            loss = n
        else:
            loss = torch.where(n < self.beta, 0.5 * n ** 2 / self.beta, n - 0.5 * self.beta)
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
