"""Axis-aligned "nearest BEV" IoU of the target assigner (port of
``boxes3d_nearest_bev_iou`` in ``hvpr_tpu/utils/box_utils.py``)."""

import math

import torch

from .common_utils import limit_period


def boxes3d_lidar_to_aligned_bev_boxes(boxes3d):
    """(N, 7+) -> (N, 4) [x1, y1, x2, y2]: the BEV box at the nearest
    0 / 90 degree orientation."""
    rot = limit_period(boxes3d[:, 6], offset=0.5, period=math.pi).abs()
    dims = torch.where(rot[:, None] < math.pi / 4, boxes3d[:, 3:5],
                       boxes3d[:, [4, 3]])
    return torch.cat([boxes3d[:, 0:2] - dims / 2, boxes3d[:, 0:2] + dims / 2], dim=1)


def boxes3d_nearest_bev_iou(boxes_a, boxes_b):
    """(N, 7+), (M, 7+) -> (N, M) axis-aligned IoU of the nearest BEV boxes."""
    a = boxes3d_lidar_to_aligned_bev_boxes(boxes_a)
    b = boxes3d_lidar_to_aligned_bev_boxes(boxes_b)
    x_min = torch.maximum(a[:, None, 0], b[None, :, 0])
    y_min = torch.maximum(a[:, None, 1], b[None, :, 1])
    x_max = torch.minimum(a[:, None, 2], b[None, :, 2])
    y_max = torch.minimum(a[:, None, 3], b[None, :, 3])
    inter = torch.clamp(x_max - x_min, min=0) * torch.clamp(y_max - y_min, min=0)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / torch.clamp(union, min=1e-6)
