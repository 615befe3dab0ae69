"""3D box geometry: the host (numpy) box transforms of the KITTI data layer
and the axis-aligned "nearest BEV" IoU of the target assigner (torch).

Port of ``hvpr_tpu/utils/box_utils.py``. Box convention (OpenPCDet):
``(x, y, z, dx, dy, dz, heading)`` with (x, y, z) the box center in the
lidar frame, dx/dy/dz the extents along the box axes, and heading the
rotation around +z measured from +x, counter-clockwise.
"""

import math

import numpy as np
import torch

from . import common_utils
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


def in_hull(p, hull):
    """Test (N, K) points against the convex hull of (M, K) points."""
    import scipy.spatial
    try:
        if not isinstance(hull, scipy.spatial.Delaunay):
            hull = scipy.spatial.Delaunay(hull)
        flag = hull.find_simplex(p) >= 0
    except scipy.spatial.QhullError:
        flag = np.zeros(p.shape[0], dtype=bool)
    return flag


def boxes_to_corners_3d(boxes3d):
    """(N, 7) boxes -> (N, 8, 3) corners.

        7 -------- 4
       /|         /|
      6 -------- 5 .
      | |        | |
      . 3 -------- 0
      |/         |/
      2 -------- 1

    Corner order matches the reference (box_utils.py:27-52).
    """
    template = np.asarray([
        [1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1],
        [1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1],
    ], dtype=boxes3d.dtype) / 2.0

    corners3d = boxes3d[:, None, 3:6] * template[None, :, :]
    corners3d = common_utils.rotate_points_along_z(
        corners3d.reshape(-1, 8, 3), boxes3d[:, 6]
    ).reshape(-1, 8, 3)
    corners3d = corners3d + boxes3d[:, None, 0:3]
    return corners3d


def mask_boxes_outside_range_numpy(boxes, limit_range, min_num_corners=1):
    """Keep boxes having >= min_num_corners corners inside the xy limit range."""
    if boxes.shape[1] > 7:
        boxes = boxes[:, 0:7]
    corners = boxes_to_corners_3d(boxes)  # (N, 8, 3)
    mask = ((corners >= np.asarray(limit_range[0:3])) &
            (corners <= np.asarray(limit_range[3:6]))).all(axis=2)
    return mask.sum(axis=1) >= min_num_corners


def remove_points_in_boxes3d(points, boxes3d):
    """Remove points lying inside any of the given boxes (host-side)."""
    from ..ops.points_in_boxes import points_in_boxes_cpu
    point_masks = points_in_boxes_cpu(points[:, 0:3], boxes3d)
    return points[point_masks.sum(axis=0) == 0]


def boxes3d_kitti_camera_to_lidar(boxes3d_camera, calib):
    """(N, 7) [x, y, z, l, h, w, r] in rect camera -> (N, 7) [x, y, z, dx, dy, dz, heading] lidar.

    Camera boxes are bottom-centered; lidar boxes are center-centered.
    """
    xyz_camera = boxes3d_camera[:, 0:3]
    l, h, w, r = boxes3d_camera[:, 3:4], boxes3d_camera[:, 4:5], boxes3d_camera[:, 5:6], boxes3d_camera[:, 6:7]
    xyz_lidar = calib.rect_to_lidar(xyz_camera)
    xyz_lidar[:, 2] += h[:, 0] / 2
    return np.concatenate([xyz_lidar, l, w, h, -(r + np.pi / 2)], axis=-1)


def boxes3d_kitti_fakelidar_to_lidar(boxes3d_lidar):
    """(N, 7) [x, y, z, w, l, h, r] in the old ("fake") lidar convention,
    z at the bottom centre -> (N, 7) [x, y, z, dx, dy, dz, heading], z at
    the centre (the reference's conversion; a gt database written by old
    OpenPCDet versions stores its boxes so). Shifts z of the input in
    place, as the reference does."""
    w, l, h, r = (boxes3d_lidar[:, 3:4], boxes3d_lidar[:, 4:5],
                  boxes3d_lidar[:, 5:6], boxes3d_lidar[:, 6:7])
    boxes3d_lidar[:, 2] += h[:, 0] / 2
    return np.concatenate([boxes3d_lidar[:, 0:3], l, w, h, -(r + np.pi / 2)], axis=-1)


def boxes3d_lidar_to_kitti_camera(boxes3d_lidar, calib):
    """Inverse of :func:`boxes3d_kitti_camera_to_lidar`."""
    xyz_lidar = boxes3d_lidar[:, 0:3].copy()
    l, w, h = boxes3d_lidar[:, 3:4], boxes3d_lidar[:, 4:5], boxes3d_lidar[:, 5:6]
    r = boxes3d_lidar[:, 6:7]

    xyz_lidar[:, 2] -= h[:, 0] / 2
    xyz_cam = calib.lidar_to_rect(xyz_lidar)
    r = -r - np.pi / 2
    return np.concatenate([xyz_cam, l, h, w, r], axis=-1)


def boxes3d_to_corners3d_kitti_camera(boxes3d, bottom_center=True):
    """(N, 7) camera boxes [x, y, z, l, h, w, r] -> (N, 8, 3) corners in camera frame."""
    boxes_num = boxes3d.shape[0]
    l, h, w = boxes3d[:, 3], boxes3d[:, 4], boxes3d[:, 5]
    x_corners = np.array([l / 2., l / 2., -l / 2., -l / 2., l / 2., l / 2., -l / 2., -l / 2.], dtype=np.float32).T
    z_corners = np.array([w / 2., -w / 2., -w / 2., w / 2., w / 2., -w / 2., -w / 2., w / 2.], dtype=np.float32).T
    if bottom_center:
        y_corners = np.zeros((boxes_num, 8), dtype=np.float32)
        y_corners[:, 4:8] = -h.reshape(boxes_num, 1).repeat(4, axis=1)
    else:
        y_corners = np.array([h / 2., h / 2., h / 2., h / 2., -h / 2., -h / 2., -h / 2., -h / 2.], dtype=np.float32).T

    ry = boxes3d[:, 6]
    zeros, ones = np.zeros(ry.size, dtype=np.float32), np.ones(ry.size, dtype=np.float32)
    rot_list = np.array([
        [np.cos(ry), zeros, -np.sin(ry)],
        [zeros, ones, zeros],
        [np.sin(ry), zeros, np.cos(ry)],
    ])  # (3, 3, N)
    R_list = np.transpose(rot_list, (2, 0, 1))  # (N, 3, 3)

    temp_corners = np.concatenate((
        x_corners.reshape(-1, 8, 1), y_corners.reshape(-1, 8, 1), z_corners.reshape(-1, 8, 1)
    ), axis=2)  # (N, 8, 3)
    rotated_corners = np.matmul(temp_corners, R_list)  # (N, 8, 3)
    x_loc, y_loc, z_loc = boxes3d[:, 0], boxes3d[:, 1], boxes3d[:, 2]

    x = x_loc.reshape(-1, 1) + rotated_corners[:, :, 0]
    y = y_loc.reshape(-1, 1) + rotated_corners[:, :, 1]
    z = z_loc.reshape(-1, 1) + rotated_corners[:, :, 2]
    return np.concatenate(
        (x.reshape(-1, 8, 1), y.reshape(-1, 8, 1), z.reshape(-1, 8, 1)), axis=2
    ).astype(np.float32)


def boxes3d_kitti_camera_to_imageboxes(boxes3d, calib, image_shape=None):
    """(N, 7) camera boxes -> (N, 4) [x1, y1, x2, y2] image boxes."""
    corners3d = boxes3d_to_corners3d_kitti_camera(boxes3d)
    pts_img, _ = calib.rect_to_img(corners3d.reshape(-1, 3))
    corners_in_image = pts_img.reshape(-1, 8, 2)

    min_uv = np.min(corners_in_image, axis=1)
    max_uv = np.max(corners_in_image, axis=1)
    boxes2d_image = np.concatenate([min_uv, max_uv], axis=1)
    if image_shape is not None:
        boxes2d_image[:, 0] = np.clip(boxes2d_image[:, 0], a_min=0, a_max=image_shape[1] - 1)
        boxes2d_image[:, 1] = np.clip(boxes2d_image[:, 1], a_min=0, a_max=image_shape[0] - 1)
        boxes2d_image[:, 2] = np.clip(boxes2d_image[:, 2], a_min=0, a_max=image_shape[1] - 1)
        boxes2d_image[:, 3] = np.clip(boxes2d_image[:, 3], a_min=0, a_max=image_shape[0] - 1)
    return boxes2d_image


def enlarge_box3d(boxes3d, extra_width=(0, 0, 0)):
    """Grow box extents by ``2 * extra_width``."""
    large_boxes3d = np.array(boxes3d, copy=True)
    large_boxes3d[:, 3:6] += np.asarray(extra_width, dtype=large_boxes3d.dtype) * 2
    return large_boxes3d
