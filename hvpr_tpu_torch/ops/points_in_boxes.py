"""Point-in-rotated-box test on the host (port of ``points_in_boxes_cpu`` in
``hvpr_tpu/ops/points_in_boxes.py``): the native C++ library when it
builds, else numpy. Counts the points inside each gt box of a KITTI info."""

import numpy as np

from ..native import geometry as native_geometry


def points_in_boxes_cpu(points, boxes):
    """(N, 3) points x (M, 7) [x, y, z, dx, dy, dz, heading] boxes (z = box
    center) -> (M, N) int32, 1 where point n lies inside box m."""
    points = np.asarray(points, dtype=np.float32)
    boxes = np.asarray(boxes, dtype=np.float32)
    if boxes.shape[0] == 0 or points.shape[0] == 0:
        return np.zeros((boxes.shape[0], points.shape[0]), dtype=np.int32)
    if native_geometry.available():
        return native_geometry.points_in_boxes(points, boxes)

    dx = points[None, :, 0] - boxes[:, None, 0]
    dy = points[None, :, 1] - boxes[:, None, 1]
    dz = points[None, :, 2] - boxes[:, None, 2]
    cosa = np.cos(boxes[:, 6])[:, None]
    sina = np.sin(boxes[:, 6])[:, None]
    local_x = dx * cosa + dy * sina
    local_y = -dx * sina + dy * cosa
    in_box = ((np.abs(local_x) <= boxes[:, None, 3] / 2)
              & (np.abs(local_y) <= boxes[:, None, 4] / 2)
              & (np.abs(dz) <= boxes[:, None, 5] / 2))
    return in_box.astype(np.int32)
