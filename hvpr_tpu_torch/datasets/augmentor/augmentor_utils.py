"""World-level augmentations as composable linear maps (host side, numpy).

The port's copy of ``hvpr_tpu/datasets/augmentor/augmentor_utils.py``: every
world augmentation contributes one 3x3 linear map (a signed permutation, a
z-rotation, an isotropic scale), consecutive maps compose into a single
matrix, and the scene (points, boxes) is transformed once. Headings are
updated by pushing the heading direction vector through the composed map,
which handles reflections, rotations and their compositions alike (flip
y -> -y gives -h; flip x -> -x gives pi - h, equal to -(h + pi) mod 2 pi).

Box layout: (N, >=7) [x y z dx dy dz heading (vx vy) (extra...)]; the
velocity columns, when present, follow the rotation and reflection but not
the scale.
"""

import numpy as np

IDENTITY = np.eye(3, dtype=np.float64)


def flip_y_matrix():
    """Mirror across the x axis (y -> -y)."""
    return np.diag([1.0, -1.0, 1.0])


def flip_x_matrix():
    """Mirror across the y axis (x -> -x)."""
    return np.diag([-1.0, 1.0, 1.0])


def rotation_z_matrix(angle):
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def scale_matrix(scale):
    return np.eye(3) * scale


def compose(*linears):
    """Right-to-left composition: compose(B, A) applies A first, then B."""
    out = IDENTITY
    for lin in reversed(linears):
        out = lin @ out
    return out


def transform_scene(linear, gt_boxes, points):
    """Apply one composed world map to a scene; returns the transformed
    (gt_boxes, points), both new arrays.

    ``linear`` must be an isotropic-scaled z-rotation times optional axis
    reflections (the only maps the samplers below produce), so the box
    dims scale by |det|^(1/3) and headings stay well defined.
    """
    linear = np.asarray(linear)
    points = np.asarray(points)
    gt_boxes = np.asarray(gt_boxes)

    points = points.copy()
    points[:, :3] = points[:, :3] @ linear.T

    scale = float(np.cbrt(abs(np.linalg.det(linear))))
    boxes = gt_boxes.copy()
    boxes[:, :3] = boxes[:, :3] @ linear.T
    boxes[:, 3:6] *= scale

    # heading: transform the planar direction vector, read the angle back
    h = gt_boxes[:, 6]
    direction = np.stack([np.cos(h), np.sin(h)], axis=1) @ linear[:2, :2].T
    boxes[:, 6] = np.arctan2(direction[:, 1], direction[:, 0])

    if boxes.shape[1] > 8:
        # velocity columns rotate and reflect but do not scale
        boxes[:, 7:9] = gt_boxes[:, 7:9] @ (linear[:2, :2].T / scale)
    return boxes, points


# -- samplers: they draw from numpy's global RNG, so that the DataLoader's
#    seeding of each worker applies -------------------------------------------

def sample_flip(axis):
    """A mirror with probability 1/2. ``axis`` is the axis flipped along, as
    in the reference's naming: along x mirrors y, along y mirrors x."""
    if np.random.random() < 0.5:
        return flip_y_matrix() if axis == 'x' else flip_x_matrix()
    return IDENTITY


def sample_rotation(rot_range):
    return rotation_z_matrix(np.random.uniform(rot_range[0], rot_range[1]))


def sample_scaling(scale_range):
    if scale_range[1] - scale_range[0] < 1e-3:
        return IDENTITY
    return scale_matrix(np.random.uniform(scale_range[0], scale_range[1]))


# -- one augmentation a call --------------------------------------------------

def random_flip_along_x(gt_boxes, points):
    return transform_scene(sample_flip('x'), gt_boxes, points)


def random_flip_along_y(gt_boxes, points):
    return transform_scene(sample_flip('y'), gt_boxes, points)


def global_rotation(gt_boxes, points, rot_range):
    return transform_scene(sample_rotation(rot_range), gt_boxes, points)


def global_scaling(gt_boxes, points, scale_range):
    return transform_scene(sample_scaling(scale_range), gt_boxes, points)
