"""KITTI sensor calibration as precomputed homogeneous frame transforms.

The port's copy of ``hvpr_tpu/utils/calibration_kitti.py``: the calib file
is parsed by key (``P2:``, ``R0_rect:``, ``Tr_velo_to_cam:``), the
velodyne<->rectified-camera mapping is folded once into a single 4x4 matrix
(and its inverse) at construction, and every projection is one homogeneous
matrix application. Supports arbitrary leading batch dimensions.

Frames (KITTI devkit conventions):
    lidar  — velodyne: x forward, y left, z up.
    rect   — rectified camera 2: x right, y down, z forward.
    image  — pixel (u, v) via the P2 projection matrix.
"""

import numpy as np

_F32 = np.float32


def _to_4x4(m):
    """Embed a (3, 3) rotation or (3, 4) rigid transform into SE(3) 4x4."""
    out = np.eye(4, dtype=_F32)
    out[:3, : m.shape[1]] = m
    return out


def _apply(matrix, pts):
    """Apply a homogeneous (4, 4) [or (3, 4)] transform to (..., 3) points."""
    res = pts @ matrix[:3, :3].T + matrix[:3, 3]
    return res.astype(_F32, copy=False)


def parse_calib_file(path):
    """Read a KITTI calib txt into {key: (rows, cols) float array}.

    Lines look like ``P2: v0 v1 ... v11``; matrices with 12 values are
    (3, 4), with 9 values (3, 3).
    """
    mats = {}
    with open(path) as f:
        for line in f:
            if ':' not in line:
                continue
            key, _, vals = line.partition(':')
            vals = np.array(vals.split(), dtype=_F32)
            if vals.size == 12:
                mats[key.strip()] = vals.reshape(3, 4)
            elif vals.size == 9:
                mats[key.strip()] = vals.reshape(3, 3)
    return mats


def get_calib_from_file(calib_file):
    """Reference-schema dict view of a calib file (P2/P3/R0/Tr_velo2cam)."""
    mats = parse_calib_file(calib_file)
    return {
        'P2': mats['P2'],
        'P3': mats.get('P3', mats['P2']),
        'R0': mats['R0_rect'],
        'Tr_velo2cam': mats['Tr_velo_to_cam'],
    }


class Calibration:
    """Projection bundle for one KITTI frame.

    Construct from a calib file path or a dict with keys
    ``P2`` (3, 4), ``R0`` (3, 3), ``Tr_velo2cam`` (3, 4).
    """

    def __init__(self, src):
        raw = src if isinstance(src, dict) else get_calib_from_file(src)
        self.P2 = np.asarray(raw['P2'], dtype=_F32)
        self.R0 = np.asarray(raw['R0'], dtype=_F32)
        self.V2C = np.asarray(raw['Tr_velo2cam'], dtype=_F32)

        # One 4x4 each way: rect = R0_ext @ V2C_ext @ lidar.
        self._lidar_to_rect = _to_4x4(self.R0) @ _to_4x4(self.V2C)
        self._rect_to_lidar = np.linalg.inv(self._lidar_to_rect).astype(_F32)

    # -- intrinsics (derived views of P2) ---------------------------------
    @property
    def fu(self):
        return self.P2[0, 0]

    @property
    def fv(self):
        return self.P2[1, 1]

    @property
    def cu(self):
        return self.P2[0, 2]

    @property
    def cv(self):
        return self.P2[1, 2]

    # -- frame transforms --------------------------------------------------
    def lidar_to_rect(self, pts_lidar):
        """(..., 3) lidar -> (..., 3) rectified-camera points."""
        return _apply(self._lidar_to_rect, np.asarray(pts_lidar, dtype=_F32))

    def rect_to_lidar(self, pts_rect):
        """(..., 3) rectified-camera -> (..., 3) lidar points."""
        return _apply(self._rect_to_lidar, np.asarray(pts_rect, dtype=_F32))

    def rect_to_img(self, pts_rect):
        """(..., 3) rect points -> ((..., 2) pixels, (...,) rect depth).

        KITTI-devkit-compatible projection: the perspective divide uses the
        rect-frame z of the point (the returned depth), not the projected w.
        """
        pts_rect = np.asarray(pts_rect, dtype=_F32)
        uvw = _apply(self.P2, pts_rect)
        depth = pts_rect[..., 2]
        uv = uvw[..., :2] / depth[..., None]
        return uv.astype(_F32), depth.astype(_F32)

    def lidar_to_img(self, pts_lidar):
        """(..., 3) lidar points -> ((..., 2) pixels, (...,) rect depth)."""
        return self.rect_to_img(self.lidar_to_rect(pts_lidar))

    def img_to_rect(self, u, v, depth_rect):
        """Pixel coords + rect depth -> (N, 3) rect points (pinhole inverse)."""
        u = np.asarray(u, dtype=_F32).reshape(-1)
        v = np.asarray(v, dtype=_F32).reshape(-1)
        d = np.asarray(depth_rect, dtype=_F32).reshape(-1)
        x = (u - self.cu) * d / self.fu - self.P2[0, 3] / self.fu
        y = (v - self.cv) * d / self.fv - self.P2[1, 3] / self.fv
        return np.stack([x, y, d], axis=1)

    def corners3d_to_img_boxes(self, corners3d):
        """(N, 8, 3) rect-frame corners -> (N, 4) xyxy image boxes, (N, 8, 2) pixels."""
        uv, _ = self.rect_to_img(np.asarray(corners3d, dtype=_F32))
        lo = uv.min(axis=1)
        hi = uv.max(axis=1)
        return np.concatenate([lo, hi], axis=1), uv

    # -- misc ---------------------------------------------------------------
    @staticmethod
    def cart_to_hom(pts):
        """(N, D) -> (N, D + 1) homogeneous."""
        pts = np.asarray(pts, dtype=_F32)
        return np.concatenate(
            [pts, np.ones((*pts.shape[:-1], 1), dtype=_F32)], axis=-1)
