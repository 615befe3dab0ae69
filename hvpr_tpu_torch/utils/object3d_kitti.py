"""KITTI label files as vectorized column tables.

The port's copy of ``hvpr_tpu/utils/object3d_kitti.py``: one pass parses
the whole file into a ``LabelTable`` of numpy columns, and difficulty /
corner generation are vectorized over all objects.

KITTI label line format (15 or 16 whitespace-separated fields):
    type truncated occluded alpha  x1 y1 x2 y2  h w l  x y z  ry  [score]
"""

import dataclasses

import numpy as np

# KITTI class ids used by the gt database / difficulty bookkeeping.
CLASS_IDS = {'Car': 1, 'Pedestrian': 2, 'Cyclist': 3, 'Van': 4}

# (min 2D box height px, max truncation, max occlusion) per difficulty level.
_DIFFICULTY_GATES = (
    (40.0, 0.15, 0),  # 0: easy
    (25.0, 0.30, 1),  # 1: moderate
    (25.0, 0.50, 2),  # 2: hard
)


@dataclasses.dataclass
class LabelTable:
    """Column-oriented view of one label file (all arrays share length N)."""

    name: np.ndarray        # (N,) unicode class names
    truncated: np.ndarray   # (N,) f32 in [0, 1]
    occluded: np.ndarray    # (N,) f32 {0, 1, 2, 3}
    alpha: np.ndarray       # (N,) f32 observation angle
    bbox: np.ndarray        # (N, 4) f32 image box x1 y1 x2 y2
    dims_lhw: np.ndarray    # (N, 3) f32 length, height, width
    loc: np.ndarray         # (N, 3) f32 bottom-center in rect camera frame
    ry: np.ndarray          # (N,) f32 rect-frame yaw
    score: np.ndarray       # (N,) f32 (-1 for gt labels)

    def __len__(self):
        return len(self.name)

    @property
    def difficulty(self):
        """(N,) int32 KITTI difficulty: 0 easy / 1 moderate / 2 hard / -1."""
        height = self.bbox[:, 3] - self.bbox[:, 1] + 1
        level = np.full(len(self), -1, dtype=np.int32)
        # Assign the hardest-first so easier gates overwrite.
        for lvl, (min_h, max_trunc, max_occ) in reversed(
                list(enumerate(_DIFFICULTY_GATES))):
            ok = ((height >= min_h) & (self.truncated <= max_trunc)
                  & (self.occluded <= max_occ))
            level[ok] = lvl
        return level

    @property
    def class_id(self):
        """(N,) int32 ids per CLASS_IDS, -1 for other classes."""
        return np.array([CLASS_IDS.get(n, -1) for n in self.name],
                        dtype=np.int32)

    def corners_camera(self):
        """(N, 8, 3) rect-frame box corners, y-down with bottom at loc.

        Corner order matches the devkit: x alternating +-l/2 around the
        heading, y in {0, -h}, z alternating +-w/2.
        """
        l, h, w = (self.dims_lhw[:, i] for i in range(3))
        ux = np.array([1, 1, -1, -1, 1, 1, -1, -1], dtype=np.float32)
        uy = np.array([0, 0, 0, 0, -1, -1, -1, -1], dtype=np.float32)
        uz = np.array([1, -1, -1, 1, 1, -1, -1, 1], dtype=np.float32)
        local = np.stack([
            ux * (l[:, None] / 2),
            uy * h[:, None],
            uz * (w[:, None] / 2),
        ], axis=-1)                                           # (N, 8, 3)
        c, s = np.cos(self.ry), np.sin(self.ry)
        zeros, ones = np.zeros_like(c), np.ones_like(c)
        # Rotation about the camera y (vertical) axis.
        rot = np.stack([
            np.stack([c, zeros, s], -1),
            np.stack([zeros, ones, zeros], -1),
            np.stack([-s, zeros, c], -1),
        ], axis=1)                                            # (N, 3, 3)
        return np.einsum('nij,nkj->nki', rot, local) + self.loc[:, None, :]


def read_label(path):
    """Parse a label file into a LabelTable (empty files give N=0)."""
    names, rows = [], []
    with open(path) as f:
        for line in f:
            fields = line.split()
            if not fields:
                continue
            names.append(fields[0])
            vals = [float(v) for v in fields[1:15]]
            vals.append(float(fields[15]) if len(fields) > 15 else -1.0)
            rows.append(vals)
    num = np.asarray(rows, dtype=np.float32).reshape(len(rows), 15)
    return LabelTable(
        name=np.asarray(names),
        truncated=num[:, 0],
        occluded=num[:, 1],
        alpha=num[:, 2],
        bbox=num[:, 3:7],
        # file order is h w l -> store as l h w
        dims_lhw=num[:, [9, 7, 8]],
        loc=num[:, 10:13],
        ry=num[:, 13],
        score=num[:, 14],
    )
