"""Seeded KITTI-like lidar scans, and the one generator every traffic mix reads.

``make_scene``, ``realistic_scans`` and ``realistic_scans_with_boxes`` are a
frozen copy of ``hvpr_tpu_torch/utils/scans.py`` at commit
1380d4cbc8b81ffdba01a8b3179518351fd96dae: the draws come from the same
generator in the same order, so a seed gives the arrays of that commit.
:func:`pool` reads a traffic file's parameters and makes a run's inputs.
"""

import numpy as np


def make_scene(rng, n_cars=49):
    """Non-overlapping lidar-frame car boxes (N, 7) on a jittered 7x7 grid."""
    xs, ys = np.meshgrid(np.linspace(8, 40, 7), np.linspace(-13.5, 13.5, 7))
    boxes = np.zeros((n_cars, 7), dtype=np.float32)
    boxes[:, 0] = xs.ravel()[:n_cars] + rng.uniform(-0.5, 0.5, n_cars)
    boxes[:, 1] = ys.ravel()[:n_cars] + rng.uniform(-0.5, 0.5, n_cars)
    boxes[:, 2] = rng.uniform(-1.2, -0.6, n_cars)
    boxes[:, 3] = rng.uniform(3.6, 4.3, n_cars)
    boxes[:, 4] = rng.uniform(1.5, 1.8, n_cars)
    boxes[:, 5] = rng.uniform(1.4, 1.7, n_cars)
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, n_cars)
    return boxes


def realistic_scans(rng, batch, n, pcr):
    """(batch, n, 4) KITTI-like scans: 49 cars of 200 points each plus
    ground points whose density falls off as 1/r over a +-24 degree cone,
    so near pillars fill their 32-point cap and far ones hold 1-2 points."""
    return realistic_scans_with_boxes(rng, batch, n, pcr)[0]


def realistic_scans_with_boxes(rng, batch, n, pcr):
    """:func:`realistic_scans` and each scan's car boxes as ``gt_boxes``
    (batch, 49, 8) float32: x, y, z, dx, dy, dz, heading, class 1."""
    pts = np.zeros((batch, n, 4), dtype=np.float32)
    gt = np.zeros((batch, 49, 8), dtype=np.float32)
    n_obj_pts = 200
    for b in range(batch):
        boxes = make_scene(rng)
        gt[b, :, :7] = boxes
        gt[b, :, 7] = 1.0
        clusters = []
        for box in boxes:
            local = rng.uniform(-0.4, 0.4, (n_obj_pts, 3)) * box[3:6]
            c, s = np.cos(box[6]), np.sin(box[6])
            clusters.append(np.stack([
                local[:, 0] * c - local[:, 1] * s + box[0],
                local[:, 0] * s + local[:, 1] * c + box[1],
                local[:, 2] + box[2],
            ], axis=1))
        obj = np.concatenate(clusters, axis=0)

        n_bg = n - len(obj)
        r_min, r_max = 2.0, float(pcr[3]) - 0.5
        u = rng.uniform(0, 1, n_bg)
        r = r_min * (r_max / r_min) ** u
        az = rng.uniform(-0.42, 0.42, n_bg)
        bg = np.stack([r * np.cos(az), r * np.sin(az),
                       rng.normal(-1.6, 0.15, n_bg)], axis=1)
        xyz = np.concatenate([obj, bg], axis=0)[:n]
        xyz[:, 0] = np.clip(xyz[:, 0], pcr[0] + 0.1, pcr[3] - 0.1)
        xyz[:, 1] = np.clip(xyz[:, 1], pcr[1] + 0.1, pcr[4] - 0.1)
        xyz[:, 2] = np.clip(xyz[:, 2], pcr[2] + 0.1, pcr[5] - 0.1)
        pts[b, :, :3] = xyz
        pts[b, :, 3] = rng.uniform(0, 1, n)
    return pts, gt


GENERATORS = {'realistic_scans': realistic_scans_with_boxes}


def pool(traffic, seed, pcr):
    """A run's distinct inputs: ``traffic['pool_batches']`` batches of
    ``traffic['batch']`` scans of ``traffic['points_per_scan']`` points
    from the generator ``traffic['generator']``, drawn from ``seed``.
    Returns (points (pool, batch, n, 4), gt_boxes (pool, batch, 49, 8))."""
    gen = GENERATORS[traffic['generator']]
    p, b, n = (int(traffic[k]) for k in ('pool_batches', 'batch', 'points_per_scan'))
    pts, gt = gen(np.random.default_rng(seed), p * b, n, pcr)
    return pts.reshape(p, b, n, -1), gt.reshape(p, b, *gt.shape[1:])
