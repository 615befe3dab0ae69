"""Seeded synthetic lidar scans, KITTI trees and nuScenes trees (numpy only).

The port's copy of ``bench.py``'s ``synthetic_scans``/``realistic_scans`` and
of ``make_scene`` and ``build_kitti_root`` from ``tests/kitti_fixture.py``:
the draws come from the same generator in the same order, so a seed gives
the same scans as the JAX package's benchmark, and the same KITTI files as
its test fixture (the images are black PNGs written with zlib and struct,
no image library). :func:`build_nuscenes_root` writes a multi-sweep
nuScenes tree with its info pickles, at a 32-beam lidar's size or smaller.
"""

import struct
import zlib
from pathlib import Path

import numpy as np

from .box_utils import boxes3d_kitti_camera_to_imageboxes, boxes3d_lidar_to_kitti_camera
from .calibration_kitti import Calibration

IMG_W, IMG_H = 1242, 375


def make_scene(rng, n_cars=49):
    """Non-overlapping lidar-frame car boxes (N, 7) on a jittered 7x7 grid
    (``make_scene`` with ``easy=False``)."""
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


def synthetic_scans(rng, batch, n, pcr):
    """(batch, n, 4) points uniform over the point-cloud range."""
    pts = np.zeros((batch, n, 4), dtype=np.float32)
    pts[..., 0] = rng.uniform(pcr[0] + 0.1, pcr[3] - 0.1, (batch, n))
    pts[..., 1] = rng.uniform(pcr[1] + 0.1, pcr[4] - 0.1, (batch, n))
    pts[..., 2] = rng.uniform(pcr[2] + 0.1, pcr[5] - 0.1, (batch, n))
    pts[..., 3] = rng.uniform(0, 1, (batch, n))
    return pts


def realistic_scans(rng, batch, n, pcr):
    """(batch, n, 4) KITTI-like scans: 49 cars of 200 points each plus
    ground points whose density falls off as 1/r over a +-24 degree cone,
    so near pillars fill their 32-point cap and far ones hold 1-2 points."""
    return realistic_scans_with_boxes(rng, batch, n, pcr)[0]


def realistic_scans_with_boxes(rng, batch, n, pcr):
    """:func:`realistic_scans` (the same draws in the same order) and each
    scan's car boxes as ``gt_boxes`` (batch, 49, 8) float32: x, y, z, dx,
    dy, dz, heading, class 1."""
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


def make_calib_file(path):
    """A KITTI calib file: one camera 720 px focal length, the velodyne
    frame rotated into the camera frame (x_cam = -y, y_cam = -z, z_cam = x)."""
    P2 = np.array([[720.0, 0.0, 620.0, 44.9],
                   [0.0, 720.0, 187.0, 0.1],
                   [0.0, 0.0, 1.0, 0.003]])
    R0 = np.eye(3)
    V2C = np.array([[0.0, -1.0, 0.0, 0.0],
                    [0.0, 0.0, -1.0, 0.08],
                    [1.0, 0.0, 0.0, -0.27]])
    lines = []
    for name, mat in [('P0', P2), ('P1', P2), ('P2', P2), ('P3', P2)]:
        lines.append(f'{name}: ' + ' '.join(f'{v:.12e}' for v in mat.reshape(-1)))
    lines.append('R0_rect: ' + ' '.join(f'{v:.12e}' for v in R0.reshape(-1)))
    lines.append('Tr_velo_to_cam: ' + ' '.join(f'{v:.12e}' for v in V2C.reshape(-1)))
    lines.append('Tr_imu_to_velo: ' + ' '.join(f'{v:.12e}' for v in V2C.reshape(-1)))
    path.write_text('\n'.join(lines) + '\n')


def lidar_box_to_label_line(box, calib):
    """The KITTI label line of a lidar-frame Car box."""
    cam = boxes3d_lidar_to_kitti_camera(box[None], calib)[0]
    x, y, z, l, h, w, ry = cam
    img_boxes = boxes3d_kitti_camera_to_imageboxes(
        cam[None], calib, image_shape=(IMG_H, IMG_W))[0]
    alpha = -np.arctan2(-box[1], box[0]) + ry
    return ('Car 0.00 0 %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f'
            % (alpha, img_boxes[0], img_boxes[1], img_boxes[2], img_boxes[3],
               h, w, l, x, y, z, ry))


def write_black_png(path, width, height):
    """An 8-bit RGB PNG of zeros: signature, IHDR, one IDAT, IEND."""
    def chunk(kind, data):
        return (struct.pack('>I', len(data)) + kind + data
                + struct.pack('>I', zlib.crc32(kind + data) & 0xffffffff))
    raw = bytes(height * (1 + 3 * width))   # filter byte 0, then the row
    path.write_bytes(b'\x89PNG\r\n\x1a\n'
                     + chunk(b'IHDR', struct.pack('>IIBBBBB', width, height, 8, 2, 0, 0, 0))
                     + chunk(b'IDAT', zlib.compress(raw))
                     + chunk(b'IEND', b''))


def build_kitti_root(root, n_scenes=4, n_train=None):
    """Write a synthetic KITTI tree under ``root``: per scene a velodyne
    scan (4000 ground points and 200 points in each of 49 cars), calib,
    Car labels, road plane and image; ImageSets with the first ``n_train``
    scenes (half by default) in train, the rest in val, an empty test.
    Returns (root, {frame id: (49, 7) lidar boxes})."""
    root = Path(root)
    training = root / 'training'
    for sub in ['velodyne', 'calib', 'label_2', 'image_2', 'planes']:
        (training / sub).mkdir(parents=True, exist_ok=True)
    (root / 'ImageSets').mkdir(exist_ok=True)

    rng = np.random.default_rng(7)
    ids = [f'{i:06d}' for i in range(n_scenes)]
    scenes = {}
    for sid in ids:
        make_calib_file(training / 'calib' / f'{sid}.txt')
        calib = Calibration(str(training / 'calib' / f'{sid}.txt'))

        boxes = make_scene(rng)
        n_bg = 4000
        pts = np.zeros((n_bg, 4), dtype=np.float32)
        pts[:, 0] = rng.uniform(2, 45, n_bg)
        pts[:, 1] = rng.uniform(-18, 18, n_bg)
        pts[:, 2] = rng.uniform(-1.6, 0.2, n_bg)
        pts[:, 3] = rng.uniform(0, 1, n_bg)
        clusters = []
        for b in boxes:
            n_obj = 200
            local = rng.uniform(-0.4, 0.4, (n_obj, 3)) * b[3:6]
            c, s = np.cos(b[6]), np.sin(b[6])
            world = np.stack([
                local[:, 0] * c - local[:, 1] * s + b[0],
                local[:, 0] * s + local[:, 1] * c + b[1],
                local[:, 2] + b[2],
            ], axis=1)
            clusters.append(np.concatenate(
                [world, rng.uniform(0, 1, (n_obj, 1))], axis=1).astype(np.float32))
        pts = np.concatenate([pts] + clusters, axis=0)
        pts.tofile(training / 'velodyne' / f'{sid}.bin')

        lines = [lidar_box_to_label_line(b, calib) for b in boxes]
        (training / 'label_2' / f'{sid}.txt').write_text('\n'.join(lines) + '\n')
        (training / 'planes' / f'{sid}.txt').write_text(
            '# Plane\nWidth 4\nHeight 1\n0.0 -1.0 0.0 1.68\n')
        write_black_png(training / 'image_2' / f'{sid}.png', IMG_W, IMG_H)
        scenes[sid] = boxes

    half = max(1, n_scenes // 2) if n_train is None else n_train
    (root / 'ImageSets' / 'train.txt').write_text('\n'.join(ids[:half]) + '\n')
    (root / 'ImageSets' / 'val.txt').write_text('\n'.join(ids[half:]) + '\n')
    (root / 'ImageSets' / 'test.txt').write_text('')
    return root, scenes


# nuScenes classes of a synthetic frame: (name, count, (l, w, h), points a
# sweep, z of the box centre); sizes are the classes' means in nuScenes
NUSC_OBJECTS = (('car', 20, (4.63, 1.97, 1.74), 160, -0.9),
                ('truck', 4, (6.93, 2.51, 2.84), 320, -0.4),
                ('bus', 2, (10.5, 2.94, 3.47), 420, -0.1),
                ('pedestrian', 14, (0.73, 0.67, 1.77), 40, -0.9),
                ('traffic_cone', 10, (0.41, 0.41, 1.07), 16, -1.3))


def _lidar_rings(rng, n, sensor_z=1.84, beams=32):
    """(n, 3) returns of a ``beams``-beam spinning lidar ``sensor_z`` m above
    flat ground, in the sensor frame: the downward beams hit the ground out
    to ~50 m, the upward ones walls 10-50 m away."""
    elev = np.deg2rad(np.linspace(-30.67, 10.67, beams))[rng.integers(0, beams, n)]
    az = rng.uniform(-np.pi, np.pi, n)
    ground = np.where(elev < -0.01, sensor_z / np.tan(np.maximum(-elev, 1e-3)), np.inf)
    rng_m = np.minimum(np.where(np.isfinite(ground), ground, rng.uniform(10, 50, n)), 50.0)
    rng_m = rng_m * rng.uniform(0.99, 1.01, n)
    return np.stack([rng_m * np.cos(elev) * np.cos(az), rng_m * np.cos(elev) * np.sin(az),
                     rng_m * np.sin(elev)], axis=1)


def _nusc_scene(rng):
    """A frame's objects: (N, 7) reference-lidar boxes on a jittered grid of
    free cells (none over the ego vehicle), their names and points a sweep."""
    cells = np.stack(np.meshgrid(np.arange(-45.0, 46.0, 10.0),
                                 np.arange(-45.0, 46.0, 10.0)), -1).reshape(-1, 2)
    cells = cells[np.abs(cells).max(axis=1) > 6]
    cells = cells[rng.permutation(len(cells))]
    boxes, names, npts = [], [], []
    for name, count, size, n, z in NUSC_OBJECTS:
        for _ in range(count):
            x, y = cells[len(boxes)] + rng.uniform(-2.0, 2.0, 2)
            boxes.append([x, y, z, *size, rng.uniform(-np.pi, np.pi)])
            names.append(name)
            npts.append(n)
    return np.asarray(boxes, np.float32), np.asarray(names), np.asarray(npts)


def _points_in_boxes(rng, boxes, npts, shift):
    """``npts`` points a box, uniform over 0.8 of its extent, moved by
    ``-shift`` (the sweep sensor's offset from the reference)."""
    out = []
    for box, n in zip(boxes, npts):
        local = rng.uniform(-0.4, 0.4, (n, 3)) * box[3:6]
        c, s = np.cos(box[6]), np.sin(box[6])
        out.append(np.stack([local[:, 0] * c - local[:, 1] * s + box[0],
                             local[:, 0] * s + local[:, 1] * c + box[1],
                             local[:, 2] + box[2]], axis=1) - shift)
    return np.concatenate(out, axis=0)


def build_nuscenes_root(data_path, n_train=4, n_val=4, n_points=34000):
    """Write a synthetic nuScenes tree under ``data_path``/v1.0-trainval (the
    version and sweep count of ``nuscenes_dataset.yaml``): per sample a
    reference sweep of ``n_points`` points (a 32-beam spinning lidar's
    returns, about 34,000 a sweep) and 9 past sweeps 0.05 s apart, as raw
    ``(N, 5)`` float32 ``.bin`` files [x y z intensity ring] under
    ``samples/LIDAR_TOP`` and ``sweeps/LIDAR_TOP``.
    The ego vehicle drives at 8 m/s along its x axis; each past sweep is
    written in its own sensor frame, with its 4x4 sweep -> reference
    transform in the info, so the static objects line up again once the
    sweeps are compensated. Objects: cars, trucks, buses, pedestrians and
    traffic cones (:data:`NUSC_OBJECTS`) as lidar-frame boxes with points
    in every sweep. The info pickles ``nuscenes_infos_10sweeps_
    {train,val}.pkl`` follow the schema of the data layer (``token``,
    ``lidar_path``, ``timestamp``, ``ref_to_global``, ``sweeps``,
    ``gt_boxes`` (N, 9) with zero velocities, ``gt_names``,
    ``num_lidar_pts``). Returns ``data_path`` (the config's DATA_PATH)."""
    import pickle
    data_path = Path(data_path)
    root = data_path / 'v1.0-trainval'
    (root / 'samples' / 'LIDAR_TOP').mkdir(parents=True, exist_ok=True)
    (root / 'sweeps' / 'LIDAR_TOP').mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(11)
    infos = []
    for s in range(n_train + n_val):
        boxes, names, npts = _nusc_scene(rng)
        scale = n_points / 34000.0              # fewer object points in a small tree
        npts = np.maximum(1, np.round(npts * min(1.0, scale))).astype(int)
        sweeps = []
        for k in range(10):
            shift = np.array([-0.4 * k, 0.0, 0.0])          # sweep sensor in the ref frame
            obj = _points_in_boxes(rng, boxes, npts, shift)
            xyz = np.concatenate([_lidar_rings(rng, n_points - len(obj)), obj])
            pts = np.zeros((len(xyz), 5), np.float32)
            pts[:, :3] = xyz
            pts[:, 3] = rng.uniform(0, 255, len(xyz))
            pts[:, 4] = rng.integers(0, 32, len(xyz))
            name = f'sample{s:04d}_{k}.bin'
            sub = 'samples' if k == 0 else 'sweeps'
            pts.tofile(root / sub / 'LIDAR_TOP' / name)
            if k:
                tm = np.eye(4, dtype=np.float32)
                tm[:3, 3] = shift
                sweeps.append({'lidar_path': f'sweeps/LIDAR_TOP/{name}',
                               'transform_matrix': tm, 'time_lag': 0.05 * k})
        yaw = 0.3 * s
        ref_to_global = np.eye(4, dtype=np.float32)
        ref_to_global[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
        ref_to_global[:3, 3] = [400.0 + 10 * s, 1200.0 - 5 * s, 0.0]
        infos.append({
            'lidar_path': f'samples/LIDAR_TOP/sample{s:04d}_0.bin',
            'token': f'{s:032x}',
            'timestamp': 1.5e9 + 0.5 * s,
            'ref_to_global': ref_to_global,
            'sweeps': sweeps,
            'gt_boxes': np.concatenate([boxes, np.zeros((len(boxes), 2), np.float32)], 1),
            'gt_names': names,
            'num_lidar_pts': npts,
        })
    for split, part in (('train', infos[:n_train]), ('val', infos[n_train:])):
        with open(root / f'nuscenes_infos_10sweeps_{split}.pkl', 'wb') as f:
            pickle.dump(part, f)
    return data_path
