"""KITTI raw-file IO and info building (host side).

The port's copy of ``hvpr_tpu/datasets/kitti/kitti_io.py``:
``KittiSplitIO`` owns the on-disk layout of a split, label files arrive as
vectorized ``LabelTable`` columns, and one rotated-box test per scene counts
the points inside each gt box. ``create_gt_database`` crops each gt box's
points into ``gt_database/`` for the train mode's gt sampling. The
``kitti_infos_*.pkl`` and ``kitti_dbinfos_*.pkl`` entries and the crop
files keep the reference schema, so either package reads the other's.
Image sizes come from the PNG header (no image library).
"""

import concurrent.futures
import pickle
import struct

import numpy as np

from ...ops.points_in_boxes import points_in_boxes_cpu
from ...utils import object3d_kitti
from ...utils.calibration_kitti import Calibration, _to_4x4


class KittiSplitIO:
    """Path layout + raw readers for one KITTI split directory."""

    def __init__(self, root, split):
        self.root = root
        self.split = split
        self.base = root / ('testing' if split == 'test' else 'training')

    @property
    def frame_ids(self):
        ids_file = self.root / 'ImageSets' / f'{self.split}.txt'
        if not ids_file.exists():
            return None
        return ids_file.read_text().split()

    def lidar(self, fid):
        return np.fromfile(
            str(self.base / 'velodyne' / f'{fid}.bin'),
            dtype=np.float32).reshape(-1, 4)

    def calib(self, fid):
        return Calibration(str(self.base / 'calib' / f'{fid}.txt'))

    def label(self, fid):
        return object3d_kitti.read_label(str(self.base / 'label_2' / f'{fid}.txt'))

    def image_shape(self, fid):
        """(2,) int32 [height, width] of the frame's camera-2 image."""
        return png_shape(self.base / 'image_2' / f'{fid}.png')

    def road_plane(self, fid):
        """(4,) normalized plane [a, b, c, d] with b < 0, or None if absent."""
        plane_file = self.base / 'planes' / f'{fid}.txt'
        if not plane_file.exists():
            return None
        coeffs = np.array(
            plane_file.read_text().splitlines()[3].split(), dtype=np.float64)
        if coeffs[1] > 0:
            coeffs = -coeffs
        return coeffs / np.linalg.norm(coeffs[:3])


def png_shape(path):
    """(2,) int32 [height, width] of a PNG, read from its IHDR chunk: the
    8-byte signature, then the chunk's length and type, then big-endian
    width and height."""
    with open(path, 'rb') as f:
        head = f.read(24)
    if len(head) < 24 or head[:8] != b'\x89PNG\r\n\x1a\n' or head[12:16] != b'IHDR':
        raise ValueError(f'{path}: not a PNG file')
    width, height = struct.unpack('>II', head[16:24])
    return np.array([height, width], dtype=np.int32)


def fov_point_mask(pts_lidar_xyz, calib, image_shape):
    """Mask of lidar points that project inside the camera-2 image."""
    pts_rect = calib.lidar_to_rect(pts_lidar_xyz)
    uv, depth = calib.rect_to_img(pts_rect)
    h, w = int(image_shape[0]), int(image_shape[1])
    return ((uv[:, 0] >= 0) & (uv[:, 0] < w)
            & (uv[:, 1] >= 0) & (uv[:, 1] < h) & (depth >= 0))


def camera_boxes_to_lidar(loc, dims_lhw, ry, calib):
    """Rect-frame KITTI boxes -> (N, 7) lidar boxes [x y z l w h heading].

    KITTI camera boxes anchor at the bottom face (y-down); lidar boxes are
    center-anchored, heading about +z with the devkit's -(pi/2 + ry) offset.
    """
    centers = calib.rect_to_lidar(loc)
    l, h, w = dims_lhw[:, 0:1], dims_lhw[:, 1:2], dims_lhw[:, 2:3]
    centers[:, 2] += h[:, 0] / 2
    heading = -(np.pi / 2 + ry[:, None])
    return np.concatenate([centers, l, w, h, heading], axis=1)


def _anno_dict(table):
    """LabelTable -> the reference's annotation-column dict (array views)."""
    return {
        'name': table.name,
        'truncated': table.truncated,
        'occluded': table.occluded,
        'alpha': table.alpha,
        'bbox': table.bbox.reshape(-1, 4),
        'dimensions': table.dims_lhw.reshape(-1, 3),
        'location': table.loc.reshape(-1, 3),
        'rotation_y': table.ry,
        'score': table.score,
        'difficulty': table.difficulty,
    }


def build_frame_info(io, fid, has_label=True, count_inside_pts=True):
    """One ``kitti_infos`` entry (reference pickle schema) for frame fid."""
    calib = io.calib(fid)
    info = {
        'point_cloud': {'num_features': 4, 'lidar_idx': fid},
        'image': {'image_idx': fid, 'image_shape': io.image_shape(fid)},
        'calib': {
            'P2': _to_4x4(calib.P2),
            'R0_rect': _to_4x4(calib.R0),
            'Tr_velo_to_cam': _to_4x4(calib.V2C),
        },
    }
    if not has_label:
        return info

    table = io.label(fid)
    annos = _anno_dict(table)
    # KITTI label files list DontCare entries last; 'index' numbers the
    # real objects and marks DontCare rows with -1.
    n_total = len(table)
    n_obj = int((table.name != 'DontCare').sum())
    annos['index'] = np.where(
        np.arange(n_total) < n_obj, np.arange(n_total), -1).astype(np.int32)

    gt_boxes_lidar = camera_boxes_to_lidar(
        table.loc[:n_obj], table.dims_lhw[:n_obj], table.ry[:n_obj], calib)
    annos['gt_boxes_lidar'] = gt_boxes_lidar

    if count_inside_pts:
        points = io.lidar(fid)
        fov = fov_point_mask(points[:, :3], calib, info['image']['image_shape'])
        inside = points_in_boxes_cpu(points[fov, :3], gt_boxes_lidar)
        counts = np.full(n_total, -1, dtype=np.int32)
        counts[:n_obj] = inside.sum(axis=1)
        annos['num_points_in_gt'] = counts

    info['annos'] = annos
    return info


def build_split_infos(io, workers=4, has_label=True, count_inside_pts=True,
                      frame_ids=None):
    """All infos for a split, IO-parallel over frames."""
    frame_ids = frame_ids if frame_ids is not None else io.frame_ids
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        return list(pool.map(
            lambda fid: build_frame_info(io, fid, has_label, count_inside_pts),
            frame_ids))


def create_gt_database(io, info_path, save_root, used_classes=None,
                       split='train'):
    """Crop each gt box's points into ``gt_database/`` (centred on the box)
    and write ``kitti_dbinfos_{split}.pkl``; returns that pickle's path.

    The crop files and the pickle's entries have the reference's schema,
    so gt sampling reads a database written by either package.
    """
    db_dir = save_root / ('gt_database' if split == 'train'
                          else f'gt_database_{split}')
    db_dir.mkdir(parents=True, exist_ok=True)

    with open(info_path, 'rb') as f:
        infos = pickle.load(f)

    db_infos = {}
    for k, info in enumerate(infos):
        print(f'gt_database sample: {k + 1}/{len(infos)}')
        fid = info['point_cloud']['lidar_idx']
        annos = info['annos']
        boxes = annos['gt_boxes_lidar']
        points = io.lidar(fid)
        membership = points_in_boxes_cpu(points[:, :3], boxes)

        for i in range(boxes.shape[0]):
            name = annos['name'][i]
            crop = points[membership[i] > 0].copy()
            crop[:, :3] -= boxes[i, :3]
            crop_file = db_dir / f'{fid}_{name}_{i}.bin'
            crop.tofile(str(crop_file))
            if used_classes is not None and name not in used_classes:
                continue
            db_infos.setdefault(name, []).append({
                'name': name,
                'path': str(crop_file.relative_to(save_root)),
                'image_idx': fid,
                'gt_idx': i,
                'box3d_lidar': boxes[i],
                'num_points_in_gt': crop.shape[0],
                'difficulty': annos['difficulty'][i],
                'bbox': annos['bbox'][i],
                'score': annos['score'][i],
            })

    for name, entries in db_infos.items():
        print(f'Database {name}: {len(entries)}')
    db_info_path = save_root / f'kitti_dbinfos_{split}.pkl'
    with open(db_info_path, 'wb') as f:
        pickle.dump(db_infos, f)
    return db_info_path
