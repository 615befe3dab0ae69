"""Gt-database paste augmentation over a column store of samples.

The port's copy of ``hvpr_tpu/datasets/augmentor/database_sampler.py``: each
class's database is held as parallel numpy columns (boxes, point counts,
difficulty, crop paths), so the PREPARE filters and the BEV-collision
rejection are vectorized mask operations. Sampling is an epoch-shuffled
cursor into a permutation, drawn from numpy's global RNG. A candidate is
kept only if its BEV IoU with every scene box and every other kept
candidate is zero. The pasted crops are dropped onto the road plane when
``USE_ROAD_PLANE`` is set and the scene has one, and the scene's points
inside the pasted boxes are carved out.
"""

import pickle
from pathlib import Path

import numpy as np

from ...ops.rotated_iou import boxes_bev_iou_cpu
from ...utils import box_utils


class _ClassDb:
    """One class's gt database as parallel columns and a sampling cursor."""

    def __init__(self, infos):
        self.infos = list(infos)
        n = len(self.infos)
        # explicit width when empty: np.array([]).reshape(0, -1) raises, and
        # a class can be empty (a database built without it, or PREPARE
        # filters that removed every entry)
        self.boxes = (np.zeros((0, 7), dtype=np.float32) if n == 0 else
                      np.array([i['box3d_lidar'] for i in self.infos],
                               dtype=np.float32).reshape(n, -1))
        self.num_points = np.array(
            [i['num_points_in_gt'] for i in self.infos], dtype=np.int64)
        self.difficulty = np.array(
            [i['difficulty'] for i in self.infos], dtype=np.int64)
        self._order = np.arange(n)
        self._cursor = n  # forces a shuffle on the first draw

    def __len__(self):
        return len(self.infos)

    def keep(self, mask):
        """The entries where ``mask`` is set, with a fresh cursor."""
        idx = np.flatnonzero(mask)
        return _ClassDb([self.infos[i] for i in idx])

    def draw(self, count):
        """The next ``count`` row indices, reshuffled at each epoch's end."""
        if self._cursor >= len(self.infos):
            self._order = np.random.permutation(len(self.infos))
            self._cursor = 0
        picked = self._order[self._cursor:self._cursor + count]
        self._cursor += count
        return picked


class DataBaseSampler:
    def __init__(self, root_path, sampler_cfg, class_names, logger=None):
        self.root_path = Path(root_path)
        self.sampler_cfg = sampler_cfg
        self.class_names = class_names
        self.logger = logger

        raw = {name: [] for name in class_names}
        for rel in sampler_cfg['DB_INFO_PATH']:
            with open(str(self.root_path.resolve() / rel), 'rb') as f:
                per_class = pickle.load(f)
            for name in class_names:
                raw[name].extend(per_class.get(name, []))
        self.db = {name: _ClassDb(infos) for name, infos in raw.items()}

        for filter_name, arg in sampler_cfg.get('PREPARE', {}).items():
            getattr(self, filter_name)(arg)

        self.limit_whole_scene = sampler_cfg.get('LIMIT_WHOLE_SCENE', False)
        self.quota = {}
        for spec in sampler_cfg['SAMPLE_GROUPS']:
            name, count = spec.split(':')
            if name in class_names:
                self.quota[name] = int(count)

    def __getstate__(self):
        d = dict(self.__dict__)
        d.pop('logger', None)
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self.logger = None

    # -- PREPARE filters (their names are config keys) ----------------------
    def filter_by_difficulty(self, removed_difficulty):
        removed = np.asarray(removed_difficulty)
        for name, db in self.db.items():
            kept = db.keep(~np.isin(db.difficulty, removed))
            self._log_filter('difficulty', name, len(db), len(kept))
            self.db[name] = kept

    def filter_by_min_points(self, min_points_specs):
        for spec in min_points_specs:
            name, min_num = spec.split(':')
            if int(min_num) <= 0 or name not in self.db:
                continue
            db = self.db[name]
            kept = db.keep(db.num_points >= int(min_num))
            self._log_filter('min points', name, len(db), len(kept))
            self.db[name] = kept

    def _log_filter(self, what, name, before, after):
        if self.logger is not None:
            self.logger.info('Database filter by %s %s: %d => %d',
                             what, name, before, after)

    # -- scene assembly -------------------------------------------------------
    def __call__(self, data_dict):
        scene_boxes = data_dict['gt_boxes']
        scene_names = data_dict['gt_names'].astype(str)

        blockers = scene_boxes[:, :7].astype(np.float32)
        chosen_infos, chosen_boxes = [], []
        for name, quota in self.quota.items():
            want = quota - int((scene_names == name).sum()) \
                if self.limit_whole_scene else quota
            if want <= 0:
                continue
            db = self.db[name]
            idx = db.draw(want)
            cand = db.boxes[idx, :7]
            if self.sampler_cfg.get('DATABASE_WITH_FAKELIDAR', False):
                cand = box_utils.boxes3d_kitti_fakelidar_to_lidar(cand)

            ok = self._collision_free(cand, blockers)
            chosen_infos.extend(db.infos[i] for i in idx[ok])
            chosen_boxes.append(cand[ok])
            blockers = np.concatenate([blockers, cand[ok]], axis=0)

        if chosen_infos:
            pasted = np.concatenate(chosen_boxes, axis=0)
            data_dict = self._paste(data_dict, pasted, chosen_infos)
        data_dict.pop('gt_boxes_mask')
        return data_dict

    @staticmethod
    def _collision_free(cand, blockers):
        """Mask of the candidates with zero BEV IoU against the blockers and
        against each other. No candidates (a class whose database is empty)
        give an empty mask; the JAX package's copy raises there, in the
        maximum over an empty axis."""
        if len(cand) == 0:
            return np.zeros(0, dtype=bool)
        vs_scene = boxes_bev_iou_cpu(cand, blockers)
        vs_self = boxes_bev_iou_cpu(cand, cand)
        np.fill_diagonal(vs_self, 0.0)
        worst = vs_self.max(axis=1)
        if vs_scene.shape[1] > 0:
            worst = worst + vs_scene.max(axis=1)
        return worst == 0

    def _snap_to_road_plane(self, boxes, plane, calib):
        """Drop each pasted box so that its bottom sits on the annotated
        plane. Returns the snapped boxes and the height shift of each box,
        to apply to its crop's points."""
        a, b, c, d = plane
        centers_cam = calib.lidar_to_rect(boxes[:, :3])
        centers_cam[:, 1] = (-d - a * centers_cam[:, 0]
                             - c * centers_cam[:, 2]) / b
        road_z = calib.rect_to_lidar(centers_cam)[:, 2]
        shift = boxes[:, 2] - boxes[:, 5] / 2 - road_z
        boxes = boxes.copy()
        boxes[:, 2] -= shift
        return boxes, shift

    def _paste(self, data_dict, pasted_boxes, chosen_infos):
        mask = data_dict['gt_boxes_mask']
        gt_boxes = data_dict['gt_boxes'][mask]
        gt_names = data_dict['gt_names'][mask]

        if self.sampler_cfg.get('USE_ROAD_PLANE', False) \
                and 'road_plane' in data_dict:
            pasted_boxes, z_shift = self._snap_to_road_plane(
                pasted_boxes, data_dict['road_plane'], data_dict['calib'])
            data_dict.pop('calib', None)
            data_dict.pop('road_plane', None)
        else:
            z_shift = np.zeros(pasted_boxes.shape[0], dtype=np.float32)

        n_feat = self.sampler_cfg['NUM_POINT_FEATURES']
        crops = [
            np.fromfile(str(self.root_path / info['path']),
                        dtype=np.float32).reshape(-1, n_feat)
            for info in chosen_infos
        ]
        sizes = np.array([c.shape[0] for c in crops])
        obj_points = np.concatenate(crops, axis=0) if crops else \
            np.zeros((0, n_feat), dtype=np.float32)
        # crops are stored centred on their database box: offset them back
        # to the database pose, then apply the road-plane drop (all crops at
        # once)
        db_centers = np.array(
            [i['box3d_lidar'][:3] for i in chosen_infos], dtype=np.float32
        ).reshape(-1, 3)
        offsets = np.repeat(db_centers, sizes, axis=0)
        offsets[:, 2] -= np.repeat(z_shift, sizes)
        obj_points[:, :3] += offsets.astype(np.float32)

        carve = box_utils.enlarge_box3d(
            pasted_boxes[:, :7],
            extra_width=self.sampler_cfg.get('REMOVE_EXTRA_WIDTH', [0, 0, 0]))
        scene_points = box_utils.remove_points_in_boxes3d(
            data_dict['points'], carve)

        data_dict['points'] = np.concatenate(
            [obj_points, scene_points], axis=0)
        data_dict['gt_names'] = np.concatenate(
            [gt_names, np.array([i['name'] for i in chosen_infos])])
        data_dict['gt_boxes'] = np.concatenate(
            [gt_boxes, pasted_boxes[:, :gt_boxes.shape[1]]], axis=0)
        return data_dict
