"""Dataset template: the per-scan pipeline and fixed-shape batch collation.

The port's copy of ``hvpr_tpu/datasets/dataset.py`` (``DatasetTemplate``):
augmentation (train mode: gt sampling, world flip, rotation and scaling,
with a scene left without gt boxes replaced by a random other one) ->
class filter -> class-id column -> point features -> processor queue per
scan, and a collation that pads every sample to fixed sizes: points
(B, N, C) with ``point_valid_mask``, host-voxelized pillars (B, V, P, C)
with ``voxel_num_points``, ``voxel_coords`` and ``voxel_mask``, gt boxes to
``MAX_GT_BOXES``. ``merge_all_iters_to_one_epoch`` makes one epoch of
``total_epochs`` passes over the scenes.
"""

from collections import defaultdict
from pathlib import Path

import numpy as np

from ..utils import common_utils
from .augmentor.data_augmentor import DataAugmentor
from .processor.data_processor import DataProcessor
from .processor.point_feature_encoder import PointFeatureEncoder


class DatasetTemplate:
    # seed of a scene's host draws (``sample_points``' choice and shuffle):
    # None draws from numpy's RNG as it stands; an int seeds it with
    # item_seed + index before each scene, so that a scene's points do not
    # depend on which worker, process or position reads it
    item_seed = None

    def __init__(self, dataset_cfg=None, class_names=None, training=True,
                 root_path=None, logger=None):
        self.dataset_cfg = dataset_cfg
        self.training = training
        self.class_names = class_names
        self.logger = logger
        self.root_path = Path(root_path if root_path is not None
                              else dataset_cfg['DATA_PATH'])
        if self.dataset_cfg is None or class_names is None:
            return

        self.point_cloud_range = np.array(
            self.dataset_cfg['POINT_CLOUD_RANGE'], dtype=np.float32)
        self.point_feature_encoder = PointFeatureEncoder(
            self.dataset_cfg['POINT_FEATURE_ENCODING'],
            point_cloud_range=self.point_cloud_range)
        # a config without DATA_AUGMENTOR trains on the scenes as they are
        self.data_augmentor = DataAugmentor(
            self.root_path, self.dataset_cfg.get('DATA_AUGMENTOR') or [],
            self.class_names, logger=self.logger) if self.training else None
        self.data_processor = DataProcessor(
            self.dataset_cfg['DATA_PROCESSOR'],
            point_cloud_range=self.point_cloud_range, training=self.training)

        self.grid_size = self.data_processor.grid_size
        self.voxel_size = self.data_processor.voxel_size
        # what the network reads of a dataset (see models.DatasetMeta)
        self.num_point_features = self.point_feature_encoder.num_point_features
        self.max_points_per_voxel = self.data_processor.max_points_per_voxel
        self.max_voxels = self.data_processor.max_num_voxels
        # fixed gt pad (the reference pads to the per-batch max, which would
        # retrigger XLA compilation; 128 covers KITTI scenes + gt-paste)
        self.max_gt_boxes = int(self.dataset_cfg.get('MAX_GT_BOXES', 128))
        self.total_epochs = 0
        self._merge_all_iters_to_one_epoch = False

    @property
    def mode(self):
        return 'train' if self.training else 'test'

    def __getstate__(self):
        d = dict(self.__dict__)
        d.pop('logger', None)
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self.logger = None

    def merge_all_iters_to_one_epoch(self, merge=True, epochs=None):
        self._merge_all_iters_to_one_epoch = merge
        self.total_epochs = epochs

    def __len__(self):
        raise NotImplementedError

    def __getitem__(self, index):
        raise NotImplementedError

    def prepare_data(self, data_dict):
        """Augment -> filter classes -> encode class ids -> features ->
        process. In training, a scene that the augmentation leaves without
        gt boxes is replaced by a random other one."""
        if self.training:
            assert 'gt_boxes' in data_dict, 'gt_boxes required for training'
            gt_boxes_mask = np.array(
                [n in self.class_names for n in data_dict['gt_names']], dtype=np.bool_)
            data_dict = self.data_augmentor.forward({
                **data_dict, 'gt_boxes_mask': gt_boxes_mask,
            })
            if len(data_dict['gt_boxes']) == 0:
                new_index = np.random.randint(self.__len__())
                return self.__getitem__(new_index)

        if data_dict.get('gt_boxes', None) is not None:
            selected = common_utils.keep_arrays_by_name(
                data_dict['gt_names'], self.class_names)
            data_dict['gt_boxes'] = data_dict['gt_boxes'][selected]
            data_dict['gt_names'] = data_dict['gt_names'][selected]
            gt_classes = np.array(
                [self.class_names.index(n) + 1 for n in data_dict['gt_names']],
                dtype=np.int32)
            data_dict['gt_boxes'] = np.concatenate(
                (data_dict['gt_boxes'],
                 gt_classes.reshape(-1, 1).astype(np.float32)), axis=1)

        data_dict = self.point_feature_encoder.forward(data_dict)
        data_dict = self.data_processor.forward(data_dict)
        data_dict.pop('gt_names', None)
        return data_dict

    # ------------------------------------------------------------------ batch

    def _fixed_sizes(self):
        proc = self.data_processor
        n_points = None
        for p in self.dataset_cfg['DATA_PROCESSOR']:
            if p['NAME'] == 'sample_points':
                n_points = int(p['NUM_POINTS'][self.mode])
        return {
            'n_points': n_points,
            'max_voxels': getattr(proc, 'max_num_voxels', None),
            'points_per_voxel': getattr(proc, 'max_points_per_voxel', None),
        }

    def collate_batch(self, batch_list, _unused=False):
        """Pad per-sample dicts into fixed-shape batch arrays + masks."""
        sizes = self._fixed_sizes()
        data = defaultdict(list)
        for cur in batch_list:
            for k, v in cur.items():
                data[k].append(v)
        b = len(batch_list)
        ret = {'batch_size': b}

        if 'points' in data:
            n_fix = sizes['n_points']
            if n_fix is None or n_fix <= 0:   # -1 = sample_points 'keep all'
                n_fix = max(len(p) for p in data['points'])
            c = data['points'][0].shape[1]
            pts = np.zeros((b, n_fix, c), dtype=np.float32)
            mask = np.zeros((b, n_fix), dtype=bool)
            for i, p in enumerate(data['points']):
                n = min(len(p), n_fix)
                pts[i, :n] = p[:n]
                mask[i, :n] = True
            ret['points'] = pts
            ret['point_valid_mask'] = mask

        if 'voxels' in data:
            v_fix = sizes['max_voxels'] or max(len(v) for v in data['voxels'])
            p_fix = data['voxels'][0].shape[1]
            c = data['voxels'][0].shape[2]
            voxels = np.zeros((b, v_fix, p_fix, c), dtype=np.float32)
            coords = np.zeros((b, v_fix, 3), dtype=np.int32)
            counts = np.zeros((b, v_fix), dtype=np.int32)
            for i in range(b):
                nv = min(len(data['voxels'][i]), v_fix)
                voxels[i, :nv] = data['voxels'][i][:nv]
                coords[i, :nv] = data['voxel_coords'][i][:nv]
                counts[i, :nv] = data['voxel_num_points'][i][:nv]
            ret['voxels'] = voxels
            ret['voxel_coords'] = coords
            ret['voxel_num_points'] = counts
            ret['voxel_mask'] = counts > 0

        if 'gt_boxes' in data:
            code = data['gt_boxes'][0].shape[-1]
            gt = np.zeros((b, self.max_gt_boxes, code), dtype=np.float32)
            for i, g in enumerate(data['gt_boxes']):
                n = min(len(g), self.max_gt_boxes)
                if n < len(g) and not getattr(self, '_warned_gt_trunc', False):
                    self._warned_gt_trunc = True
                    import warnings
                    warnings.warn(
                        f'collate_batch: sample has {len(g)} gt boxes but '
                        f'MAX_GT_BOXES={self.max_gt_boxes}; the excess is '
                        f'DROPPED (their anchors train as negatives) — raise '
                        f'DATA_CONFIG.MAX_GT_BOXES')
                gt[i, :n] = g[:n]
            ret['gt_boxes'] = gt

        for k in data:
            if k in ('points', 'voxels', 'voxel_coords', 'voxel_num_points',
                     'gt_boxes', 'use_lead_xyz'):
                continue
            # equal-shape ndarray values stack into a (B, ...) array (the
            # reference collate's behavior for e.g. image_shape); everything
            # else (dicts, strings, ragged arrays) stays a per-sample list
            vals = data[k]
            if (isinstance(vals[0], np.ndarray)
                    and all(isinstance(v, np.ndarray)
                            and v.shape == vals[0].shape for v in vals)):
                ret[k] = np.stack(vals, axis=0)
            else:
                ret[k] = vals
        return ret
