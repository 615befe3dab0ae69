"""Config-driven per-scan processing queue (host side).

The port's copy of ``hvpr_tpu/datasets/processor/data_processor.py``: each
DATA_PROCESSOR entry names a method (range mask, depth-stratified
``sample_points``, ``shuffle_points``, ``transform_points_to_voxels``),
curried with its config and run in order. Voxelization runs on the host
through :class:`ops.voxelizer.VoxelGeneratorNumpy` (spconv semantics); with
``SKIP_HOST_VOXELIZATION`` the step only records the grid geometry and the
batch is voxelized on the device.
"""

from functools import partial

import numpy as np

from ...ops.voxelizer import VoxelGeneratorNumpy
from ...utils import box_utils, common_utils


class DataProcessor:
    def __init__(self, processor_configs, point_cloud_range, training):
        self.point_cloud_range = point_cloud_range
        self.training = training
        self.mode = 'train' if training else 'test'
        self.grid_size = self.voxel_size = None
        self.data_processor_queue = []
        for cur_cfg in processor_configs:
            cur_processor = getattr(self, cur_cfg['NAME'])(config=cur_cfg)
            self.data_processor_queue.append(cur_processor)

    def mask_points_and_boxes_outside_range(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.mask_points_and_boxes_outside_range, config=config)
        mask = common_utils.mask_points_by_range(data_dict['points'], self.point_cloud_range)
        data_dict['points'] = data_dict['points'][mask]
        if data_dict.get('gt_boxes', None) is not None and config['REMOVE_OUTSIDE_BOXES'] \
                and self.training:
            box_mask = box_utils.mask_boxes_outside_range_numpy(
                data_dict['gt_boxes'], self.point_cloud_range, min_num_corners=1)
            data_dict['gt_boxes'] = data_dict['gt_boxes'][box_mask]
            if 'gt_names' in data_dict:
                data_dict['gt_names'] = data_dict['gt_names'][box_mask]
        return data_dict

    def shuffle_points(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.shuffle_points, config=config)
        if config['SHUFFLE_ENABLED'][self.mode]:
            points = data_dict['points']
            idx = np.random.permutation(points.shape[0])
            data_dict['points'] = points[idx]
        return data_dict

    def sample_points(self, data_dict=None, config=None):
        """Depth-stratified subsample/pad to a fixed point count."""
        if data_dict is None:
            return partial(self.sample_points, config=config)
        num_points = config['NUM_POINTS'][self.mode]
        if num_points == -1:
            return data_dict

        points = data_dict['points']
        if len(points) == 0:
            # empty scan (corrupt .bin, everything outside the range mask):
            # np.random.choice over an empty index set raises — pass the
            # empty array through; collate_batch pads to the fixed budget
            # with point_valid_mask False everywhere
            return data_dict
        if num_points < len(points):
            pts_depth = np.linalg.norm(points[:, 0:3], axis=1)
            pts_near_flag = pts_depth < 40.0
            far_idxs_choice = np.where(pts_near_flag == 0)[0]
            near_idxs = np.where(pts_near_flag == 1)[0]
            if num_points > len(far_idxs_choice):
                near_idxs_choice = np.random.choice(
                    near_idxs, num_points - len(far_idxs_choice), replace=False)
                choice = np.concatenate((near_idxs_choice, far_idxs_choice), axis=0) \
                    if len(far_idxs_choice) > 0 else near_idxs_choice
            else:
                choice = np.random.choice(
                    np.arange(len(points), dtype=np.int32), num_points, replace=False)
            np.random.shuffle(choice)
        else:
            choice = np.arange(0, len(points), dtype=np.int32)
            if num_points > len(points):
                extra_choice = np.random.choice(choice, num_points - len(points))
                choice = np.concatenate((choice, extra_choice), axis=0)
            np.random.shuffle(choice)
        data_dict['points'] = points[choice]
        return data_dict

    def transform_points_to_voxels(self, data_dict=None, config=None,
                                   voxel_generator=None):
        if data_dict is None:
            voxel_size = np.asarray(config['VOXEL_SIZE'], dtype=np.float32)
            grid_size = (np.asarray(self.point_cloud_range[3:6])
                         - np.asarray(self.point_cloud_range[0:3])) / voxel_size
            self.grid_size = np.round(grid_size).astype(np.int64)
            self.voxel_size = voxel_size
            self.max_points_per_voxel = int(config['MAX_POINTS_PER_VOXEL'])
            self.max_num_voxels = int(config['MAX_NUMBER_OF_VOXELS'][self.mode])
            voxel_generator = VoxelGeneratorNumpy(
                voxel_size=voxel_size,
                point_cloud_range=self.point_cloud_range,
                max_num_points=self.max_points_per_voxel,
                max_voxels=self.max_num_voxels)
            return partial(self.transform_points_to_voxels, config=config,
                           voxel_generator=voxel_generator)

        if config.get('SKIP_HOST_VOXELIZATION', False):
            return data_dict  # device-side voxelization path

        voxels, coordinates, num_points = voxel_generator.generate(data_dict['points'])
        if not data_dict.get('use_lead_xyz', True):
            voxels = voxels[..., 3:]
        data_dict['voxels'] = voxels
        data_dict['voxel_coords'] = coordinates
        data_dict['voxel_num_points'] = num_points
        return data_dict

    def forward(self, data_dict):
        for processor in self.data_processor_queue:
            data_dict = processor(data_dict=data_dict)
        return data_dict
