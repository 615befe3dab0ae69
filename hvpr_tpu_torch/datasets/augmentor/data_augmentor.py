"""Config-driven augmentation pipeline of the train mode (host side).

The port's copy of ``hvpr_tpu/datasets/augmentor/data_augmentor.py``:
augmentations are built from a registry of builder functions, and
consecutive world-level augmentations (flip, rotation, scaling) are fused:
each step samples its parameters into a 3x3 linear map and the composed map
is applied to the scene once (:mod:`.augmentor_utils`). Gt sampling (the
paste of database objects) is a dict-level step. The steps are module-level functions bound by
``functools.partial`` (no closures), so that the augmentor pickles into the
DataLoader's worker processes. The pipeline ends, as the
reference's does, by bringing headings to [-pi, pi), dropping the host-only
keys ``calib`` and ``road_plane`` and applying ``gt_boxes_mask``.
"""

from functools import partial

import numpy as np

from ...utils import common_utils
from . import augmentor_utils
from .database_sampler import DataBaseSampler

# name -> builder(pipeline, cfg) returning either
#   ('world', sampler)   sampler() -> 3x3 linear, fused with its neighbours
#   ('dict', fn)         fn(data_dict) -> data_dict
_BUILDERS = {}


def _register(name):
    def deco(fn):
        _BUILDERS[name] = fn
        return fn
    return deco


@_register('gt_sampling')
def _build_gt_sampling(pipeline, cfg):
    sampler = DataBaseSampler(
        root_path=pipeline.root_path, sampler_cfg=cfg,
        class_names=pipeline.class_names, logger=pipeline.logger)
    return 'dict', sampler


def _sample_flips(axes):
    return augmentor_utils.compose(
        *[augmentor_utils.sample_flip(a) for a in reversed(axes)])


@_register('random_world_flip')
def _build_flip(pipeline, cfg):
    axes = list(cfg['ALONG_AXIS_LIST'])
    assert all(a in ('x', 'y') for a in axes), axes
    return 'world', partial(_sample_flips, axes)


@_register('random_world_rotation')
def _build_rotation(pipeline, cfg):
    rot = cfg['WORLD_ROT_ANGLE']
    if not isinstance(rot, (list, tuple, np.ndarray)):
        rot = [-rot, rot]
    return 'world', partial(augmentor_utils.sample_rotation, list(rot))


@_register('random_world_scaling')
def _build_scaling(pipeline, cfg):
    return 'world', partial(augmentor_utils.sample_scaling,
                            list(cfg['WORLD_SCALE_RANGE']))


class DataAugmentor:
    def __init__(self, root_path, augmentor_configs, class_names, logger=None):
        self.root_path = root_path
        self.class_names = class_names
        self.logger = logger

        if isinstance(augmentor_configs, list):
            cfg_list, disabled = augmentor_configs, ()
        else:
            cfg_list = augmentor_configs['AUG_CONFIG_LIST']
            disabled = augmentor_configs['DISABLE_AUG_LIST']
        self.steps = [
            _BUILDERS[cfg['NAME']](self, cfg)
            for cfg in cfg_list if cfg['NAME'] not in disabled
        ]

    def __getstate__(self):
        d = dict(self.__dict__)
        d.pop('logger', None)
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self.logger = None

    def forward(self, data_dict):
        world = None  # pending composed linear map
        for kind, step in self.steps:
            if kind == 'world':
                lin = step()
                world = lin if world is None else augmentor_utils.compose(
                    lin, world)
            else:
                data_dict = self._flush_world(world, data_dict)
                world = None
                data_dict = step(data_dict)
        data_dict = self._flush_world(world, data_dict)

        data_dict['gt_boxes'][:, 6] = common_utils.limit_period(
            data_dict['gt_boxes'][:, 6], offset=0.5, period=2 * np.pi)
        data_dict.pop('calib', None)
        data_dict.pop('road_plane', None)
        if 'gt_boxes_mask' in data_dict:
            mask = data_dict.pop('gt_boxes_mask')
            data_dict['gt_boxes'] = data_dict['gt_boxes'][mask]
            data_dict['gt_names'] = data_dict['gt_names'][mask]
        return data_dict

    @staticmethod
    def _flush_world(world, data_dict):
        if world is None:
            return data_dict
        boxes, points = augmentor_utils.transform_scene(
            world, data_dict['gt_boxes'], data_dict['points'])
        data_dict['gt_boxes'] = boxes
        data_dict['points'] = points
        return data_dict
