"""Network factory and the inference and training entry points.

Port of ``hvpr_tpu/models/__init__.py`` (``build_network``, ``Network``,
``load_data_to_gpu``): :meth:`Network.eval_forward` runs the detector and
post-processing on a voxelized batch, either the host-voxelized padded one
of the data layer (``load_data_to_gpu`` moves it to the card) or the flat
one of the device voxelizer, which :meth:`Network.pipeline` puts in front
(the counterpart of ``bench.py``'s timed pipeline). A network built with
``train=True`` also has the point stream; :meth:`Network.init_training`
gives it an optimizer and :meth:`Network.train_step` runs one step (forward
with the losses, backward, update) on a batch with ``gt_boxes``: the data
layer's padded one (the train CLI's) or one from :meth:`Network.voxelize`.
Entry points run on the card unless the caller passes
``device='cpu'``. A pipeline call is a root span ``pipeline``, one request,
with a child ``voxelize`` (``utils/profiler.py``).
"""

import numpy as np
import torch

from .. import resolve_device
from ..ops.voxelizer import voxelize_batch_flat
from ..optimization import build_optimizer
from ..parallel import TrainState, train_step
from ..utils import profiler
from .detectors import build_detector
from .detectors.detector3d_template import post_processing


_ARRAY_KEYS = (
    'points', 'point_valid_mask', 'voxels', 'voxel_num_points', 'voxel_coords',
    'voxel_mask', 'gt_boxes',
)


def load_data_to_gpu(batch_dict, device='cuda'):
    """The batch with its array keys (points, voxels and their masks and
    counts, gt boxes) as tensors on ``device``, copied through pinned
    memory to a CUDA device; the other keys (frame ids, calibrations,
    image shapes) stay as they are on the host."""
    device = resolve_device(device)
    out = dict(batch_dict)
    for k in _ARRAY_KEYS:
        v = batch_dict.get(k)
        if isinstance(v, np.ndarray):
            t = torch.from_numpy(v)
            if device.type == 'cuda':
                t = t.pin_memory().to(device, non_blocking=True)
            out[k] = t
    return out


class DatasetMeta:
    """What the network needs from a dataset: class names, point-cloud
    range, voxel size, grid, per-pillar and per-sample caps and the point
    feature count (the data layer's ``DatasetTemplate`` has the same
    attributes)."""

    def __init__(self, data_cfg, class_names, mode='test'):
        self.class_names = list(class_names)
        self.point_cloud_range = np.asarray(data_cfg['POINT_CLOUD_RANGE'],
                                            dtype=np.float32)
        proc = {p['NAME']: p for p in data_cfg['DATA_PROCESSOR']}
        vox = proc['transform_points_to_voxels']
        self.voxel_size = np.asarray(vox['VOXEL_SIZE'], dtype=np.float32)
        self.grid_size = np.round((self.point_cloud_range[3:6]
                                   - self.point_cloud_range[0:3])
                                  / self.voxel_size).astype(np.int64)
        self.max_points_per_voxel = int(vox['MAX_POINTS_PER_VOXEL'])
        self.max_voxels = int(vox['MAX_NUMBER_OF_VOXELS'][mode])
        enc = data_cfg['POINT_FEATURE_ENCODING']
        self.num_point_features = 3 + sum(
            1 for name in enc['used_feature_list'] if name not in ('x', 'y', 'z'))


class Network:
    """A detector module on one device, with its post-processing config."""

    def __init__(self, module, dataset, post_cfg, num_class, device):
        self.module = module
        self.dataset = dataset
        self.post_cfg = post_cfg
        self.num_class = num_class
        self.device = device
        self.train_state = None

    def load_state_dict(self, state_dict):
        """Load reference-keyed weights (see ``utils/weights.py``); an
        eval-only network ignores the point stream's keys (a voxel
        backbone's it loads: the network runs it)."""
        if self.module.backbone_3d is None:
            state_dict = {k: v for k, v in state_dict.items()
                          if not k.startswith('backbone_3d.')}
        self.module.load_state_dict(state_dict, strict=True)

    @torch.no_grad()
    def eval_forward(self, batch_dict):
        """Detector forward (eval mode) + post-processing on a voxelized
        device batch."""
        was_training = self.module.training
        self.module.eval()
        try:
            out = self.module(batch_dict)
        finally:
            self.module.train(was_training)
        return post_processing(out, self.post_cfg, self.num_class)

    @torch.no_grad()
    def voxelize(self, points, mask):
        """(B, N, 4) points + (B, N) mask -> the batch dict the detector
        takes: the points and the device voxelizer's flat pillar layout."""
        ds = self.dataset
        with profiler.span('voxelize', points):
            vox = voxelize_batch_flat(
                points, mask, tuple(float(v) for v in ds.point_cloud_range),
                tuple(float(v) for v in ds.voxel_size),
                max_voxels=ds.max_voxels,
                max_points_per_voxel=ds.max_points_per_voxel,
                grid_size_static=tuple(int(g) for g in ds.grid_size))
        return {'points': points, 'point_valid_mask': mask, **vox}

    @torch.no_grad()
    def pipeline(self, points, mask):
        """(B, N, 4) points + (B, N) mask -> detections: voxelize, forward,
        post-process, all on the network's device."""
        with profiler.span('pipeline', points):
            return self.eval_forward(self.voxelize(points, mask))

    def init_training(self, optim_cfg, total_steps, total_iters_each_epoch=None):
        """Give the network its optimizer (``OPTIMIZATION`` config; OneCycle
        over ``total_steps``, or the step-decay milestones of ``adam`` and
        ``sgd`` in epochs of ``total_iters_each_epoch`` steps) and a fresh
        train state."""
        if self.module.backbone_3d is None and \
                self.module.model_cfg.get('BACKBONE_3D') is not None:
            raise RuntimeError('build the network with train=True to train it')
        self.train_state = TrainState(
            self.module, build_optimizer(self.module, optim_cfg, total_steps,
                                         total_iters_each_epoch))

    def train_step(self, batch_dict):
        """One step on a batch with ``gt_boxes`` (B, M, 8): a padded batch
        of the data layer on the network's device, or ``voxelize`` output.
        Returns the metrics (loss terms, ``loss``, ``grad_norm``) as
        detached tensors."""
        if self.train_state is None:
            raise RuntimeError('call init_training first')
        self.train_state, metrics = train_step(self.train_state, batch_dict)
        return metrics


def build_network(model_cfg, num_class, dataset, device='cuda', train=False):
    """Build the network of ``model_cfg`` on ``device``: eval mode, or with
    ``train=True`` training mode with the point stream (a voxel backbone is
    built in both). ``dataset`` is a
    :class:`DatasetMeta` or a dataset of :mod:`hvpr_tpu_torch.datasets`."""
    device = resolve_device(device)
    module = build_detector(model_cfg, num_class, dataset,
                            point_stream=train).to(device).train(train)
    return Network(module, dataset, model_cfg.get('POST_PROCESSING'),
                   num_class, device)
