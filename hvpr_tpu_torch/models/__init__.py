"""Network factory and the inference entry points.

Port of ``hvpr_tpu/models/__init__.py`` (``build_network``, ``Network``) for
the eval path: :meth:`Network.eval_forward` runs the detector and
post-processing on a voxelized batch, :meth:`Network.pipeline` adds the
device voxelizer in front (the counterpart of ``bench.py``'s timed
pipeline). Entry points run on the card unless the caller passes
``device='cpu'``.
"""

import numpy as np
import torch

from .. import resolve_device
from ..ops.voxelizer import voxelize_batch_flat
from .detectors import build_detector
from .detectors.detector3d_template import post_processing


class DatasetMeta:
    """What the network needs from a dataset: class names, point-cloud
    range, voxel size, grid, per-pillar and per-sample caps."""

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
        self.num_point_features = 4


class Network:
    """A detector module on one device, with its post-processing config."""

    def __init__(self, module, dataset, post_cfg, num_class, device):
        self.module = module
        self.dataset = dataset
        self.post_cfg = post_cfg
        self.num_class = num_class
        self.device = device

    def load_state_dict(self, state_dict):
        """Load reference-keyed weights (see ``utils/weights.py``)."""
        self.module.load_state_dict(state_dict, strict=True)

    @torch.no_grad()
    def eval_forward(self, batch_dict):
        """Detector forward + post-processing on a voxelized device batch."""
        out = self.module(batch_dict)
        return post_processing(out, self.post_cfg, self.num_class)

    @torch.no_grad()
    def pipeline(self, points, mask):
        """(B, N, 4) points + (B, N) mask -> detections: voxelize, forward,
        post-process, all on the network's device."""
        ds = self.dataset
        vox = voxelize_batch_flat(
            points, mask, tuple(float(v) for v in ds.point_cloud_range),
            tuple(float(v) for v in ds.voxel_size),
            max_voxels=ds.max_voxels,
            max_points_per_voxel=ds.max_points_per_voxel,
            grid_size_static=tuple(int(g) for g in ds.grid_size))
        batch = {'points': points, 'point_valid_mask': mask, **vox}
        return self.eval_forward(batch)


def build_network(model_cfg, num_class, dataset, device='cuda'):
    """Build the eval-mode network of ``model_cfg`` on ``device``."""
    device = resolve_device(device)
    module = build_detector(model_cfg, num_class, dataset).to(device).eval()
    return Network(module, dataset, model_cfg.get('POST_PROCESSING'),
                   num_class, device)
