"""Detectors: plain PointPillar, the HVPR ``MixAnchor_Memory`` and SECOND.

Port of ``PointPillar`` and ``MixAnchorMemory`` in
``hvpr_tpu/models/detectors/pointpillar.py``. PointPillar has no point
stream: its forward is vfe -> map_to_bev -> backbone_2d -> dense_head in
eval and in training. HVPR runs the point stream ``backbone_3d`` first in
training (``module.train()``), where it feeds the attentive point features;
in eval it is skipped and memory lookups stand in for point features.
``SECONDNet`` (upstream OpenPCDet's name) runs its voxel backbone
``backbone_3d`` after the VFE, in eval and in training: vfe -> backbone_3d
-> map_to_bev -> backbone_2d -> dense_head (MeanVFE, the sparse
VoxelBackBone8x, HeightCompression, BaseBEVBackbone and an anchor head in
``tools/cfgs/kitti_models/second.yaml``).
Each stage is a span named after its attribute (``utils/profiler.py``).
"""

from ...utils import profiler
from .detector3d_template import Detector3DTemplate


class PointPillar(Detector3DTemplate):

    def stages(self):
        return (self.vfe, self.map_to_bev_module, self.backbone_2d, self.dense_head)

    def forward(self, batch_dict):
        batch_dict = dict(batch_dict)   # never mutate the caller's dict
        for stage in self.stages():
            with profiler.child_span(self, stage):
                batch_dict = stage(batch_dict)
        return batch_dict


class MixAnchorMemory(PointPillar):

    def stages(self):
        if self.training:
            return (self.backbone_3d,) + super().stages()
        return super().stages()


class SECONDNet(PointPillar):

    def stages(self):
        return (self.vfe, self.backbone_3d, self.map_to_bev_module, self.backbone_2d,
                self.dense_head)
