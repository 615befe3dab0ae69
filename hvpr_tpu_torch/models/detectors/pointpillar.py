"""Detectors: plain PointPillar and the HVPR ``MixAnchor_Memory``.

Port of ``PointPillar`` and ``MixAnchorMemory`` in
``hvpr_tpu/models/detectors/pointpillar.py``. PointPillar has no point
stream: its forward is vfe -> map_to_bev -> backbone_2d -> dense_head in
eval and in training. HVPR runs the point stream ``backbone_3d`` first in
training (``module.train()``), where it feeds the attentive point features;
in eval it is skipped and memory lookups stand in for point features.
"""

from .detector3d_template import Detector3DTemplate


class PointPillar(Detector3DTemplate):

    def stages(self):
        return (self.vfe, self.map_to_bev_module, self.backbone_2d, self.dense_head)

    def forward(self, batch_dict):
        batch_dict = dict(batch_dict)   # never mutate the caller's dict
        for stage in self.stages():
            batch_dict = stage(batch_dict)
        return batch_dict


class MixAnchorMemory(PointPillar):

    def stages(self):
        if self.training:
            return (self.backbone_3d,) + super().stages()
        return super().stages()
