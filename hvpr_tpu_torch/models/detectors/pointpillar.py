"""HVPR ``MixAnchor_Memory`` detector.

Port of ``MixAnchorMemory`` in ``hvpr_tpu/models/detectors/pointpillar.py``:
in training (``module.train()``) the point stream ``backbone_3d`` runs first
and feeds the attentive point features; in eval it is skipped and memory
lookups stand in for point features, so the forward is vfe -> map_to_bev ->
backbone_2d -> dense_head.
"""

from .detector3d_template import Detector3DTemplate


class MixAnchorMemory(Detector3DTemplate):

    def forward(self, batch_dict):
        batch_dict = dict(batch_dict)   # never mutate the caller's dict
        stages = (self.vfe, self.map_to_bev_module, self.backbone_2d,
                  self.dense_head)
        if self.training:
            stages = (self.backbone_3d,) + stages
        for stage in stages:
            batch_dict = stage(batch_dict)
        return batch_dict
