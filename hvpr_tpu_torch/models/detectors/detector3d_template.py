"""Detector assembly and post-processing.

Port of ``hvpr_tpu/models/detectors/detector3d_template.py``: the module
topology backbone_3d -> vfe -> map_to_bev -> backbone_2d -> dense_head built
from the config, each module's input channels taken from the one before it
as the JAX template threads them (a voxel backbone takes the VFE's output
channels, BACKBONE_2D takes MAP_TO_BEV.NUM_BEV_FEATURES), and
``post_processing`` (sigmoid ->
class-agnostic or per-class rotated NMS -> fixed-shape detections, plus
recall records when ``gt_boxes`` are given). The modules of the HVPR
(``MixAnchor_Memory``) and PointPillar detectors are ported with every
module of the JAX package's registries; the point-stream ``backbone_3d``
runs only in training. PointPillar never calls ``backbone_3d``, as in the
JAX package; ``SECONDNet`` (MeanVFE -> sparse VoxelBackBone8x ->
HeightCompression -> BaseBEVBackbone -> head) is the PointPillar subclass
whose forward runs the 3D backbone after the VFE.
"""

import torch
from torch import nn

from ...ops.rotated_iou import boxes_iou3d
from ...utils import profiler
from ..backbones_2d.base_bev_backbone import BaseBEVBackbone, BaseBEVBackboneScale
from ..backbones_2d.map_to_bev.height_compression import HeightCompression
from ..backbones_2d.map_to_bev.pointpillar_scatter import (
    PointPillarScatter, PointPillarScatterAggMemory1Scale)
from ..backbones_3d.pointnet2_backbone import (PointNet2Backbone, PointNet2MSG,
                                               PointNet2MSG_NOFP)
from ..backbones_3d.sparse_backbone import VoxelBackBone8xSparse
from ..backbones_3d.spconv_backbone import UNetV2, VoxelBackBone8x, VoxelResBackBone8x
from ..backbones_3d.vfe.pillar_vfe import MeanVFE, PillarVFE, PillarVFE_Scale
from ..dense_heads.anchor_head_multi import AnchorHeadMulti
from ..dense_heads.anchor_head_single import AnchorHeadSingle
from ..model_utils.model_nms_utils import class_agnostic_nms, multi_classes_nms

# the JAX package's registries, names and aliases alike
_BACKBONES_3D = {
    'PointNet2MSG': PointNet2MSG,
    'PointNet2MSG_NOFP': PointNet2MSG_NOFP,
    'PointNet2Backbone': PointNet2Backbone,
    'VoxelBackBone8x': VoxelBackBone8xSparse,         # sparse convs, production grids
    'VoxelBackBone8xDense': VoxelBackBone8x,          # dense 3D convs, coarse grids
    'VoxelResBackBone8x': VoxelResBackBone8x,
    'VoxelBackBone8x_voxelrcnn': VoxelBackBone8xSparse,
    'UNetV2': UNetV2,
}
_VOXEL_BACKBONES = ('VoxelBackBone8x', 'VoxelBackBone8xDense', 'VoxelResBackBone8x',
                    'VoxelBackBone8x_voxelrcnn', 'UNetV2')
_VFES = {'MeanVFE': MeanVFE, 'PillarVFE': PillarVFE, 'PillarVFE_Scale': PillarVFE_Scale}
_MAP_TO_BEV = {'HeightCompression': HeightCompression,
               'PointPillarScatter': PointPillarScatter,
               'PointPillarScatter_Agg_Memory_1_scale':
               PointPillarScatterAggMemory1Scale}
_BACKBONES_2D = {'BaseBEVBackbone': BaseBEVBackbone,
                 'BaseBEVBackbone_Scale': BaseBEVBackboneScale}
_DENSE_HEADS = {'AnchorHeadSingle': AnchorHeadSingle, 'AnchorHeadMulti': AnchorHeadMulti}


def _pick(registry, name, kind):
    if name not in registry:
        raise NotImplementedError(f'{kind} {name!r} is not ported yet '
                                  f'(ported: {sorted(registry)})')
    return registry[name]


class Detector3DTemplate(nn.Module):
    """Builds ``backbone_3d``, ``vfe``, ``map_to_bev_module``, ``backbone_2d``
    and ``dense_head`` (the reference's state_dict prefixes) from the
    config. ``point_stream=False`` (an eval-only network) leaves a
    point-based ``backbone_3d`` out, as the JAX package's eval variables do;
    a voxel backbone (``_VOXEL_BACKBONES``) is built either way, since it
    lies on the main path of the network that has one."""

    def __init__(self, model_cfg, num_class, class_names, grid_size,
                 point_cloud_range, voxel_size, num_point_features=4,
                 max_points_per_voxel=32, point_stream=True):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = num_class
        vfe_cfg = model_cfg['VFE']
        vfe = _pick(_VFES, vfe_cfg['NAME'], 'VFE')(
            vfe_cfg, num_point_features, voxel_size, point_cloud_range,
            max_points_per_voxel)
        b3d_cfg = model_cfg.get('BACKBONE_3D')
        if b3d_cfg is None or (not point_stream and b3d_cfg['NAME'] not in _VOXEL_BACKBONES):
            self.backbone_3d = None
        elif b3d_cfg['NAME'] in _VOXEL_BACKBONES:     # on the VFE's voxel features
            self.backbone_3d = _pick(_BACKBONES_3D, b3d_cfg['NAME'], 'BACKBONE_3D')(
                b3d_cfg, vfe.get_output_feature_dim(), grid_size)
        else:                                         # on the raw points
            self.backbone_3d = _pick(_BACKBONES_3D, b3d_cfg['NAME'], 'BACKBONE_3D')(
                b3d_cfg, num_point_features)
        self.vfe = vfe
        bev_cfg = model_cfg['MAP_TO_BEV']
        self.map_to_bev_module = _pick(_MAP_TO_BEV, bev_cfg['NAME'], 'MAP_TO_BEV')(
            bev_cfg, grid_size)
        b2d_cfg = model_cfg['BACKBONE_2D']
        b2d_cls = _pick(_BACKBONES_2D, b2d_cfg['NAME'], 'BACKBONE_2D')
        b2d_inputs = [int(bev_cfg['NUM_BEV_FEATURES'])]
        if b2d_cls is BaseBEVBackboneScale:   # and the scale stream's canvas
            b2d_inputs.append(self.vfe.get_scale_feature_dim())
        self.backbone_2d = b2d_cls(b2d_cfg, *b2d_inputs)
        head_cfg = model_cfg['DENSE_HEAD']
        self.dense_head = _pick(_DENSE_HEADS, head_cfg['NAME'], 'DENSE_HEAD')(
            head_cfg, self.backbone_2d.num_bev_features,
            num_class if not head_cfg.get('CLASS_AGNOSTIC', False) else 1,
            class_names, grid_size, point_cloud_range)


def post_processing(batch_dict, post_cfg, num_class):
    """Sigmoid -> NMS -> fixed-shape detections (+ recall when gt present),
    a span ``post`` (``utils/profiler.py``).

    Returns pred_boxes (B, P, 7+), pred_scores (B, P), pred_labels (B, P)
    int32, pred_mask (B, P) bool, num_capped (B,) survivors dropped by the
    NMS_POST_MAXSIZE cap, and ``recall`` when ``gt_boxes`` is in the batch.
    P is NMS_POST_MAXSIZE, or C times it with MULTI_CLASSES_NMS (one
    rotated NMS per class). Every NMS runs at NMS_PRE_MAXSIZE: it takes
    only the candidates above SCORE_THRESH, so it gives what the JAX
    package's ``NMS_STAGE_SIZES`` ladder gives at any of its levels.
    """
    with profiler.span('post', batch_dict['batch_cls_preds']):
        return _post_processing(batch_dict, post_cfg, num_class)


def _post_processing(batch_dict, post_cfg, num_class):
    nms_cfg = post_cfg['NMS_CONFIG']
    multi_class = bool(nms_cfg.get('MULTI_CLASSES_NMS', False))
    score_thresh = post_cfg.get('SCORE_THRESH', None)
    thresh_list = list(post_cfg.get('RECALL_THRESH_LIST', []))
    cls_preds = batch_dict['batch_cls_preds']
    if cls_preds.shape[-1] not in (1, num_class):
        raise ValueError(f'cls preds {tuple(cls_preds.shape)} vs {num_class} classes')
    box_preds = batch_dict['batch_box_preds']
    if not batch_dict.get('cls_preds_normalized', False):
        cls_preds = torch.sigmoid(cls_preds)
    post_max = int(nms_cfg['NMS_POST_MAXSIZE'])

    outs = []
    for scan, (cls_p, box_p) in enumerate(zip(cls_preds, box_preds)):
        if multi_class:
            outs.append(multi_classes_nms(cls_p, box_p, nms_cfg,
                                          score_thresh=score_thresh, scan=scan))
            continue
        scores, labels = cls_p.max(dim=-1)
        keep_idx, keep_mask, num_kept = class_agnostic_nms(
            scores, box_p, nms_cfg, score_thresh=score_thresh, scan=scan)
        outs.append((box_p[keep_idx], scores[keep_idx],
                     (labels[keep_idx] + 1).to(torch.int32), keep_mask,
                     torch.clamp(num_kept - post_max, min=0)))
    boxes, scores, labels, mask, capped = (torch.stack(t) for t in zip(*outs))
    out = {'pred_boxes': boxes, 'pred_scores': scores, 'pred_labels': labels,
           'pred_mask': mask, 'num_capped': capped}
    if 'gt_boxes' in batch_dict and thresh_list:
        out['recall'] = generate_recall_record(
            boxes, mask, box_preds, batch_dict['gt_boxes'], thresh_list)
    return out


def generate_recall_record(final_boxes, final_mask, roi_boxes, gt_boxes,
                           thresh_list):
    """Recall bookkeeping summed over the batch: ``gt`` count and, per
    threshold, the gts recalled by the raw (``roi_t``) and the post-NMS
    (``rcnn_t``) boxes. The IoUs are taken against the valid gt rows only
    (the JAX package masks the padded ones out of the same sums): every
    anchor against a nuScenes batch's 320 gt slots would be (A, 320) planes
    of ~0.8 GB each."""
    rec = {'gt': 0, **{f'rcnn_{t}': 0 for t in thresh_list},
           **{f'roi_{t}': 0 for t in thresh_list}}
    for fb, fm, rb, gt in zip(final_boxes, final_mask, roi_boxes, gt_boxes):
        gt_valid = gt.abs().sum(dim=-1) > 0
        rec['gt'] = rec['gt'] + gt_valid.sum()
        gt = gt[gt_valid]
        if gt.shape[0] == 0:
            continue
        iou_final = torch.where(fm[:, None], boxes_iou3d(fb[:, :7], gt[:, :7]), 0.0)
        best_final = iou_final.amax(dim=0)
        best_roi = boxes_iou3d(rb[:, :7], gt[:, :7]).amax(dim=0)
        for t in thresh_list:
            rec[f'rcnn_{t}'] = rec[f'rcnn_{t}'] + (best_final > t).sum()
            rec[f'roi_{t}'] = rec[f'roi_{t}'] + (best_roi > t).sum()
    return rec
