"""Detector assembly and post-processing.

Port of ``hvpr_tpu/models/detectors/detector3d_template.py``: the module
topology backbone_3d -> vfe -> map_to_bev -> backbone_2d -> dense_head built
from the config, and ``post_processing`` (sigmoid -> class-agnostic rotated
NMS -> fixed-shape detections, plus recall records when ``gt_boxes`` are
given). The modules of the HVPR inference and train paths are ported; the
point-stream ``backbone_3d`` runs only in training.
"""

import torch
from torch import nn

from ...ops.rotated_iou import boxes_iou3d
from ..backbones_2d.base_bev_backbone import BaseBEVBackboneScale
from ..backbones_2d.map_to_bev.pointpillar_scatter import (
    PointPillarScatterAggMemory1Scale)
from ..backbones_3d.pointnet2_backbone import PointNet2MSG
from ..backbones_3d.vfe.pillar_vfe import PillarVFE_Scale
from ..dense_heads.anchor_head_single import AnchorHeadSingle
from ..model_utils.model_nms_utils import class_agnostic_nms

_BACKBONES_3D = {'PointNet2MSG': PointNet2MSG}
_VFES = {'PillarVFE_Scale': PillarVFE_Scale}
_MAP_TO_BEV = {'PointPillarScatter_Agg_Memory_1_scale':
               PointPillarScatterAggMemory1Scale}
_BACKBONES_2D = {'BaseBEVBackbone_Scale': BaseBEVBackboneScale}
_DENSE_HEADS = {'AnchorHeadSingle': AnchorHeadSingle}


def _pick(registry, name, kind):
    if name not in registry:
        raise NotImplementedError(f'{kind} {name!r} is not ported yet '
                                  f'(ported: {sorted(registry)})')
    return registry[name]


class Detector3DTemplate(nn.Module):
    """Builds ``backbone_3d``, ``vfe``, ``map_to_bev_module``, ``backbone_2d``
    and ``dense_head`` (the reference's state_dict prefixes) from the
    config. ``point_stream=False`` (an eval-only network) leaves
    ``backbone_3d`` out, as the JAX package's eval variables do."""

    def __init__(self, model_cfg, num_class, class_names, grid_size,
                 point_cloud_range, voxel_size, num_point_features=4,
                 max_points_per_voxel=32, point_stream=True):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = num_class
        b3d_cfg = model_cfg.get('BACKBONE_3D') if point_stream else None
        self.backbone_3d = None if b3d_cfg is None else _pick(
            _BACKBONES_3D, b3d_cfg['NAME'], 'BACKBONE_3D')(b3d_cfg, num_point_features)
        vfe_cfg = model_cfg['VFE']
        self.vfe = _pick(_VFES, vfe_cfg['NAME'], 'VFE')(
            vfe_cfg, num_point_features, voxel_size, point_cloud_range,
            max_points_per_voxel)
        bev_cfg = model_cfg['MAP_TO_BEV']
        self.map_to_bev_module = _pick(_MAP_TO_BEV, bev_cfg['NAME'], 'MAP_TO_BEV')(
            bev_cfg, grid_size)
        b2d_cfg = model_cfg['BACKBONE_2D']
        self.backbone_2d = _pick(_BACKBONES_2D, b2d_cfg['NAME'], 'BACKBONE_2D')(
            b2d_cfg, int(bev_cfg['NUM_BEV_FEATURES']),
            int(list(vfe_cfg['NUM_SCALE_FEATURES'])[-1]))
        head_cfg = model_cfg['DENSE_HEAD']
        self.dense_head = _pick(_DENSE_HEADS, head_cfg['NAME'], 'DENSE_HEAD')(
            head_cfg, self.backbone_2d.num_bev_features,
            num_class if not head_cfg.get('CLASS_AGNOSTIC', False) else 1,
            class_names, grid_size, point_cloud_range)


def post_processing(batch_dict, post_cfg, num_class):
    """Sigmoid -> NMS -> fixed-shape detections (+ recall when gt present).

    Returns pred_boxes (B, P, 7+), pred_scores (B, P), pred_labels (B, P)
    int32, pred_mask (B, P) bool, num_capped (B,) survivors dropped by the
    NMS_POST_MAXSIZE cap, and ``recall`` when ``gt_boxes`` is in the batch.
    """
    nms_cfg = post_cfg['NMS_CONFIG']
    if nms_cfg.get('MULTI_CLASSES_NMS', False):
        raise NotImplementedError('MULTI_CLASSES_NMS is not ported yet')
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
    for cls_p, box_p in zip(cls_preds, box_preds):
        scores, labels = cls_p.max(dim=-1)
        keep_idx, keep_mask, num_kept = class_agnostic_nms(
            scores, box_p, nms_cfg, score_thresh=score_thresh)
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
    (``rcnn_t``) boxes."""
    rec = {'gt': 0, **{f'rcnn_{t}': 0 for t in thresh_list},
           **{f'roi_{t}': 0 for t in thresh_list}}
    for fb, fm, rb, gt in zip(final_boxes, final_mask, roi_boxes, gt_boxes):
        gt_valid = gt.abs().sum(dim=-1) > 0
        rec['gt'] = rec['gt'] + gt_valid.sum()
        iou_final = boxes_iou3d(fb[:, :7], gt[:, :7])
        iou_final = torch.where(fm[:, None] & gt_valid[None, :], iou_final, 0.0)
        best_final = iou_final.amax(dim=0)
        iou_roi = torch.where(gt_valid[None, :],
                              boxes_iou3d(rb[:, :7], gt[:, :7]), 0.0)
        best_roi = iou_roi.amax(dim=0)
        for t in thresh_list:
            rec[f'rcnn_{t}'] = rec[f'rcnn_{t}'] + (best_final > t).sum()
            rec[f'roi_{t}'] = rec[f'roi_{t}'] + (best_roi > t).sum()
    return rec
