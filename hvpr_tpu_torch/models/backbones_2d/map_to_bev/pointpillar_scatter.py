"""Pillar -> BEV scatters: the plain one and HVPR's, with the attentive memory.

Port of ``PointPillarScatter`` and ``PointPillarScatterAggMemory1Scale`` in
``hvpr_tpu/models/backbones_2d/map_to_bev/pointpillar_scatter.py``.

``PointPillarScatter`` writes the pillar features into one NHWC canvas
(``spatial_features``): in eval, a flat batch through
:func:`ops.bev_canvas.canvas_from_sorted` (K3 on the card) in CANVAS_DTYPE,
a padded batch through the plain scatter; in training the differentiable
plain scatter in f32, as the JAX package's ``_build_canvas`` picks.

Eval: the memory reconstructs every pillar, and two canvases are written,
[pillar | memory] (``spatial_features``) and the scale stream
(``spatial_scale_features``), NHWC. A batch of the device voxelizer
(``flat_points``: pillar slots in cell order) goes through
:func:`ops.bev_canvas.canvas_from_sorted` (kernel K3 on the card); a
host-voxelized batch (pillars in first-seen order) through the plain
``scatter_to_bev``, as the JAX package's ``_build_canvas`` picks its
generic scatter for it.

Training selects for each pillar a set of points by ``pillar . point``,
aggregates the points (``point_positive_features``) and their memory
reconstructions (``memory_positive_features``) over it with stop-gradient
softmax weights, and one differentiable ``scatter_to_bev`` emits
[stop-grad pillar | memory] (``spatial_features``), [pillar | point]
(``spatial_features_point``) and the scale stream. Two modes
(MAP_TO_BEV.TRAIN_ATTEND_MODE):

- ``fused`` (the default, which ``hvpr.yaml`` runs): one
  :func:`ops.topk_attend.bucket_threshold` (kernel K8) selects a superset of
  each pillar's top-k, and :func:`ops.topk_attend.masked_attend` (K9/K10)
  aggregates the points (shared logits) and the reconstructions. Empty
  pillar slots are skipped through ``voxel_mask`` and aggregate to 0.
- ``gather``: :func:`attentive_point_pooling` picks each pillar's exact
  top-k points with ``torch.topk`` (the JAX package takes ``approx_max_k``
  at recall 0.95, which is exact on its CPU backend) and the memory path
  gathers their reconstructions. The gathers go through
  :func:`ops.gather_rows.gather_rows` (kernel K12 in the backward on the
  card), whose backward sums each point's contributions in order: two
  steps give the same bits without deterministic algorithms.
"""

import torch
from torch import nn

from ....ops.bev_canvas import canvas_from_sorted
from ....ops.gather_rows import gather_rows
from ....ops.scatter import scatter_to_bev
from ....ops.topk_attend import bucket_threshold, masked_attend
from .memory_module import MemoryUnitAgg

# MAP_TO_BEV.TOPK_MODE of the memory's eval lookup (EXACT_TOPK: True is an
# alias of 'exact'); 'approx' runs the exact branch (memory_module.py)
TOPK_MODES = ('fused', 'approx', 'exact')


def _canvas_dtype(model_cfg):
    """MAP_TO_BEV.CANVAS_DTYPE: 'bf16' emits the canvases in bfloat16."""
    name = str(model_cfg.get('CANVAS_DTYPE', 'fp32')).lower()
    return torch.bfloat16 if name in ('bf16', 'bfloat16') else torch.float32


def _build_canvas(features, coords, mask, ny, nx, cells_sorted, out_dtype):
    """NHWC canvas of (B, V, C) pillars: K3 for cell-sorted slots, else the
    plain scatter (cells unique per sample in both)."""
    if cells_sorted:
        return canvas_from_sorted(features, coords, mask, ny, nx, out_dtype)
    return scatter_to_bev(features.to(out_dtype), coords, mask, ny, nx)


class PointPillarScatter(nn.Module):

    def __init__(self, model_cfg, grid_size):
        super().__init__()
        self.nx, self.ny, nz = (int(g) for g in grid_size)
        if nz != 1:
            raise ValueError(f'pillar grid must have nz == 1, got {nz}')
        self.out_dtype = _canvas_dtype(model_cfg)

    def forward(self, batch_dict):
        batch_dict['spatial_features'] = _build_canvas(
            batch_dict['pillar_features'], batch_dict['voxel_coords'],
            batch_dict['voxel_mask'], self.ny, self.nx,
            cells_sorted='flat_points' in batch_dict and not self.training,
            out_dtype=torch.float32 if self.training else self.out_dtype)
        return batch_dict


def attentive_point_pooling(points, point_mask, pillars, k, chunk=2048):
    """Per pillar, its top-k points by ``pillar . point`` over all points of
    the scan, re-weighted by stop-gradient softmax similarity and summed.

    The selection score runs under no_grad, ``chunk`` pillars at a time
    (nothing differentiable flows through it; one chunk of a batch-4
    flagship scan is a 537 MB score matrix).

    Args:
        points: (B, N, C) point features; point_mask: (B, N) bool;
        pillars: (B, V, C); k: top-k.
    Returns:
        output (B, V, C); topk_idx (B, V, k) int64; topk_valid (B, V, k)
        bool, False where the selection fell back to padded points.
    """
    b, v, c = pillars.shape
    neg = torch.where(point_mask, 0.0, -1e9).to(points.dtype)            # (B, N)
    outs, idxs, valids = [], [], []
    for v0 in range(0, v, chunk):
        pc = pillars[:, v0:v0 + chunk]
        with torch.no_grad():
            score = torch.bmm(pc, points.transpose(1, 2)) + neg[:, None, :]
            idx = torch.topk(score, k, dim=-1).indices                   # (B, vc, k)
        vc = idx.shape[1]
        pts = gather_rows(points, idx.reshape(b, vc * k)).reshape(b, vc, k, c)
        sel_neg = gather_rows(neg[..., None], idx.reshape(b, -1)).reshape(b, vc, k)
        pts = torch.where(sel_neg[..., None] < -0.5, 0.0, pts)
        agg_logits = (pc[:, :, None, :] * pts).sum(dim=-1) + sel_neg
        agg_w = torch.softmax(agg_logits, dim=-1).detach()
        outs.append((agg_w[..., None] * pts).sum(dim=2))
        idxs.append(idx)
        valids.append(sel_neg > -0.5)
    return torch.cat(outs, 1), torch.cat(idxs, 1), torch.cat(valids, 1)


class PointPillarScatterAggMemory1Scale(nn.Module):

    def __init__(self, model_cfg, grid_size):
        super().__init__()
        self.model_cfg = model_cfg
        self.nx, self.ny, nz = (int(g) for g in grid_size)
        if nz != 1:
            raise ValueError(f'pillar grid must have nz == 1, got {nz}')
        self.k = int(model_cfg['NUM_K'])
        self.memory = MemoryUnitAgg(int(model_cfg['NUM_M']),
                                    int(model_cfg['NUM_PT_FEATURES']),
                                    float(model_cfg['SHRINK_TH']))
        mode = str(model_cfg.get('TOPK_MODE', 'fused')).lower()
        if model_cfg.get('EXACT_TOPK', False):
            mode = 'exact'
        if mode not in TOPK_MODES:
            raise ValueError(f'TOPK_MODE {mode!r}: one of {TOPK_MODES}')
        self.topk_mode = mode
        self.out_dtype = _canvas_dtype(model_cfg)
        train_mode = str(model_cfg.get('TRAIN_ATTEND_MODE', 'fused')).lower()
        if train_mode not in ('fused', 'gather'):
            raise ValueError(f'TRAIN_ATTEND_MODE {train_mode!r}')
        self.train_attend_mode = train_mode

    def forward(self, batch_dict):
        pillars = batch_dict['pillar_features']
        coords = batch_dict['voxel_coords']
        vmask = batch_dict['voxel_mask']
        if self.training:
            return self._train_forward(batch_dict, pillars, coords, vmask)
        mem = self.memory.eval_forward(pillars, self.k, mode=self.topk_mode,
                                       vmask=vmask)
        fused = torch.cat([pillars, mem['output']], dim=-1)
        cells_sorted = 'flat_points' in batch_dict
        batch_dict['spatial_features'] = _build_canvas(
            fused, coords, vmask, self.ny, self.nx, cells_sorted, self.out_dtype)
        batch_dict['spatial_scale_features'] = _build_canvas(
            batch_dict['pillar_scale_features'], coords, vmask, self.ny,
            self.nx, cells_sorted, self.out_dtype)
        return batch_dict

    def _train_forward(self, batch_dict, pillars, coords, vmask):
        points = batch_dict['point_features']
        pmask = batch_dict.get('point_valid_mask')
        if pmask is None:
            pmask = torch.ones(points.shape[:2], dtype=torch.bool,
                               device=points.device)
        if self.train_attend_mode == 'fused':
            # one threshold feeds both aggregations
            neg = torch.where(pmask, 0.0, -1e30).float()
            row_mask = vmask.contiguous()
            thresh = bucket_threshold(pillars, points, neg, self.k, row_mask)
            # shared: one tensor as both tables, the scores are the logits;
            # the memory call selects the same points, so it reads this
            # call's selection instead of making the score sweep again
            point_agg, selection = masked_attend(pillars, points, points, neg, thresh,
                                                 row_mask, return_selection=True)
            mem_agg = self.memory.train_forward_fused(
                pillars, points, neg, thresh, row_mask, selection=selection)['output']
        else:
            point_agg, topk_idx, topk_valid = attentive_point_pooling(
                points, pmask, pillars, self.k)
            mem_agg = self.memory.train_forward(pillars, points, topk_idx,
                                                topk_valid)['output']
        fused_mem = torch.cat([pillars.detach(), mem_agg], dim=-1)
        fused_point = torch.cat([pillars, point_agg], dim=-1)
        fused = torch.cat([fused_mem, fused_point,
                           batch_dict['pillar_scale_features']], dim=-1)
        canvas = scatter_to_bev(fused, coords, vmask, self.ny, self.nx)
        c_mem, c_pt = fused_mem.shape[-1], fused_point.shape[-1]
        batch_dict['spatial_features'] = canvas[..., :c_mem]
        batch_dict['spatial_features_point'] = canvas[..., c_mem:c_mem + c_pt]
        batch_dict['spatial_scale_features'] = canvas[..., c_mem + c_pt:]
        batch_dict['point_positive_features'] = point_agg
        batch_dict['memory_positive_features'] = mem_agg
        batch_dict['memory_items'] = self.memory.weight
        return batch_dict
