"""HVPR pillar -> BEV scatter with the memory lookup, eval branch.

Port of the eval branch of ``PointPillarScatterAggMemory1Scale`` in
``hvpr_tpu/models/backbones_2d/map_to_bev/pointpillar_scatter.py``: the
memory reconstructs every pillar, and two canvases are written, [pillar |
memory] (``spatial_features``) and the scale stream
(``spatial_scale_features``), NHWC, through
:func:`ops.bev_canvas.canvas_from_sorted` (kernel K3 on the card). The
device voxelizer's cells are unique per sample, which is all K3 needs.
"""

import torch
from torch import nn

from ....ops.bev_canvas import canvas_from_sorted
from .memory_module import MemoryUnitAgg


def _canvas_dtype(model_cfg):
    """MAP_TO_BEV.CANVAS_DTYPE: 'bf16' emits the canvases in bfloat16."""
    name = str(model_cfg.get('CANVAS_DTYPE', 'fp32')).lower()
    return torch.bfloat16 if name in ('bf16', 'bfloat16') else torch.float32


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
        self.topk_mode = mode
        self.out_dtype = _canvas_dtype(model_cfg)

    def forward(self, batch_dict):
        pillars = batch_dict['pillar_features']
        coords = batch_dict['voxel_coords']
        vmask = batch_dict['voxel_mask']
        mem = self.memory.eval_forward(pillars, self.k, mode=self.topk_mode,
                                       vmask=vmask)
        fused = torch.cat([pillars, mem['output']], dim=-1)
        batch_dict['spatial_features'] = canvas_from_sorted(
            fused, coords, vmask, self.ny, self.nx, self.out_dtype)
        batch_dict['spatial_scale_features'] = canvas_from_sorted(
            batch_dict['pillar_scale_features'], coords, vmask, self.ny,
            self.nx, self.out_dtype)
        return batch_dict
