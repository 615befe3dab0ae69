"""Dense BEV canvas from pillars with per-sample unique cells (kernel K3).

Port of ``hvpr_tpu/ops/bev_canvas.py`` ``canvas_from_sorted``. On a CUDA
tensor :func:`canvas_from_sorted` launches ``csrc/bev_canvas.cu``, which
maps each cell to its pillar and then writes every vector of the canvas
once, zeros or the pillar's row cast to the canvas dtype; on a CPU tensor it
runs :func:`canvas_plain` (``scatter_to_bev``). Cells are unique per sample,
so there are no write conflicts and the result is exact, in bf16 too: the
kernel rounds the f32 features to the canvas dtype as the plain version's
cast does, and the JAX package pre-casts them. The kernel has no backward:
with grad enabled and features that require grad it raises (training
scatters with the differentiable ``scatter_to_bev``).
"""

import torch

from ..utils import flops
from . import _kernels
from .scatter import scatter_to_bev


def canvas_plain(features, coords, mask, ny, nx, out_dtype=torch.float32):
    return scatter_to_bev(features.to(out_dtype), coords, mask, ny, nx)


def _canvas_work(out, features, coords, mask, ny, nx, *_):
    return flops.bev_canvas_work(*features.shape, ny, nx, int(mask.sum()),
                                 out.element_size(), features.element_size())


@_kernels.wrapper('bev_canvas', canvas_plain, _canvas_work, no_backward=True)
def canvas_from_sorted(features, coords, mask, ny, nx, out_dtype=torch.float32):
    """(B, V, C) pillars -> (B, ny, nx, C) ``out_dtype`` canvas, zeros elsewhere.

    Args:
        features: (B, V, C) float pillar features.
        coords: (B, V, 3) int32 (z, y, x) cells, unique per sample over the
            valid pillars (the device voxelizer's layout).
        mask: (B, V) bool validity.
        ny, nx: grid size.
        out_dtype: torch.float32 or torch.bfloat16.
    """
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f'canvas: out_dtype {out_dtype} is not float32 or bfloat16')
    b, v, c = features.shape
    feat = features.float().contiguous()
    _kernels.check_cuda_input('canvas coords', coords, torch.int32, 3)
    _kernels.check_cuda_input('canvas mask', mask, torch.bool, 2)
    if coords.shape != (b, v, 3) or mask.shape != (b, v):
        raise ValueError(f'canvas: coords {tuple(coords.shape)} / mask '
                         f'{tuple(mask.shape)} do not match features (B, V)')
    bf16 = out_dtype == torch.bfloat16
    row_bytes = c * (2 if bf16 else 4)
    if row_bytes % 16 or feat.data_ptr() % 16:
        raise ValueError(f'canvas: a row of {row_bytes} bytes is not a multiple '
                         f'of 16, or the features are not 16-byte aligned')
    if ny * nx * row_bytes // 16 >= 2 ** 31:
        raise ValueError(f'canvas: {ny} x {nx} cells of {row_bytes} bytes exceed '
                         f'the kernel\'s 32-bit index within a sample')
    canvas = torch.empty(b, ny, nx, c, dtype=out_dtype, device=feat.device)
    cell_map = torch.empty(b, ny * nx, dtype=torch.int32, device=feat.device)
    _kernels.launch('bev_canvas', feat, _kernels.ptr(feat), _kernels.ptr(coords),
                    _kernels.ptr(mask), _kernels.ptr(cell_map), _kernels.ptr(canvas), b, v,
                    ny, nx, row_bytes // 16, int(bf16))
    return canvas
