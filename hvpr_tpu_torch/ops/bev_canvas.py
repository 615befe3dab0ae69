"""Dense BEV canvas from pillars with per-sample unique cells (kernel K3).

Port of ``hvpr_tpu/ops/bev_canvas.py`` ``canvas_from_sorted``. On a CUDA
tensor :func:`canvas_from_sorted` zeroes the canvas and launches
``csrc/bev_canvas.cu``, a direct row copy of every valid pillar to its cell;
on a CPU tensor it runs :func:`canvas_plain` (``scatter_to_bev``). Cells are
unique per sample, so there are no write conflicts and the result is exact,
in bf16 too: the features are cast to the canvas dtype first, as the JAX
package pre-casts them. The kernel has no backward: with grad enabled and
features that require grad it raises (training scatters with the
differentiable ``scatter_to_bev``).
"""

import ctypes

import torch

from . import _kernels
from .scatter import scatter_to_bev


def canvas_plain(features, coords, mask, ny, nx, out_dtype=torch.float32):
    return scatter_to_bev(features.to(out_dtype), coords, mask, ny, nx)


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
    if not _kernels.use_kernel(features):
        return canvas_plain(features, coords, mask, ny, nx, out_dtype)
    _kernels.refuse_grad('bev_canvas', features)
    b, v, c = features.shape
    feat = features.to(out_dtype).contiguous()
    _kernels.check_cuda_input('canvas coords', coords, torch.int32, 3)
    _kernels.check_cuda_input('canvas mask', mask, torch.bool, 2)
    if coords.shape != (b, v, 3) or mask.shape != (b, v):
        raise ValueError(f'canvas: coords {tuple(coords.shape)} / mask '
                         f'{tuple(mask.shape)} do not match features (B, V)')
    row_bytes = c * feat.element_size()
    if row_bytes % 16:
        raise ValueError(f'canvas: a row of {row_bytes} bytes is not a '
                         f'multiple of 16')
    canvas = torch.zeros(b, ny, nx, c, dtype=out_dtype, device=feat.device)
    if b * v == 0:
        return canvas
    lib = _kernels.library('bev_canvas')
    fn = lib.hvpr_bev_canvas
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(_kernels.ptr(feat), _kernels.ptr(coords), _kernels.ptr(mask),
             _kernels.ptr(canvas), b, v, ny, nx, row_bytes // 16,
             _kernels.stream_handle(feat))
    _kernels.launched('bev_canvas', err)
    return canvas
