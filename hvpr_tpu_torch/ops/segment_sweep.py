"""Per-row full-segment max or sum over the flat pillar layout (kernel K1).

Port of ``hvpr_tpu/ops/segment_sweep.py`` ``segment_sweep_pallas``. On a
CUDA tensor :func:`segment_sweep` launches ``csrc/segment_sweep.cu``; on a
CPU tensor it runs :func:`segment_sweep_plain`, the doubling sweeps of
``ops/scatter.py``.

Both give every row the reduction over the rows of equal slot within
``max_seg - 1`` rows on either side, which for the voxelizer's contiguous
segments of <= ``max_seg`` rows is the whole segment. The kernel runs the
plain version's masked doubling sweeps in the same order, so the two agree
bit for bit, for ``sum`` as for ``max``.

The kernel has no backward: on a CUDA tensor that requires grad (with grad
enabled) :func:`segment_sweep` raises. The training forward calls the plain
sweeps directly, as the JAX package runs their XLA twins when training.
"""

import torch

from ..utils import flops
from . import _kernels
from .scatter import segment_broadcast_max_t, segment_sums_t

_OPS = {'max': 0, 'sum': 1}


def segment_sweep_plain(x_t, safe_slot, max_seg=32, op='max'):
    if op == 'max':
        return segment_broadcast_max_t(x_t, safe_slot, max_seg)
    if op == 'sum':
        return segment_sums_t(x_t, safe_slot, max_seg)
    raise ValueError(op)


@_kernels.wrapper('segment_sweep', segment_sweep_plain,
                  lambda out, x_t, *_: flops.segment_sweep_work(*x_t.shape), no_backward=True)
def segment_sweep(x_t, safe_slot, max_seg=32, op='max'):
    """(C, R) rows -> (C, R), every row holding its segment's max or sum.

    Args:
        x_t: (C, R) float32, invalid rows at the op's neutral value
            (-1e9 for 'max', 0 for 'sum').
        safe_slot: (R,) int32 slot ids, a sentinel (>= 0) on invalid rows.
        max_seg: segments are contiguous runs of <= max_seg rows.
        op: 'max' or 'sum'.
    """
    if op not in _OPS:
        raise ValueError(op)
    _kernels.check_cuda_input('segment_sweep x_t', x_t, torch.float32, 2)
    _kernels.check_cuda_input('segment_sweep safe_slot', safe_slot,
                              torch.int32, 1)
    c, r = x_t.shape
    if safe_slot.shape[0] != r or safe_slot.device != x_t.device:
        raise ValueError('segment_sweep: safe_slot must be (R,) on x_t.device')
    if not 1 <= max_seg <= 64:
        raise ValueError(f'segment_sweep: max_seg {max_seg} outside [1, 64]')
    out = torch.empty_like(x_t)
    if c == 0 or r == 0:
        return out
    _kernels.launch('segment_sweep', x_t, _kernels.ptr(x_t), _kernels.ptr(safe_slot),
                    _kernels.ptr(out), c, r, max_seg, _OPS[op])
    return out
