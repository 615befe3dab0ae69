"""Row gather with a deterministic backward (kernel K12 on the card).

The JAX package's ``group_points`` (``hvpr_tpu/ops/pointnet2.py``) is an
XLA gather, whose scatter-add backward the TPU sums in a fixed order.
``torch.gather``'s backward on the card is a scatter-add by float atomics:
where indices repeat, as in the point stream's grouping and 3-NN
interpolation, its rounding changes from run to run, and two train steps
from the same state differ. :func:`gather_rows` gathers as ``torch.gather``
does and takes its gradient from :func:`gather_rows_backward`, which sums
each source row's contributions in source order: ``csrc/gather_grad.cu``
on a CUDA tensor (a stable sort of the targets, then one f32 sum a target
and channel, without atomics), :func:`gather_rows_backward_plain` on a CPU
tensor (an f32 ``index_add_``, which the CPU runs in source order). Both
sum in the same order, so the kernel gives the plain version's CPU bits,
on every run (on the card the plain version's ``index_add_`` adds by
atomics, unless torch's deterministic algorithms are on).
"""

import ctypes

import torch

from . import _kernels


def gather_rows_backward_plain(grad, index, n):
    """(R, C) gradient of the gathered rows, (R,) int64 source row of each
    -> (n, C) gradient of the source, in ``grad``'s dtype: the f32 sum of
    each source row's contributions in order, rounded once."""
    out = torch.zeros(n, grad.shape[1], dtype=torch.float32, device=grad.device)
    return out.index_add_(0, index, grad.float()).to(grad.dtype)


def gather_rows_backward(grad, index, n):
    """:func:`gather_rows_backward_plain` by kernel K12 on a CUDA tensor."""
    if not _kernels.use_kernel(grad):
        return gather_rows_backward_plain(grad, index, n)
    if grad.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f'gather_grad: dtype {grad.dtype} is not float32 or bfloat16')
    grad = grad.contiguous()
    _kernels.check_cuda_input('gather_grad index', index, torch.int64, 1)
    if index.shape[0] != grad.shape[0]:
        raise ValueError(f'gather_grad: {index.shape[0]} indices for {grad.shape[0]} rows')
    keys, order = torch.sort(index, stable=True)
    offsets = torch.searchsorted(keys, torch.arange(n + 1, device=grad.device))
    out = torch.empty(n, grad.shape[1], dtype=grad.dtype, device=grad.device)
    fn = _kernels.library('gather_grad').hvpr_gather_grad
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(_kernels.ptr(grad), _kernels.ptr(order), _kernels.ptr(offsets),
             _kernels.ptr(out), n, grad.shape[1], int(grad.dtype == torch.bfloat16),
             _kernels.stream_handle(grad))
    _kernels.launched('gather_grad', err)
    return out


class _GatherRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, features, flat_idx):
        b, n, c = features.shape
        flat_idx = flat_idx.long()
        ctx.save_for_backward(flat_idx)
        ctx.n = n
        return torch.gather(features, 1, flat_idx[..., None].expand(-1, -1, c))

    @staticmethod
    def backward(ctx, grad):
        flat_idx, = ctx.saved_tensors
        b, m, c = grad.shape
        n = ctx.n
        rows = (flat_idx + n * torch.arange(b, device=flat_idx.device)[:, None]).reshape(-1)
        out = gather_rows_backward(grad.reshape(b * m, c), rows, b * n)
        return out.reshape(b, n, c), None


def gather_rows(features, flat_idx):
    """(B, N, C) features at (B, M) int64 indices -> (B, M, C), as
    ``torch.gather`` along dim 1, with the deterministic backward."""
    return _GatherRows.apply(features, flat_idx)
