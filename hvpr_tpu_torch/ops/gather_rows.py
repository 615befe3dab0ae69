"""Row gather with a deterministic backward (kernel K12 on the card).

The JAX package's ``group_points`` (``hvpr_tpu/ops/pointnet2.py``) is an
XLA gather, whose scatter-add backward the TPU sums in a fixed order.
``torch.gather``'s backward on the card is a scatter-add by float atomics:
where indices repeat, as in the point stream's grouping and 3-NN
interpolation, its rounding changes from run to run, and two train steps
from the same state differ. :func:`gather_rows` gathers as ``torch.gather``
does and takes its gradient from :func:`gather_rows_backward`, which
sums each source row's contributions in source order: ``csrc/gather_grad.cu``
on a CUDA tensor (a counting sort of the rows by target on the device, then
a warp a target that adds its rows in order, without atomics on the sums),
:func:`gather_rows_backward_plain` on a CPU tensor (an f32 ``index_add_``,
which the CPU runs in source order). Both sum in the same order, so the
kernel gives the plain version's CPU bits, on every run (on the card the
plain version's ``index_add_`` adds by atomics, unless torch's
deterministic algorithms are on). :func:`gather_grad_ranges_plain` is the
plain version of the kernel's set-up.
"""

import torch

from ..utils import flops
from . import _kernels


def gather_rows_backward_plain(grad, index, n):
    """(R, C) gradient of the gathered rows, (R,) int64 source row of each
    -> (n, C) gradient of the source, in ``grad``'s dtype: the f32 sum of
    each source row's contributions in order, rounded once."""
    out = torch.zeros(n, grad.shape[1], dtype=torch.float32, device=grad.device)
    return out.index_add_(0, index, grad.float()).to(grad.dtype)


def gather_grad_ranges_plain(index, n):
    """Plain version of K12's set-up: (offsets (n + 1,), order), int64, with
    target t's source rows, ascending, at ``order[offsets[t]:offsets[t + 1]]``
    (a counting sort of the rows by target; a row whose target lies outside
    [0, n) is left out, as the kernel leaves it)."""
    rows = torch.nonzero((index >= 0) & (index < n)).squeeze(1)
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=index.device)
    offsets[1:] = torch.cumsum(torch.bincount(index[rows], minlength=n), 0)
    # rows taken in ascending order stay so within each target
    return offsets, rows[torch.argsort(index[rows], stable=True)]


def _scratch(rows, n, device):
    words = _kernels.entry('gather_grad_scratch')(rows, n)
    return torch.empty(words, dtype=torch.int32, device=device)


def _check_index(index, rows, n):
    _kernels.check_cuda_input('gather_grad index', index, torch.int64, 1)
    if index.shape[0] != rows:
        raise ValueError(f'gather_grad: {index.shape[0]} indices for {rows} rows')
    if max(rows, n) >= 2 ** 31:
        raise ValueError(f'gather_grad: {rows} rows into {n} targets; the kernel '
                         'counts in int32')


def gather_grad_ranges(index, n):
    """:func:`gather_grad_ranges_plain` by K12's set-up passes on a CUDA
    tensor (offsets and order int32): the ranges ``gather_rows_backward``
    builds in its own call, for holding them to the plain version."""
    if not _kernels.use_kernel(index):
        return gather_grad_ranges_plain(index, n)
    _check_index(index, index.shape[0], n)
    scratch = _scratch(index.shape[0], n, index.device)
    _kernels.launch('gather_grad_ranges', index, index.data_ptr(), scratch.data_ptr(),
                    index.shape[0], n)
    offsets = scratch[:n + 1]
    return offsets, scratch[n + 1:n + 1 + int(offsets[-1])]


@_kernels.wrapper('gather_grad', gather_rows_backward_plain,
                  lambda out, grad, index, n: flops.gather_grad_work(
                      *grad.shape, grad.element_size(), n))
def gather_rows_backward(grad, index, n):
    """:func:`gather_rows_backward_plain` by kernel K12 on a CUDA tensor."""
    if grad.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f'gather_grad: dtype {grad.dtype} is not float32 or bfloat16')
    grad = grad.contiguous()
    rows, c = grad.shape
    _check_index(index, rows, n)
    out = torch.empty(n, c, dtype=grad.dtype, device=grad.device)
    scratch = _scratch(rows, n, grad.device)
    bf16 = grad.dtype == torch.bfloat16
    # 16-byte loads where each row starts 16-byte aligned
    vec = c % (8 if bf16 else 4) == 0 and grad.data_ptr() % 16 == 0
    _kernels.launch('gather_grad', grad, grad.data_ptr(), index.data_ptr(), scratch.data_ptr(),
                    out.data_ptr(), rows, n, c, int(bf16), int(vec))
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
