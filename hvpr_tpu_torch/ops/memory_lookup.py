"""Fused memory lookup: logits -> top-k superset threshold -> softmax @ memory
(kernel K2).

Port of ``hvpr_tpu/ops/memory_lookup.py`` ``memory_lookup_fused`` with the
semantics of its ``_emulation``:

- pillars and memory are rounded to bf16;
- memory columns past M are padded to a multiple of 128 and held at -1e30;
- bucket b is the max over the logit columns equal to b mod 128;
- the threshold is the k-th largest bucket max, ties counted
  (``lax.top_k(bmax, k)[..., -1]``), and the row max is the max bucket max;
- ``w = e / sum(e)`` with ``e = exp(l - max) * [l >= threshold]``;
- the output is ``bf16(w) @ bf16(memory)``.

Sums of bf16 products (the logits, the output) and ``sum(e)`` accumulate in
f64 and round to f32 once. Those f64 sums are exact for these inputs, so the
result does not depend on summation order: the CUDA kernel and
:func:`memory_lookup_plain` give the same bits on the card. The JAX package
accumulates in f32; the two differ by f32 ulps.

Rows outside an optional ``row_mask`` (empty pillar slots) are not looked
up: their output, threshold and count are 0.

On a CUDA tensor :func:`memory_lookup_fused` launches
``csrc/memory_lookup.cu``; on a CPU tensor it runs
:func:`memory_lookup_plain`. The kernel has no backward: with grad enabled
and an input that requires grad it raises (eval runs under no_grad).
"""

import torch

from ..utils import flops
from . import _kernels

NUM_BUCKETS = 128
_NEG = -1e30
_SMEM_LIMIT = 232448    # bytes of shared memory a block can have on sm_90


def _round_up(x, m):
    return (x + m - 1) // m * m


def memory_lookup_plain(pillars, memory, k, row_mask=None, return_stats=False):
    """Plain PyTorch version; ``return_stats`` adds the per-row threshold
    and the number of selected columns."""
    if row_mask is not None:
        rows = torch.nonzero(row_mask).squeeze(1)
        got = memory_lookup_plain(pillars[rows], memory, k, None, return_stats)
        got = got if return_stats else (got,)
        full = [torch.zeros((pillars.shape[0],) + g.shape[1:], dtype=g.dtype,
                            device=g.device).index_copy_(0, rows, g) for g in got]
        return tuple(full) if return_stats else full[0]
    r, c = pillars.shape
    m = memory.shape[0]
    mp = _round_up(m, NUM_BUCKETS)
    p = pillars.to(torch.bfloat16).double()
    mem = torch.zeros(mp, c, dtype=torch.float64, device=memory.device)
    mem[:m] = memory.to(torch.bfloat16).double()
    logits = (p @ mem.t()).float()                               # (R, Mp)
    logits[:, m:] = _NEG
    bmax = logits.reshape(r, mp // NUM_BUCKETS, NUM_BUCKETS).amax(dim=1)
    thresh = torch.topk(bmax, k, dim=-1).values[:, -1:]
    sel = logits >= thresh
    mx = bmax.amax(dim=-1, keepdim=True)
    e = torch.where(sel, torch.exp(logits - mx), 0.0)
    w = e / e.double().sum(dim=-1, keepdim=True).float()
    out = (w.to(torch.bfloat16).double() @ mem).float()
    if return_stats:
        return out, thresh[:, 0], sel.sum(dim=-1).to(torch.int32)
    return out


def _lookup_plain(pillars, memory, k, row_mask, stats):
    """:func:`memory_lookup_plain` as (out, thresh, count), the last two None
    unless ``stats``."""
    if stats:
        return memory_lookup_plain(pillars, memory, k, row_mask, True)
    return memory_lookup_plain(pillars, memory, k, row_mask), None, None


def _lookup_work(out, pillars, memory, k, row_mask, stats):
    r = pillars.shape[0]
    return flops.memory_lookup_work(r, r if row_mask is None else int(row_mask.sum()),
                                    memory.shape[0], pillars.shape[1], float(out[2].sum()))


# the work needs the selected counts: a counted call asks for them
@_kernels.wrapper('memory_lookup', _lookup_plain, _lookup_work, no_backward=True,
                  count_args=lambda pillars, memory, k, row_mask, stats:
                  (pillars, memory, k, row_mask, True))
def _memory_lookup(pillars, memory, k, row_mask, stats):
    """(out, thresh, count) of :func:`memory_lookup_fused`, the last two None
    unless ``stats``."""
    r, c = pillars.shape
    m = memory.shape[0]
    _kernels.check_cuda_input('memory_lookup pillars', pillars, torch.float32, 2)
    _kernels.check_cuda_input('memory_lookup memory', memory, torch.float32, 2)
    if memory.device != pillars.device:
        raise ValueError('memory_lookup: memory and pillars on two devices')
    if row_mask is not None:
        _kernels.check_cuda_input('memory_lookup row_mask', row_mask,
                                  torch.bool, 1)
        if row_mask.shape[0] != r or row_mask.device != pillars.device:
            raise ValueError('memory_lookup: row_mask must be (R,) on the '
                             'pillars device')
    if c % 16 or c > 64:
        raise ValueError(f'memory_lookup: C={c} must be a multiple of 16, <= 64')
    smem = _kernels.entry('memory_lookup_smem')(m)
    if smem > _SMEM_LIMIT:
        raise ValueError(f'memory_lookup: M={m}, C={c} need {smem} B of shared '
                         f'memory per block, above {_SMEM_LIMIT}')
    out = torch.empty(r, c, dtype=torch.float32, device=pillars.device)
    thresh = count = None
    if stats:
        thresh = torch.empty(r, dtype=torch.float32, device=pillars.device)
        count = torch.empty(r, dtype=torch.int32, device=pillars.device)
    if r == 0:
        return out, thresh, count
    mem_bf = memory.to(torch.bfloat16).contiguous()
    # a null pointer for the row mask and the stats where there are none
    _kernels.launch('memory_lookup', pillars, _kernels.ptr(pillars), _kernels.ptr(mem_bf),
                    None if row_mask is None else _kernels.ptr(row_mask), _kernels.ptr(out),
                    _kernels.ptr(thresh) if stats else None,
                    _kernels.ptr(count) if stats else None, r, m, c, k)
    return out, thresh, count


def memory_lookup_fused(pillars, memory, k, row_mask=None, return_stats=False):
    """Aggregated top-k memory reconstruction of every pillar row.

    Args:
        pillars: (R, C) float32 rows (R = B*V, flattened by the caller).
        memory: (M, C) float32 memory rows.
        k: top-k, <= 128 (the selected set is a superset of the exact top-k).
        row_mask: optional (R,) bool; rows outside it output zeros.
        return_stats: also return the per-row threshold (R,) f32 and the
            count of selected columns (R,) int32 (for checks).
    Returns:
        (R, C) float32.
    """
    if memory.shape[1] != pillars.shape[1]:
        raise ValueError(f'memory_lookup: memory {tuple(memory.shape)} vs '
                         f'pillars {tuple(pillars.shape)}')
    if not 1 <= k <= NUM_BUCKETS:
        raise ValueError(f'memory_lookup: k={k} outside [1, {NUM_BUCKETS}]')
    got = _memory_lookup(pillars, memory, k, row_mask, return_stats)
    return got if return_stats else got[0]
