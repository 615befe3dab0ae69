"""Train state and train step, in one process or data-parallel over
several (port of ``hvpr_tpu/parallel``: ``make_train_step``'s step
function, with or without its mesh).

Over a process group of W ranks, one card each, a step of b scans a rank
equals the one-process step on the W·b scans, to rounding, as the JAX
mesh step does: the BatchNorms take their statistics over the global
batch and the memory loss its global pillar count (``models/``); each
rank's gradients are summed over the ranks in flat buckets, in the fixed
order of the optimizer's parameters, and divided by W before the clip; the
loss terms are averaged for the log. Every rank then makes the same update
from the same bits. The module is not wrapped in
``DistributedDataParallel``: its reducer hooks fire on ``.backward()``,
and the step takes ``torch.autograd.grad``. Without a process group
nothing is exchanged; in a group of one rank (``torchrun`` on one card)
the all-reduces run and change no bit.
"""

import torch
import torch.distributed as dist

from ..utils.common_utils import get_dist_info


def in_process_group():
    """True when this process belongs to an initialized process group."""
    return dist.is_available() and dist.is_initialized()


class TrainState:
    """The module (parameters and BN statistics), its optimizer, and the
    step counter."""

    def __init__(self, module, optimizer):
        self.module = module
        self.optimizer = optimizer
        self.step = 0


def _buckets(tensors):
    """``tensors`` grouped by (device, dtype), in order: [[index, ...], ...]."""
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.device, t.dtype), []).append(i)
    return list(groups.values())


def broadcast_state(module):
    """Copy rank 0's parameters and buffers to every rank, one flat bucket
    a dtype: a rank that loaded or initialized other weights starts from
    rank 0's."""
    tensors = list(module.parameters()) + list(module.buffers())
    with torch.no_grad():
        for bucket in _buckets(tensors):
            flat = torch.cat([tensors[i].reshape(-1) for i in bucket])
            dist.broadcast(flat, 0)
            for i, part in zip(bucket, flat.split([tensors[i].numel() for i in bucket])):
                tensors[i].copy_(part.view_as(tensors[i]))


def average_over_ranks(tensors):
    """The mean over the ranks of each of ``tensors`` (new tensors, the
    same bits on every rank): one all-reduce a bucket of (device, dtype)."""
    world = get_dist_info()[1]
    out = list(tensors)
    for bucket in _buckets(tensors):
        flat = torch.cat([tensors[i].reshape(-1) for i in bucket])
        dist.all_reduce(flat)
        flat /= world
        for i, part in zip(bucket, flat.split([tensors[i].numel() for i in bucket])):
            out[i] = part.view_as(tensors[i])
    return out


def loss_and_grads(state, batch):
    """Forward in training mode with the loss, then the gradient of every
    parameter of ``state.optimizer``, in its order (zeros for a parameter
    the loss does not reach). Returns (the forward's output dict, grads):
    this rank's own gradients."""
    state.module.train()
    out = state.module(dict(batch, global_step=state.step))
    params = state.optimizer.params
    grads = torch.autograd.grad(out['loss'], params, allow_unused=True)
    return out, [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]


def train_step(state, batch):
    """One step: :func:`loss_and_grads`, in a process group their mean over
    the ranks, one optimizer update, the counter.

    Returns (state, metrics): the ``tb_dict`` loss terms and ``loss`` (over
    several ranks their means, the global batch's terms) and ``grad_norm``
    (the norm of the gradients the update takes, before the clip), as
    detached tensors.
    """
    out, grads = loss_and_grads(state, batch)
    metrics = {k: v.detach() for k, v in out['tb_dict'].items()}
    metrics['loss'] = out['loss'].detach()
    if in_process_group():
        grads = average_over_ranks(grads)
        metrics = dict(zip(metrics, average_over_ranks(list(metrics.values()))))
    metrics['grad_norm'] = state.optimizer.step(grads)
    state.step += 1
    return state, metrics
