"""Single-device train state and train step (port of the single-device
path of ``hvpr_tpu/parallel``: ``make_train_step``'s step function; data
parallelism over several cards comes later)."""

import torch


class TrainState:
    """The module (parameters and BN statistics), its optimizer, and the
    step counter."""

    def __init__(self, module, optimizer):
        self.module = module
        self.optimizer = optimizer
        self.step = 0


def loss_and_grads(state, batch):
    """Forward in training mode with the loss, then the gradient of every
    parameter of ``state.optimizer``, in its order (zeros for a parameter
    the loss does not reach). Returns (the forward's output dict, grads)."""
    state.module.train()
    out = state.module(dict(batch, global_step=state.step))
    params = state.optimizer.params
    grads = torch.autograd.grad(out['loss'], params, allow_unused=True)
    return out, [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]


def train_step(state, batch):
    """One step: :func:`loss_and_grads`, one optimizer update, the counter.

    Returns (state, metrics): the ``tb_dict`` loss terms, ``loss`` and
    ``grad_norm`` (the norm of the raw gradients, before the clip), as
    detached tensors.
    """
    out, grads = loss_and_grads(state, batch)
    grad_norm = state.optimizer.step(grads)
    state.step += 1
    metrics = {k: v.detach() for k, v in out['tb_dict'].items()}
    metrics['loss'] = out['loss'].detach()
    metrics['grad_norm'] = grad_norm
    return state, metrics
