"""The ``adam_onecycle`` optimizer (port of ``hvpr_tpu/optimization``).

The JAX package chains optax transformations: clip by global norm ->
Adam (b2 = 0.99, eps = 1e-8) with the OneCycle learning rate and a OneCycle
b1 -> decoupled weight decay masked off norm parameters and biases -> scale
by -lr. This port (:class:`AdamOneCycle`) clips as optax does, scaling by
``max_norm / norm`` when the norm exceeds ``max_norm`` (not
``clip_grad_norm_``, whose ``+1e-6`` differs), and hands the rest to
``torch.optim.AdamW``, whose update is optax's chain: the bias corrections
use the step's own b1, eps is added outside the square root, and the decay
``lr * wd * p`` is taken from the weight before the Adam step.
"""

import math

import torch
from torch import nn


def _annealing_cos(start, end, pct):
    return end + (start - end) / 2 * (math.cos(math.pi * pct) + 1)


def one_cycle_schedules(lr_max, total_steps, moms=(0.95, 0.85), div_factor=10.0,
                        pct_start=0.4):
    """fastai OneCycle: (lr_fn, b1_fn) of the step, cosine up to ``lr_max``
    over ``pct_start`` of the steps, then cosine down to lr_max/div/1e4; b1
    goes the other way between ``moms``."""
    low = lr_max / div_factor
    boundary = pct_start * total_steps

    def phase(step):
        step = min(step, total_steps)
        pct1 = min(max(step / max(boundary, 1), 0.0), 1.0)
        pct2 = min(max((step - boundary) / max(total_steps - boundary, 1), 0.0), 1.0)
        return step <= boundary, pct1, pct2

    def lr_fn(step):
        up, pct1, pct2 = phase(step)
        return _annealing_cos(low, lr_max, pct1) if up else \
            _annealing_cos(lr_max, low * 1e-4, pct2)

    def b1_fn(step):
        up, pct1, pct2 = phase(step)
        return _annealing_cos(moms[0], moms[1], pct1) if up else \
            _annealing_cos(moms[1], moms[0], pct2)

    return lr_fn, b1_fn


def decayed(module):
    """{parameter name: True if weight decay applies}: not for biases, not
    for the parameters of a BatchNorm."""
    out = {}
    for mod_name, mod in module.named_modules():
        for name, _ in mod.named_parameters(recurse=False):
            full = f'{mod_name}.{name}' if mod_name else name
            out[full] = not (isinstance(mod, nn.modules.batchnorm._BatchNorm)
                             or name == 'bias')
    return out


class AdamOneCycle:
    """``adam_onecycle`` over a module's parameters, updated in place: the
    clip, then ``torch.optim.AdamW`` (foreach) in two groups, decayed and
    not, with the step's lr and b1 set before each update."""

    def __init__(self, module, optim_cfg, total_steps):
        if optim_cfg['OPTIMIZER'] != 'adam_onecycle':
            raise NotImplementedError(optim_cfg['OPTIMIZER'])
        names, params = zip(*module.named_parameters())
        self.params = list(params)
        mask = decayed(module)
        wd = float(optim_cfg.get('WEIGHT_DECAY', 0.0))
        groups = [{'params': [p for n, p in zip(names, params) if mask[n] == dec],
                   'weight_decay': wd if dec else 0.0} for dec in (True, False)]
        self.clip = float(optim_cfg.get('GRAD_NORM_CLIP', 0.0))
        self.lr_fn, self.b1_fn = one_cycle_schedules(
            float(optim_cfg['LR']), total_steps,
            moms=tuple(optim_cfg.get('MOMS', [0.95, 0.85])),
            div_factor=float(optim_cfg.get('DIV_FACTOR', 10.0)),
            pct_start=float(optim_cfg.get('PCT_START', 0.4)))
        self.adamw = torch.optim.AdamW([g for g in groups if g['params']],
                                       betas=(self.b1_fn(0), 0.99), eps=1e-8,
                                       foreach=True)
        self.count = 0

    @torch.no_grad()
    def step(self, grads):
        """Apply one update from ``grads`` (one per parameter, in the order
        of ``params``; scaled in place by the clip). Returns the global norm
        of the raw gradients."""
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        if self.clip > 0:
            torch._foreach_mul_(grads, torch.where(norm < self.clip, 1.0,
                                                   self.clip / norm))
        for p, g in zip(self.params, grads):
            p.grad = g
        for group in self.adamw.param_groups:
            group['lr'] = self.lr_fn(self.count)
            group['betas'] = (self.b1_fn(self.count), 0.99)
        self.adamw.step()
        self.adamw.zero_grad(set_to_none=True)
        self.count += 1
        return norm


def build_optimizer(module, optim_cfg, total_steps):
    """The optimizer of ``optim_cfg`` over ``module`` (adam_onecycle only)."""
    return AdamOneCycle(module, optim_cfg, total_steps)
