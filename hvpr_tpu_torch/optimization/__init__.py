"""The optimizers of OPTIMIZATION.OPTIMIZER (port of ``hvpr_tpu/optimization``).

``adam_onecycle``: the JAX package chains optax transformations: clip by
global norm -> Adam (b2 = 0.99, eps = 1e-8) with the OneCycle learning rate
and a OneCycle b1 -> decoupled weight decay masked off norm parameters and
biases -> scale by -lr. This port (:class:`AdamOneCycle`) clips as optax
does, scaling by ``max_norm / norm`` when the norm exceeds ``max_norm`` (not
``clip_grad_norm_``, whose ``+1e-6`` differs), and hands the rest to
``torch.optim.AdamW``, whose update is optax's chain: the bias corrections
use the step's own b1, eps is added outside the square root, and the decay
``lr * wd * p`` is taken from the weight before the Adam step.

``adam`` and ``sgd`` (:class:`StepDecayOptimizer`): the same clip, then the
reference's coupled L2 on every parameter (``grad + wd * p`` before the
moments; ``optax.add_decayed_weights`` unmasked) and ``optax.adam`` (b1
0.9, b2 0.999, eps 1e-8) or ``optax.sgd`` with MOMENTUM (dampening 0):
``torch.optim.Adam`` / ``torch.optim.SGD`` with ``weight_decay``. Their
learning rate is :func:`decay_step_schedule` of the step: DECAY_STEP_LIST's
epoch milestones multiply it by LR_DECAY, LR_CLIP floors it, and with
LR_WARMUP a cosine ramp from LR / DIV_FACTOR runs over WARMUP_EPOCH epochs.

Every optimizer sets the step's hyper-parameters in each group before an
update, read at the count of updates made before it (optax reads its
schedules at that count), and its ``state_dict`` holds the torch
optimizer's state and that count: a resumed run makes the update the
uninterrupted run would make, to the bit.
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


def decay_step_schedule(lr, decay_step_list, lr_decay, lr_clip,
                        total_iters_each_epoch, warmup_epoch=0, warmup=False,
                        div_factor=10.0):
    """The learning rate of the step for ``adam`` and ``sgd``: ``lr`` times
    ``lr_decay`` once for each milestone (epochs of ``decay_step_list``
    times ``total_iters_each_epoch``) reached, floored at ``lr_clip``; with
    ``warmup`` and ``warmup_epoch`` > 0, before ``warmup_epoch`` epochs the
    cosine ramp from ``lr / div_factor`` to ``lr`` instead."""
    milestones = [m * total_iters_each_epoch for m in decay_step_list]
    warmup_steps = warmup_epoch * total_iters_each_epoch

    def lr_fn(step):
        if warmup and warmup_steps > 0 and step < warmup_steps:
            eta_min = lr / div_factor
            pct = min(max(step / warmup_steps, 0.0), 1.0)
            return eta_min + (lr - eta_min) * (1 - math.cos(math.pi * pct)) / 2
        return max(lr * lr_decay ** sum(step >= m for m in milestones), lr_clip)

    return lr_fn


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


class _ClippedOptimizer:
    """The clip, then the torch optimizer held under ``state_key``, with
    the step's hyper-parameters set in every group before each update.
    ``params``: the module's parameters in order; ``lr_fn``: the learning
    rate of a step; ``count``: the updates made."""

    state_key = None
    schedule_name = None

    def __init__(self, module, optim_cfg):
        self.params = [p for _, p in module.named_parameters()]
        self.clip = float(optim_cfg.get('GRAD_NORM_CLIP', 0.0))
        self.count = 0

    @property
    def torch_optimizer(self):
        return getattr(self, self.state_key)

    def _set_hyperparameters(self, group):
        group['lr'] = self.lr_fn(self.count)

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
        opt = self.torch_optimizer
        for group in opt.param_groups:
            self._set_hyperparameters(group)
        opt.step()
        opt.zero_grad(set_to_none=True)
        self.count += 1
        return norm

    def state_dict(self):
        """The torch optimizer's state (moments, steps, groups) and
        ``count``, the schedule's position: what a resumed run needs to
        make the next update the uninterrupted run would make."""
        return {self.state_key: self.torch_optimizer.state_dict(), 'count': self.count}

    def load_state_dict(self, state):
        self.torch_optimizer.load_state_dict(state[self.state_key])
        self.count = int(state['count'])


class AdamOneCycle(_ClippedOptimizer):
    """``adam_onecycle`` over a module's parameters, updated in place: the
    clip, then ``torch.optim.AdamW`` (foreach) in two groups, decayed and
    not, with the step's lr and b1 set before each update."""

    state_key = 'adamw'
    schedule_name = 'OneCycle'

    def __init__(self, module, optim_cfg, total_steps):
        super().__init__(module, optim_cfg)
        names = [n for n, _ in module.named_parameters()]
        mask = decayed(module)
        wd = float(optim_cfg.get('WEIGHT_DECAY', 0.0))
        groups = [{'params': [p for n, p in zip(names, self.params) if mask[n] == dec],
                   'weight_decay': wd if dec else 0.0} for dec in (True, False)]
        self.lr_fn, self.b1_fn = one_cycle_schedules(
            float(optim_cfg['LR']), total_steps,
            moms=tuple(optim_cfg.get('MOMS', [0.95, 0.85])),
            div_factor=float(optim_cfg.get('DIV_FACTOR', 10.0)),
            pct_start=float(optim_cfg.get('PCT_START', 0.4)))
        self.adamw = torch.optim.AdamW([g for g in groups if g['params']],
                                       betas=(self.b1_fn(0), 0.99), eps=1e-8,
                                       foreach=True)

    def _set_hyperparameters(self, group):
        group['lr'] = self.lr_fn(self.count)
        group['betas'] = (self.b1_fn(self.count), 0.99)


class StepDecayOptimizer(_ClippedOptimizer):
    """``adam`` or ``sgd`` over a module's parameters: the clip, then
    ``torch.optim.Adam`` or ``torch.optim.SGD`` (foreach, one group) with
    WEIGHT_DECAY as coupled L2 on every parameter, at the
    :func:`decay_step_schedule` lr of the step."""

    state_key = 'optim'

    def __init__(self, module, optim_cfg, total_iters_each_epoch):
        super().__init__(module, optim_cfg)
        name = optim_cfg['OPTIMIZER']
        lr = float(optim_cfg['LR'])
        self.lr_fn = decay_step_schedule(
            lr, list(optim_cfg.get('DECAY_STEP_LIST', [])),
            float(optim_cfg.get('LR_DECAY', 0.1)), float(optim_cfg.get('LR_CLIP', 1e-7)),
            total_iters_each_epoch or 1,
            warmup_epoch=int(optim_cfg.get('WARMUP_EPOCH', 0)),
            warmup=bool(optim_cfg.get('LR_WARMUP', False)),
            div_factor=float(optim_cfg.get('DIV_FACTOR', 10.0)))
        wd = float(optim_cfg.get('WEIGHT_DECAY', 0.0))
        if name == 'adam':
            self.optim = torch.optim.Adam(self.params, lr=self.lr_fn(0), betas=(0.9, 0.999),
                                          eps=1e-8, weight_decay=wd, foreach=True)
        else:
            self.optim = torch.optim.SGD(self.params, lr=self.lr_fn(0),
                                         momentum=float(optim_cfg.get('MOMENTUM', 0.9)),
                                         dampening=0.0, weight_decay=wd, foreach=True)
        self.schedule_name = f'{name} with step decay'


def build_optimizer(module, optim_cfg, total_steps=None, total_iters_each_epoch=None):
    """The optimizer of ``optim_cfg`` over ``module``: ``adam_onecycle``
    (OneCycle over ``total_steps``), or ``adam`` / ``sgd`` (milestones in
    epochs of ``total_iters_each_epoch`` steps, 1 if None)."""
    name = optim_cfg['OPTIMIZER']
    if name == 'adam_onecycle':
        assert total_steps is not None
        return AdamOneCycle(module, optim_cfg, total_steps)
    if name in ('adam', 'sgd'):
        return StepDecayOptimizer(module, optim_cfg, total_iters_each_epoch)
    raise NotImplementedError(name)
