"""Seeded weights, made on the device in a few large draws.

The rules are a frozen copy of ``seed_weights`` in ``chip_smoke.py`` at
commit 1380d4cbc8b81ffdba01a8b3179518351fd96dae: He-normal convs and
linears (a transpose conv's fan-in is its input channels), the memory
uniform in +-1/sqrt(C), BatchNorm affine terms and running statistics
perturbed so that BN is exercised, other vectors N(0, 0.1), the box conv
N(0, ``box_std``) where given. Three things differ: the class bias is the
configuration's (0, or the head's prior ``-log((1 - pi) / pi)``, pi =
0.01), the class conv is N(0, ``cls_std``) where the configuration gives
it, and the values come from one ``torch.Generator`` on the device, one
normal and one uniform draw for all tensors in the order of their sorted
names, instead of a CPU draw a tensor.
"""

import math

import torch

PRIOR_PI = 0.01


def cls_bias_value(cls_bias):
    """The class bias of a cell file: a number, or 'prior'."""
    if cls_bias == 'prior':
        return -math.log((1 - PRIOR_PI) / PRIOR_PI)
    return float(cls_bias)


def _rule(name, shape, box_std, cls_std):
    """(draw, scale, offset) of one tensor: value = offset + scale * draw,
    draw 'normal' or 'uniform' (in [-1, 1)); or ('const', 0, value)."""
    if name.endswith('running_mean'):
        return 'normal', 0.1, 0.0
    if name.endswith('running_var'):
        return 'uniform', 0.75, 1.25          # 0.5 + 1.5 * U[0, 1)
    if box_std is not None and name.endswith('conv_box.weight'):
        return 'normal', float(box_std), 0.0
    if cls_std is not None and name.endswith('conv_cls.weight'):
        return 'normal', float(cls_std), 0.0
    if name.endswith('memory.weight'):
        return 'uniform', shape[1] ** -0.5, 0.0
    if len(shape) == 3:                    # a sparse conv's (taps, C_in, C_out)
        return 'normal', (2.0 / (shape[0] * shape[1])) ** 0.5, 0.0
    if len(shape) >= 2:
        fan_in = shape[0] if 'deblocks' in name else math.prod(shape[1:])
        return 'normal', (2.0 / fan_in) ** 0.5, 0.0
    if name.endswith('conv_cls.bias'):
        return 'const', 0.0, None
    if '.norm.' in name or name.split('.')[-2].isdigit():
        return 'normal', 0.1, 1.0 if name.endswith('weight') else 0.0
    return 'normal', 0.1, 0.0


def make_weights(shapes, seed, device, cls_bias=0.0, box_std=None, cls_std=None):
    """{name: f32 tensor on ``device``} for ``shapes`` ({name: shape} of
    the floating tensors of a state dict) from ``seed``."""
    names = sorted(shapes)
    rules = {n: _rule(n, tuple(shapes[n]), box_std, cls_std) for n in names}
    sizes = {kind: sum(math.prod(shapes[n]) for n in names if rules[n][0] == kind)
             for kind in ('normal', 'uniform')}
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    draws = {'normal': torch.randn(sizes['normal'], generator=gen, device=device),
             'uniform': torch.rand(sizes['uniform'], generator=gen, device=device) * 2 - 1}
    offsets = {'normal': 0, 'uniform': 0}
    out = {}
    for n in names:
        kind, scale, offset = rules[n]
        shape = tuple(shapes[n])
        if kind == 'const':
            out[n] = torch.full(shape, cls_bias_value(cls_bias), device=device)
            continue
        size = math.prod(shape)
        part = draws[kind][offsets[kind]:offsets[kind] + size]
        offsets[kind] += size
        out[n] = (part * scale + offset).reshape(shape)
    return out
