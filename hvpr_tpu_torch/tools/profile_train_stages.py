"""Stage profile of the HVPR train step on the card, with each prefix's
roofline (port of ``tools/profile_train_stages.py``).

    python -m hvpr_tpu_torch.tools.profile_train_stages [--batch 4] [--iters 3]
        [--out FILE] [--device cuda]

hvpr.yaml as shipped (the fused attentive scatter) at full width on seeded
``realistic_scans_with_boxes``, the network's own seeded initialization.
Each prefix (backbone_3d, vfe, map_to_bev, backbone_2d) is the forward up
to and including that stage plus the backward of a surrogate loss, the sum
of the prefix's output, to every parameter, as in the JAX tool; the last
row, ``full``, is ``Network.train_step`` (the head's loss, the backward and
the adam_onecycle update). ``cum_ms`` is a prefix's time (the median of
``iters`` after a warm-up, CUDA events) and ``stage_ms`` its difference
from the row before, which can be negative where a prefix's backward
skips a stage (vfe's surrogate reaches no parameter of the point stream).
The counts are the aten ops' plus what the kernel wrappers report (K4-K10,
K12 on their selections, not the JAX tool's dense formula over (V, N)).
The rows have the keys of the JAX package's ``TRAIN_PROFILE.json`` plus
``stage_gb`` and ``cum_mfu``; ``train_step_mfu`` is the whole step's (the
JAX tool wrote the ``full`` row's increment there). On the CPU every
device metric is null.
"""

import torch

from .. import resolve_device
from .profile_stages import (N_POINTS, NOTE, build, cli, counted, device_record,
                             kernel_record, load_config, median_ms, scans, utilization)

PREFIXES = ('backbone_3d', 'vfe', 'map_to_bev', 'backbone_2d')
# the surrogate loss of a prefix: the first of these keys its output holds
_STAGE_OUT = ('batch_cls_preds', 'spatial_features_2d', 'spatial_features',
              'pillar_features', 'point_features')
TOTAL_STEPS = 1000


def train_setup(cfg, batch, device, n_points=N_POINTS, seed=0):
    """(network with its optimizer, train batch) of ``cfg`` on ``device``."""
    net = build(cfg, device, train=True, seed=seed)
    points, mask, gt = scans(net, batch, n_points, seed, device)
    net.init_training(cfg.OPTIMIZATION, TOTAL_STEPS)
    return net, dict(net.voxelize(points, mask), gt_boxes=gt)


def prefix_grad(net, data, k):
    """The gradient of the surrogate loss of the first ``k`` train stages
    (a function of no argument)."""
    stages = net.module.stages()[:k]
    params = net.train_state.optimizer.params

    def fn():
        bd = dict(data)
        for stage in stages:
            bd = stage(bd)
        out = next(bd[key] for key in _STAGE_OUT if bd.get(key) is not None)
        return torch.autograd.grad(out.float().sum(), params, allow_unused=True)
    return fn


def run(cfg=None, batch=4, device='cuda', iters=3, n_points=N_POINTS, seed=0):
    """The train profile (the summary dict of ``TRAIN_PROFILE.json``)."""
    cfg = load_config() if cfg is None else cfg
    device = resolve_device(device)
    record, peaks = device_record(device)
    net, data = train_setup(cfg, batch, device, n_points, seed)
    net.module.train()
    regions = [(name, prefix_grad(net, data, k)) for k, name in enumerate(PREFIXES, 1)]
    regions.append(('full', lambda: net.train_step(data)))
    rows, counters = [], []
    prev_ms = prev_fl = prev_by = 0.0
    for name, fn in regions:
        _, c = counted(fn)
        counters.append(c)
        ms = median_ms(fn, device, iters)
        inc_ms, inc_fl, inc_by = ms - prev_ms, c.flops - prev_fl, c.bytes - prev_by
        rows.append({'stage': name, 'cum_ms': round(ms, 3), 'stage_ms': round(inc_ms, 3),
                     'stage_gflop': round(inc_fl / 1e9, 4), 'stage_gb': round(inc_by / 1e9, 4),
                     **utilization(inc_fl, inc_by, inc_ms, peaks),
                     'cum_mfu': utilization(c.flops, c.bytes, ms, peaks)['mfu']})
        prev_ms, prev_fl, prev_by = ms, c.flops, c.bytes
    full_ms = rows[-1]['cum_ms']
    return {'metric': 'hvpr_train_step_ms', 'value': full_ms, 'unit': 'ms/step',
            'batch': batch, 'scans_per_sec': round(batch / (full_ms / 1e3), 3),
            'train_step_mfu': rows[-1]['cum_mfu'], 'stages': rows, **record,
            'kernels': kernel_record(counters[-1:]), 'note': NOTE}


def main(argv=None):
    return cli(__doc__.splitlines()[0], run, 4, 3, argv)


if __name__ == '__main__':
    main()
