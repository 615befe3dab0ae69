"""The whole HVPR train step on the card, timed and counted (port of
``tools/profile_train.py``).

    python -m hvpr_tpu_torch.tools.profile_train [--batch 4] [--iters 5]
        [--out FILE] [--device cuda]

``Network.train_step`` of hvpr.yaml as shipped (forward with the losses,
backward, the adam_onecycle update) at full width on seeded
``realistic_scans_with_boxes``, the network's own seeded initialization:
the median of ``iters`` steps after a warm-up (CUDA events), and from a
separate counting pass its GFLOP, GB, ``mfu`` and ``hbm_frac`` (null on the
CPU), in the JAX tool's record (``metric``, ``value``, ``unit``, ``batch``,
``scans_per_sec``).
"""

from .. import resolve_device
from .profile_stages import (N_POINTS, NOTE, cli, counted, device_record, kernel_record,
                             load_config, median_ms, utilization)
from .profile_train_stages import train_setup


def run(cfg=None, batch=4, device='cuda', iters=5, n_points=N_POINTS, seed=0):
    """The JAX tool's record of the step, with its counts and utilization."""
    cfg = load_config() if cfg is None else cfg
    device = resolve_device(device)
    record, peaks = device_record(device)
    net, data = train_setup(cfg, batch, device, n_points, seed)
    _, c = counted(lambda: net.train_step(data))
    ms = median_ms(lambda: net.train_step(data), device, iters)
    return {'metric': 'hvpr_train_step_ms', 'value': round(ms, 3), 'unit': 'ms/step',
            'batch': batch, 'scans_per_sec': round(batch / (ms / 1e3), 3),
            'gflop': round(c.flops / 1e9, 4), 'gb': round(c.bytes / 1e9, 4),
            **utilization(c.flops, c.bytes, ms, peaks), **record,
            'kernels': kernel_record([c]), 'note': NOTE}


def main(argv=None):
    return cli(__doc__.splitlines()[0], run, 4, 5, argv)


if __name__ == '__main__':
    main()
