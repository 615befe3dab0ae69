"""Stage profile of HVPR inference on the card, with each stage's roofline
(port of ``tools/profile_stages.py``), and the helpers the other profilers
of this package share.

    python -m hvpr_tpu_torch.tools.profile_stages [--batch 16] [--iters 5]
        [--out FILE] [--device cuda]

hvpr.yaml at full width on ``realistic_scans`` (16,384 points a scan, up to
16,000 pillars), with the network's own initialization from a seed. The
stages are voxelize, +vfe, +map_to_bev, +backbone_2d, +dense_head and
full+post. Eager PyTorch does not fuse across stages, so each stage is
timed alone, from a synchronized start (CUDA events; the host clock on the
CPU), the median of ``iters`` runs after a warm-up, and ``cum_ms`` is the
running sum. A separate counting pass (``utils.flops.Counter``) gives each
stage's operations and bytes: the aten ops' count plus the work the kernel
wrappers report. The rows have the keys of the JAX package's
``STAGE_PROFILE.json``; ``mfu`` and ``hbm_frac`` are taken against the
card's published peaks (``utils.flops.device_peaks``) and stand beside its
power limit. On the CPU (``device='cpu'``, the tests) every device
metric (``mfu``, ``hbm_frac``, ``bound``, ``cum_mfu``, the peaks) is null
and the times are the CPU's. The JSON is printed, and written to
``--out`` when given.
"""

import argparse
import contextlib
import json
import statistics
import time
from pathlib import Path

import numpy as np
import torch

from .. import resolve_device
from ..config import ConfigDict, cfg_from_yaml_file
from ..models import DatasetMeta, build_network
from ..models.detectors.detector3d_template import post_processing
from ..utils import flops
from ..utils.scans import realistic_scans_with_boxes

REPO = Path(__file__).resolve().parents[2]
CFG = 'tools/cfgs/kitti_models/hvpr.yaml'
N_POINTS = 16384
NOTE = ('flops = the aten ops\' registered formulas (torch.utils.flop_counter) + the '
        'work the kernel wrappers report (hvpr_tpu_torch/utils/flops.py); bytes = each '
        'eager op\'s operands and results, so L2 hits count as device-memory traffic and '
        'hbm_frac overestimates; mfu against the bf16 peak')


def load_config(path=CFG):
    """A config of the repository (``_BASE_CONFIG_`` paths are relative to
    its root)."""
    cfg = ConfigDict()
    with contextlib.chdir(REPO):
        cfg_from_yaml_file(path, cfg)
    return cfg


def build(cfg, device, train=False, seed=0):
    """The network of ``cfg`` on ``device`` (eval, or training with the
    point stream), initialized from ``seed``."""
    torch.manual_seed(seed)
    meta = DatasetMeta(cfg.DATA_CONFIG, cfg.CLASS_NAMES, mode='train' if train else 'test')
    return build_network(cfg.MODEL, len(cfg.CLASS_NAMES), meta, device=device, train=train)


def scans(net, batch, n_points, seed, device):
    """(points (B, N, 4), mask (B, N), gt_boxes (B, 49, 8)) of seeded
    ``realistic_scans`` over the network's point-cloud range."""
    pts, gt = realistic_scans_with_boxes(np.random.default_rng(seed), batch, n_points,
                                         net.dataset.point_cloud_range)
    return (torch.from_numpy(pts).to(device),
            torch.ones(batch, n_points, dtype=torch.bool, device=device),
            torch.from_numpy(gt).to(device))


def device_record(device):
    """({device, device_count, power_limit, peak_tflops_bf16,
    peak_hbm_gbps}, peaks or None): the card's, or nulls on the CPU."""
    if device.type != 'cuda':
        return {'device': 'cpu', 'device_count': 0, 'power_limit': None,
                'peak_tflops_bf16': None, 'peak_hbm_gbps': None}, None
    peaks = flops.device_peaks(device)
    return {'device': torch.cuda.get_device_name(device),
            'device_count': torch.cuda.device_count(), 'power_limit': flops.power_limit(),
            'peak_tflops_bf16': peaks[0] / 1e12, 'peak_hbm_gbps': peaks[1] / 1e9}, peaks


def timed_ms(fn, device):
    """(fn(), its milliseconds) from a synchronized start: CUDA events on
    the card, the host clock on the CPU."""
    if device.type != 'cuda':
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def median_ms(fn, device, iters):
    """Median milliseconds of ``iters`` calls of ``fn()`` after a warm-up."""
    fn()
    return statistics.median(timed_ms(fn, device)[1] for _ in range(iters))


def counted(fn):
    """(fn(), its Counter)."""
    with flops.Counter() as c:
        out = fn()
    return out, c


def utilization(fl, nbytes, ms, peaks):
    """``utils.flops.utilization`` of a region, all None without peaks."""
    if peaks is None:
        return {'mfu': None, 'hbm_frac': None, 'bound': None}
    return flops.utilization(fl, nbytes, ms / 1e3, peaks)


def kernel_record(counters):
    """{kernel: {calls, gflop, gb}} of what the wrappers reported to
    ``counters``."""
    out = {}
    for c in counters:
        for name, e in c.kernels.items():
            rec = out.setdefault(name, {'calls': 0, 'gflop': 0.0, 'gb': 0.0})
            rec['calls'] += e['calls']
            rec['gflop'] += e['ops'] / 1e9
            rec['gb'] += e['bytes'] / 1e9
    return out


def region_row(name, ms, counter, peaks):
    """A row of one timed region: its ms, GFLOP, GB and utilization."""
    return {'stage': name, 'ms': round(ms, 3), 'gflop': round(counter.flops / 1e9, 4),
            'gb': round(counter.bytes / 1e9, 4),
            **utilization(counter.flops, counter.bytes, ms, peaks)}


def cli(description, run, batch, iters, argv=None):
    """The command line of a profiler: ``run(load_config(), batch, device,
    iters)``, its JSON printed and written to ``--out`` when given."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument('--batch', type=int, default=batch)
    parser.add_argument('--iters', type=int, default=iters)
    parser.add_argument('--out', default=None, help='write the JSON here')
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args(argv)
    summary = run(load_config(), batch=args.batch, device=args.device, iters=args.iters)
    text = json.dumps(summary, indent=1)
    print(text)
    if args.out:
        Path(args.out).write_text(text + '\n')
    return summary


def run(cfg=None, batch=16, device='cuda', iters=5, n_points=N_POINTS, seed=0):
    """The stage profile (the summary dict of ``STAGE_PROFILE.json``)."""
    cfg = load_config() if cfg is None else cfg
    device = resolve_device(device)
    record, peaks = device_record(device)
    net = build(cfg, device, seed=seed)
    points, mask, _ = scans(net, batch, n_points, seed, device)
    mod = net.module
    stages = [('voxelize', lambda _: net.voxelize(points, mask)),
              ('+vfe', mod.vfe), ('+map_to_bev', mod.map_to_bev_module),
              ('+backbone_2d', mod.backbone_2d), ('+dense_head', mod.dense_head),
              ('full+post', lambda bd: post_processing(bd, net.post_cfg, net.num_class))]
    counters, times = [], {name: [] for name, _ in stages}
    with torch.no_grad():
        bd = None
        for name, stage in stages:                   # warm-up
            bd = stage(bd)
        for name, stage in stages:                   # the counting pass
            if name == 'full+post':
                live = torch.sigmoid(bd['batch_cls_preds']) >= net.post_cfg.SCORE_THRESH
                candidates = live.any(dim=-1).sum(dim=1).tolist()
            bd, c = counted(lambda: stage(bd))
            counters.append(c)
        for _ in range(iters):
            bd = None
            for name, stage in stages:
                bd, ms = timed_ms(lambda: stage(bd), device)
                times[name].append(ms)
    rows = []
    cum_ms = cum_fl = cum_by = 0.0
    for (name, _), c in zip(stages, counters):
        ms = statistics.median(times[name])
        cum_ms, cum_fl, cum_by = cum_ms + ms, cum_fl + c.flops, cum_by + c.bytes
        rows.append({'stage': name, 'cum_ms': round(cum_ms, 3), 'stage_ms': round(ms, 3),
                     'stage_gflop': round(c.flops / 1e9, 4),
                     'stage_gb': round(c.bytes / 1e9, 4),
                     **utilization(c.flops, c.bytes, ms, peaks),
                     'cum_mfu': utilization(cum_fl, cum_by, cum_ms, peaks)['mfu']})
    return {'batch': batch, 'stages': rows, 'pipeline_ms': rows[-1]['cum_ms'],
            'scans_per_sec': round(batch / (cum_ms / 1e3), 3),
            'pipeline_mfu': rows[-1]['cum_mfu'], **record,
            'candidates_per_scan': candidates, 'kernels': kernel_record(counters),
            'note': NOTE}


def main(argv=None):
    return cli(__doc__.splitlines()[0], run, 16, 5, argv)


if __name__ == '__main__':
    main()
