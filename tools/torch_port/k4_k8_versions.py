#!/usr/bin/env python3
"""Time K4 (the ball query) and K8 (the bucket threshold) against older
versions of their sources, on one NVIDIA GPU, with equal outputs.

Run from the repository root:

    python3 tools/torch_port/k4_k8_versions.py [--old-ball-query PATH] \\
        [--old-topk-attend PATH] [--variants "NAME=VALUE,...;..."]

It builds the libraries of ``hvpr_tpu_torch/csrc`` as they are and, where
given, older copies of ``ball_query.cu`` and ``topk_attend.cu`` (with the
same C entry points ``hvpr_ball_query`` and ``hvpr_bucket_threshold``) into
``build/``. Then, at hvpr.yaml's shapes at the fused train step's batch 4:

- K4 on the inputs of the two set-abstraction levels: the 4 scans of
  ``realistic_scans_with_boxes`` (seed 0) and centres from the model's
  chunked FPS (``FPS_CHUNKS`` 16), radii and nsample from ``SA_CONFIG``:
  the older source, one call per radius; this source, one call per radius
  (``hvpr_ball_query``); and this source's two-radius sweep
  (``hvpr_ball_query2``), one call per level. Every output must equal the
  plain version's.
- K8 and K9's dense sweep (the shared call) on seeded random pillars (4,
  16000, 64) with 38,047 valid rows (the fused step's count), a table (4,
  16384, 64) and k = 20: the older source and this one, K8's thresholds
  equal to the plain version's, K9's outputs the same bits in both
  sources. ``--variants`` adds builds of this source with other values of
  its constants (``kDK``, the DMMA depth; ``kTJW`` and ``kTBlocks`` of K8).

Each time is the CUDA-event median of 20 calls of the whole set (K4: the
four (level, radius) queries; K8, K9: one call), measured in the order
older, this, this, older (K4: per radius, two-radius, two-radius, per
radius, with the older source first and last). It prints the card's name and
power limit beside the times.
"""

import argparse
import ctypes
import os
import re
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build(path, name):
    """A ctypes library built from the CUDA source ``path`` into build/."""
    from hvpr_tpu_torch.ops import _kernels
    os.makedirs('build', exist_ok=True)
    so = os.path.abspath(os.path.join('build', f'lib{name}.so'))
    res = subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, '-I', str(_kernels.CSRC),
                          '-o', so, path], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f'nvcc failed for {path}:\n{res.stdout}{res.stderr}')
    return ctypes.CDLL(so)


def cuda_ms(fn, reps=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def ball_query_inputs():
    """[(xyz, centres, mask, radii, nsamples)] of the two SA levels."""
    import numpy as np
    import torch
    from hvpr_tpu_torch.config import ConfigDict, cfg_from_yaml_file
    from hvpr_tpu_torch.models import DatasetMeta
    from hvpr_tpu_torch.ops import pointnet2
    from hvpr_tpu_torch.utils.scans import realistic_scans_with_boxes
    cfg = ConfigDict()
    cfg_from_yaml_file('tools/cfgs/kitti_models/hvpr.yaml', cfg)
    meta = DatasetMeta(cfg.DATA_CONFIG, cfg.CLASS_NAMES, mode='train')
    sa = cfg.MODEL.BACKBONE_3D.SA_CONFIG
    pts, _ = realistic_scans_with_boxes(np.random.default_rng(0), 4, 16384,
                                        meta.point_cloud_range)
    xyz = torch.from_numpy(np.ascontiguousarray(pts[..., :3])).cuda()
    mask = torch.ones(4, 16384, dtype=torch.bool, device='cuda')
    levels = []
    for npoint, radii, nsamples in zip(sa.NPOINTS, sa.RADIUS, sa.NSAMPLE):
        idx = pointnet2.furthest_point_sample(xyz, mask, int(npoint),
                                              num_chunks=int(sa.FPS_CHUNKS))
        centres = pointnet2.group_points(xyz, idx).contiguous()
        levels.append((xyz, centres, mask, [float(r) for r in radii],
                       [int(s) for s in nsamples]))
        xyz, mask = centres, torch.gather(mask, 1, idx)
    return levels


def ball_query_versions(old_lib):
    import torch
    from hvpr_tpu_torch.ops import _kernels, pn2_select
    levels = ball_query_inputs()
    lib = _kernels.library('ball_query')
    one = lib.hvpr_ball_query
    two = lib.hvpr_ball_query2
    for fn in (one, two) + ((old_lib.hvpr_ball_query,) if old_lib else ()):
        fn.restype = ctypes.c_int
    one.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_float] + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    two.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_float, ctypes.c_int]
                    + [ctypes.c_void_p] * 2 + [ctypes.c_float] + [ctypes.c_int] * 4
                    + [ctypes.c_void_p])
    if old_lib:
        old_lib.hvpr_ball_query.argtypes = one.argtypes
    p = _kernels.ptr
    outs = []
    for xyz, centres, _, radii, nsamples in levels:
        b, s = centres.shape[:2]
        outs.append([(torch.empty(b, s, ns, dtype=torch.int32, device='cuda'),
                      torch.empty(b, s, dtype=torch.int32, device='cuda'))
                     for ns in nsamples])

    def per_radius(fn):
        def run():
            for (xyz, centres, mask, radii, nsamples), out in zip(levels, outs):
                b, n, _ = xyz.shape
                for r, ns, (idx, cnt) in zip(radii, nsamples, out):
                    if fn(p(xyz), p(centres), p(mask), p(idx), p(cnt), ctypes.c_float(r * r),
                          b, n, centres.shape[1], ns, _kernels.stream_handle(xyz)):
                        raise RuntimeError('ball query launch failed')
        return run

    def two_radii():
        for (xyz, centres, mask, radii, nsamples), out in zip(levels, outs):
            b, n, _ = xyz.shape
            (i0, c0), (i1, c1) = out
            r2 = [ctypes.c_float(r * r) for r in radii]
            if two(p(xyz), p(centres), p(mask), p(i0), p(c0), r2[0], nsamples[0], p(i1),
                   p(c1), r2[1], nsamples[1], b, n, centres.shape[1],
                   _kernels.stream_handle(xyz)):
                raise RuntimeError('two-radius ball query launch failed')

    variants = {'this source, per radius': per_radius(one), 'this source, two-radius': two_radii}
    if old_lib:
        variants = {'older source, per radius': per_radius(old_lib.hvpr_ball_query),
                    **variants}
    for name, run in variants.items():
        for out in outs:
            for idx, cnt in out:
                idx.fill_(-7)
                cnt.fill_(-7)
        run()
        torch.cuda.synchronize()
        for (xyz, centres, mask, radii, nsamples), out in zip(levels, outs):
            for r, ns, (idx, cnt) in zip(radii, nsamples, out):
                want = pn2_select.ball_query_bucket_plain(r, ns, xyz, centres, mask)
                if not (torch.equal(idx, want[0]) and torch.equal(cnt, want[1])):
                    raise RuntimeError(f'K4 ({name}) differs from plain at radius {r}, '
                                       f'{tuple(xyz.shape)} x {tuple(centres.shape)}')
    names = list(variants)
    order = names + names[::-1]
    times = {name: [] for name in names}
    for name in order:
        times[name].append(cuda_ms(variants[name]))
    shapes = [(tuple(x.shape), tuple(c.shape), r, ns) for x, c, _, r, ns in levels]
    return times, shapes


def topk_versions(old_lib, variants):
    """{'K8 ...' / 'K9 sweep ...': [ms, ms]} of the older source, this one
    and this source's ``variants`` ({name: library}) on the same inputs; K8
    equal to plain, K9's six outputs equal across the sources."""
    import numpy as np
    import torch
    from hvpr_tpu_torch.ops import _kernels
    from hvpr_tpu_torch.ops import topk_attend as ta
    rng = np.random.default_rng(0)
    b, v, n, c, k = 4, 16000, 16384, 64, 20
    pill = torch.from_numpy(rng.normal(size=(b, v, c)).astype(np.float32)).cuda()
    pts = torch.from_numpy(rng.normal(size=(b, n, c)).astype(np.float32)).cuda()
    neg = torch.zeros(b, n, device='cuda')
    mask = torch.zeros(b, v, dtype=torch.bool, device='cuda')
    for i, valid in enumerate((9300, 9600, 9500, 9647)):
        mask[i, :valid] = True
    pb, tb = pill.to(torch.bfloat16).contiguous(), pts.to(torch.bfloat16).contiguous()
    want = ta.bucket_threshold_plain(pb, tb, neg, k, mask)
    th = torch.empty(b, v, device='cuda')
    libs = {'this source': _kernels.library('topk_attend')}
    if old_lib:
        libs = {'older source': old_lib, **libs}
    p = _kernels.ptr

    def k8_of(lib):
        fn = lib.hvpr_bucket_threshold
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def run():
            if fn(*[p(t) for t in (pb, tb, neg, mask, th)], b, v, n, c, k,
                  _kernels.stream_handle(pb)):
                raise RuntimeError('bucket threshold launch failed')
            return th
        return run

    def k9_of(lib):
        outs = [torch.empty(b, v, c, device='cuda'), torch.empty(b, v, device='cuda'),
                torch.empty(b, v, device='cuda'),
                torch.empty(b, v, dtype=torch.int32, device='cuda'),
                torch.empty(b, v, ta.PAIR_CAP, dtype=torch.int32, device='cuda'),
                torch.empty(b, v, ta.PAIR_CAP, dtype=torch.bfloat16, device='cuda')]
        fn = lib.hvpr_masked_attend_fwd
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def run():
            if fn(*[p(t) for t in (pb, tb, tb, neg, want, mask, *outs)], b, v, n, c, 1,
                  _kernels.stream_handle(pb)):
                raise RuntimeError('masked attend launch failed')
            return outs
        return run
    libs.update({f'this source {name}': lib for name, lib in variants.items()})
    runs = {f'K8 {name}': k8_of(lib) for name, lib in libs.items()}
    runs.update({f'K9 sweep {name}': k9_of(lib) for name, lib in libs.items()})
    for name, run in runs.items():
        if name.startswith('K8'):
            th.fill_(7.0)
            got = run()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise RuntimeError(f'{name} differs from plain by '
                                   f'{float((got - want).abs().max())}')
    k9 = [[t.clone() for t in run()] for name, run in runs.items() if name.startswith('K9')]
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for other in k9[1:] for x, y in zip(k9[0], other)):
        raise RuntimeError('K9 sweep: the sources differ')
    names = list(runs)
    times = {name: [] for name in names}
    for name in names + names[::-1]:
        times[name].append(cuda_ms(runs[name]))
    return times


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--old-ball-query', help='an older csrc/ball_query.cu')
    ap.add_argument('--old-topk-attend', help='an older csrc/topk_attend.cu')
    ap.add_argument('--variants', default='',
                    help='builds of this topk_attend.cu with other constants, '
                         '"NAME=VALUE,NAME=VALUE;...": e.g. kDK (the DMMA depth), kTJW '
                         '(score columns a K8 lane holds at once), kTBlocks')
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    import torch
    if not torch.cuda.is_available():
        print('k4_k8_versions: torch sees no CUDA device', file=sys.stderr)
        return 2
    from hvpr_tpu_torch.ops import _kernels
    _kernels.build_all()
    old_bq = build(args.old_ball_query, 'ball_query_older') if args.old_ball_query else None
    old_ta = build(args.old_topk_attend, 'topk_attend_older') if args.old_topk_attend else None
    variants = {}
    src = open(os.path.join('hvpr_tpu_torch', 'csrc', 'topk_attend.cu')).read()
    for spec in filter(None, args.variants.split(';')):
        text, tag = src, spec.replace('=', '').replace(',', '_')
        for item in spec.split(','):
            name, value = item.split('=')
            text, hits = re.subn(rf'constexpr int {name} = \w+;',
                                 f'constexpr int {name} = {value};', text)
            if hits != 1:
                raise ValueError(f'{name}: no single constant in topk_attend.cu')
        cu = os.path.join('build', f'topk_attend_{tag}.cu')
        with open(cu, 'w') as f:
            f.write(text)
        variants[f'({spec})'] = build(cu, f'topk_attend_{tag}')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    k4, shapes = ball_query_versions(old_bq)
    print(f'K4 inputs (xyz, centres, radii, nsample) per level: {shapes}')
    for name, ms in k4.items():
        print(f'K4 {name}: {ms} ms for the step\'s 4 queries (equal to plain) on {smi}')
    for name, ms in topk_versions(old_ta, variants).items():
        print(f'{name}: {ms} ms (K8 equal to plain, K9 the same across sources) on {smi}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
