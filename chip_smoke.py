#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``hvpr_tpu_torch/csrc`` into
``build/``, holds each kernel against its plain PyTorch version on the card
at the shapes the inference path gives it, then runs the HVPR inference
pipeline (voxelize -> PillarVFE_Scale -> memory scatter -> scale BEV backbone
-> anchor head -> rotated NMS) on ``tools/cfgs/kitti_models/hvpr.yaml`` at
batch 8 on seeded KITTI-like scans with seeded random weights, checks that
the run launched every kernel and that its detections equal those of the
same pipeline through the plain versions, and prints:

- a ``{"kernels": [...]}`` JSON line (times, bounds, launches, errors);
- the card's name and power limit as nvidia-smi reports them;
- last, ``{"ok": true, "device": {...}}``.

Any failed check exits nonzero. Without a CUDA device it exits 2 at once.
"""

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH = 8
N_POINTS = 16384
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
BF16_FLOPS_PER_S = 989e12          # H100 SXM dense bf16 tensor cores


def fail(msg):
    print(f'FAIL: {msg}', file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, reps=20, warmup=3):
    """Median milliseconds of ``fn()`` on the current stream (CUDA events)."""
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


def seed_weights(module, seed):
    """Seeded random weights: He-normal convs/linears, the memory uniform in
    +-1/sqrt(C), BN running statistics and affine terms perturbed so that BN
    is exercised, and the cls bias at 0 so that thousands of anchors clear
    SCORE_THRESH and reach NMS."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith('memory.weight'):
                bound = p.shape[1] ** -0.5
                v = (torch.rand(p.shape, generator=gen) * 2 - 1) * bound
            elif p.dim() >= 2:
                fan_in = p[0].numel() if 'deblocks' not in name else p.shape[0]
                v = torch.randn(p.shape, generator=gen) * (2.0 / fan_in) ** 0.5
            elif name.endswith('conv_cls.bias'):
                v = torch.zeros(p.shape)
            elif '.norm.' in name or name.split('.')[-2].isdigit():
                base = 1.0 if name.endswith('weight') else 0.0
                v = base + 0.1 * torch.randn(p.shape, generator=gen)
            else:
                v = 0.1 * torch.randn(p.shape, generator=gen)
            p.copy_(v)
        for name, b in module.named_buffers():
            if name.endswith('running_mean'):
                b.copy_(0.1 * torch.randn(b.shape, generator=gen))
            elif name.endswith('running_var'):
                b.copy_(0.5 + 1.5 * torch.rand(b.shape, generator=gen))


def capture_calls(modules_and_names, run):
    """Run ``run()`` with the named wrapper functions recorded: returns
    {name: [(args, kwargs), ...]} with tensor arguments cloned."""
    import torch
    calls = {}
    saved = []

    def recorder(key, fn):
        def wrapped(*args, **kwargs):
            calls.setdefault(key, []).append((
                tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args),
                dict(kwargs)))
            return fn(*args, **kwargs)
        return wrapped

    for mod, attr, key in modules_and_names:
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, recorder(key, getattr(mod, attr)))
    try:
        run()
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    return calls


def net_batch(net, points, mask):
    """The voxelized batch dict the pipeline feeds the detector."""
    from hvpr_tpu_torch.ops.voxelizer import voxelize_batch_flat
    ds = net.dataset
    return {'points': points, 'point_valid_mask': mask,
            **voxelize_batch_flat(points, mask,
                                  tuple(float(v) for v in ds.point_cloud_range),
                                  tuple(float(v) for v in ds.voxel_size),
                                  ds.max_voxels, ds.max_points_per_voxel,
                                  tuple(int(g) for g in ds.grid_size))}


def stage_ms(net, points, mask, reps=5):
    """Median milliseconds of each inference stage, synchronized around it
    (voxelize, the four model stages, post-processing)."""
    import torch
    from hvpr_tpu_torch.models.detectors.detector3d_template import post_processing
    mod = net.module
    stages = [('voxelize', None), ('vfe', mod.vfe),
              ('map_to_bev', mod.map_to_bev_module),
              ('backbone_2d', mod.backbone_2d), ('dense_head', mod.dense_head),
              ('post_processing', None)]
    times = {name: [] for name, _ in stages}
    with torch.no_grad():
        for _ in range(reps):
            batch = None
            for name, stage in stages:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if name == 'voxelize':
                    batch = net_batch(net, points, mask)
                elif name == 'post_processing':
                    post_processing(batch, net.post_cfg, net.num_class)
                else:
                    batch = stage(batch)
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) * 1e3)
    return {name: statistics.median(v) for name, v in times.items()}


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print('chip_smoke: torch sees no CUDA device', file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)      # the configs' _BASE_CONFIG_ paths are repo-relative
    from hvpr_tpu_torch.config import ConfigDict, cfg_from_yaml_file
    from hvpr_tpu_torch.models import DatasetMeta, build_network
    from hvpr_tpu_torch.models.backbones_2d.map_to_bev import (
        memory_module, pointpillar_scatter)
    from hvpr_tpu_torch.models.backbones_3d.vfe import pillar_vfe
    from hvpr_tpu_torch.ops import _kernels
    from hvpr_tpu_torch.utils.scans import realistic_scans

    # fp32 convs and matmuls in full f32 (no TF32), deterministic cuDNN:
    # the two pipeline runs below must differ only by the kernels
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False

    # 1. build
    t0 = time.perf_counter()
    report = _kernels.build_all()
    print(f'build: {time.perf_counter() - t0:.2f} s for {sorted(report)}')
    for name, rep in sorted(report.items()):
        for line in rep['log'].splitlines():
            if any(w in line for w in ('registers', 'spill', 'smem', 'error', 'warning')):
                print(f'  {name}: {line.strip()}')

    # 2. the card
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()[0]
    print(f'card: {smi}')

    # 3. network, weights, scans
    cfg = ConfigDict()
    cfg_from_yaml_file('tools/cfgs/kitti_models/hvpr.yaml', cfg)
    meta = DatasetMeta(cfg.DATA_CONFIG, cfg.CLASS_NAMES)
    net = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), meta, device='cuda')
    seed_weights(net.module, seed=0)
    pcr = meta.point_cloud_range
    points = torch.from_numpy(realistic_scans(np.random.default_rng(0), BATCH,
                                              N_POINTS, pcr)).cuda()
    mask = torch.ones(BATCH, N_POINTS, dtype=torch.bool, device='cuda')

    # 4. capture every wrapper call of one pipeline run (the warm-up)
    calls = capture_calls(
        [(pillar_vfe, 'segment_sweep', 'segment_sweep'),
         (memory_module, 'memory_lookup_fused', 'memory_lookup'),
         (pointpillar_scatter, 'canvas_from_sorted', 'bev_canvas')],
        lambda: net.pipeline(points, mask))
    torch.cuda.synchronize()

    # 5. each kernel against its plain version at the main path's shapes
    entries = {}
    wrappers = {'segment_sweep': pillar_vfe.segment_sweep,
                'memory_lookup': memory_module.memory_lookup_fused,
                'bev_canvas': pointpillar_scatter.canvas_from_sorted}
    for name, fn in wrappers.items():
        if name not in calls:
            fail(f'the pipeline never called the {name} wrapper')
        err = ms = plain_ms = 0.0
        for args, kwargs in calls[name]:
            got = fn(*args, **kwargs)
            with _kernels.plain_versions():
                want = fn(*args, **kwargs)
            torch.cuda.synchronize()
            if got.shape != want.shape or got.dtype != want.dtype:
                fail(f'{name}: {got.shape}/{got.dtype} vs plain {want.shape}/{want.dtype}')
            if not torch.isfinite(got.float()).all():
                fail(f'{name}: non-finite output')
            err = max(err, float((got.float() - want.float()).abs().max()))
            ms += cuda_ms(lambda: fn(*args, **kwargs))
            with _kernels.plain_versions():
                plain_ms += cuda_ms(lambda: fn(*args, **kwargs), reps=5, warmup=1)
        entries[name] = {'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms}
        print(f'{name}: {len(calls[name])} call(s) per forward, max_abs_err {err}, '
              f'kernel {ms:.4f} ms, plain {plain_ms:.4f} ms')
        # the kernels repeat the plain versions' arithmetic: bit-identical
        if err != 0.0:
            fail(f'{name}: kernel differs from its plain version by {err}')

    # K2's selected sets and thresholds, row by row
    args, _ = calls['memory_lookup'][0]
    _, th_k, cnt_k = memory_module.memory_lookup_fused(*args, return_stats=True)
    with _kernels.plain_versions():
        _, th_p, cnt_p = memory_module.memory_lookup_fused(*args, return_stats=True)
    if not (torch.equal(th_k, th_p) and torch.equal(cnt_k, cnt_p)):
        fail('memory_lookup: thresholds or selected counts differ from plain')
    k = args[2]
    print(f'memory_lookup: selected columns per row mean '
          f'{cnt_k.float().mean().item():.3f} (k={k}), min {int(cnt_k.min())}')

    # bounds and library yardsticks from this run's inputs
    def sweep_bytes(x, slot):
        return 2 * x.numel() * 4 + slot.numel() * 4
    entries['segment_sweep']['bound_ms'] = sum(
        sweep_bytes(a[0], a[1]) for a, _ in calls['segment_sweep']) / HBM_BYTES_PER_S * 1e3
    entries['segment_sweep']['bound_by'] = 'bytes'
    entries['segment_sweep']['library_ms'] = None

    pill, memw, row_mask = args[0], args[1], args[3]
    r, c = pill.shape
    m = memw.shape[0]
    r_valid = int(row_mask.sum())          # empty pillar slots are not looked up
    print(f'memory_lookup: {r_valid} of {r} rows are valid pillars')
    ops = 2.0 * r_valid * m * c + 2.0 * c * float(cnt_k.sum())  # logits + selected output
    nbytes = 2 * r * c * 4 + m * c * 4 + r
    entries['memory_lookup'].update(
        bound_ms=max(ops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3,
        bound_by='operations' if ops / BF16_FLOPS_PER_S > nbytes / HBM_BYTES_PER_S
        else 'bytes', library_ms=None)

    canvas_bytes, lib_ms = 0, 0.0
    for a, kw in calls['bev_canvas']:
        feat, coords, vmask, ny, nx = a[:5]
        out_dtype = a[5] if len(a) > 5 else kw.get('out_dtype', torch.float32)
        el = torch.finfo(out_dtype).bits // 8
        b, v, cc = feat.shape
        canvas_bytes += (b * ny * nx * cc * el + int(vmask.sum()) * cc * feat.element_size()
                         + vmask.numel() * 13)
        bi, vi = torch.nonzero(vmask, as_tuple=True)
        cell = coords[bi, vi, 1].long() * nx + coords[bi, vi, 2].long()
        rows = feat[bi, vi].to(out_dtype)
        canvas = torch.zeros(b, ny * nx, cc, dtype=out_dtype, device='cuda')
        lib_ms += cuda_ms(lambda: canvas.index_put_((bi, cell), rows))
    entries['bev_canvas'].update(bound_ms=canvas_bytes / HBM_BYTES_PER_S * 1e3,
                                 bound_by='bytes', library_ms=lib_ms)

    # 6. the main path, counts from zero
    _kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = net.pipeline(points, mask)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = _kernels.launch_counts()
    print(f'main path launches: {launches}')
    for name in _kernels.KERNELS:
        if launches[name] == 0:
            fail(f'the main path launched {name} no time')

    post = cfg.MODEL.POST_PROCESSING
    for key, shape in (('pred_boxes', (BATCH, 500, 7)), ('pred_scores', (BATCH, 500)),
                       ('pred_labels', (BATCH, 500)), ('pred_mask', (BATCH, 500))):
        if tuple(res[key].shape) != shape:
            fail(f'{key} shape {tuple(res[key].shape)}, expected {shape}')
    if not (torch.isfinite(res['pred_boxes']).all() and torch.isfinite(res['pred_scores']).all()):
        fail('non-finite detections')
    kept = res['pred_mask'].sum(dim=1)
    if int(kept.min()) == 0:
        fail(f'a scan kept no box: {kept.tolist()}')
    if int((res['pred_scores'][res['pred_mask']] < post.SCORE_THRESH).sum()):
        fail('a kept box scores below SCORE_THRESH')

    # the same pipeline through the plain versions: the same detections
    with _kernels.plain_versions():
        ref = net.pipeline(points, mask)
    torch.cuda.synchronize()
    if not torch.equal(res['pred_mask'], ref['pred_mask']):
        fail('kept sets differ from the plain pipeline')
    m_ = res['pred_mask']
    if not torch.equal(res['pred_labels'][m_], ref['pred_labels'][m_]):
        fail('labels differ from the plain pipeline')
    box_err = float((res['pred_boxes'][m_] - ref['pred_boxes'][m_]).abs().max())
    score_err = float((res['pred_scores'][m_] - ref['pred_scores'][m_]).abs().max())
    print(f'detections vs plain pipeline: kept per scan {kept.tolist()}, '
          f'max box diff {box_err}, max score diff {score_err}')
    if box_err > 1e-4 or score_err > 1e-5:
        fail('boxes or scores differ from the plain pipeline')

    # throughput, host clock around synchronized batches
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.pipeline(points, mask)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    batch_s = statistics.median(times)
    print(f'pipeline: first run {first_s:.4f} s, median of 5 {batch_s:.4f} s per '
          f'batch of {BATCH} -> {BATCH / batch_s:.2f} scans/s on {smi}')

    stages = stage_ms(net, points, mask)
    print('stage ms (median of 5, synchronized): '
          + ', '.join(f'{k} {v:.3f}' for k, v in stages.items()))
    with torch.no_grad():
        cls = net.module(net_batch(net, points, mask))['batch_cls_preds']
    live = (torch.sigmoid(cls).amax(dim=-1) >= post.SCORE_THRESH).sum(dim=1)
    print(f'NMS candidates clearing SCORE_THRESH per scan: {live.tolist()}')

    meta_k = {
        'segment_sweep': ('hvpr_tpu_torch/csrc/segment_sweep.cu',
                          'hvpr_tpu/ops/segment_sweep.py:106'),
        'memory_lookup': ('hvpr_tpu_torch/csrc/memory_lookup.cu',
                          'hvpr_tpu/ops/memory_lookup.py:168'),
        'bev_canvas': ('hvpr_tpu_torch/csrc/bev_canvas.cu',
                       'hvpr_tpu/ops/bev_canvas.py:128'),
    }
    kernels = []
    for name in _kernels.KERNELS:
        e = entries[name]
        kernels.append({'name': name, 'route': 'cuda', 'source': meta_k[name][0],
                        'replaces': meta_k[name][1], 'launches': launches[name],
                        'max_abs_err': e['max_abs_err'], 'ms': e['ms'],
                        'plain_ms': e['plain_ms'], 'bound_ms': e['bound_ms'],
                        'bound_by': e['bound_by'], 'library_ms': e['library_ms']})
    print(json.dumps({'kernels': kernels}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
