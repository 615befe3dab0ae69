#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``hvpr_tpu_torch/csrc`` into
``build/`` (one nvcc per source, all at once), then drives two paths of
``tools/cfgs/kitti_models/hvpr.yaml`` at full width on seeded KITTI-like
scans with seeded random weights:

- inference, batch 8: voxelize -> PillarVFE_Scale -> memory scatter -> scale
  BEV backbone -> anchor head -> rotated NMS. Each inference kernel (K1-K3)
  is held against its plain PyTorch version at the shapes the path gives
  it, the path must launch each of them, and its detections must equal
  those of the same pipeline through the plain versions.
- training, batch 4, as shipped (``TRAIN_ATTEND_MODE: fused``): the point
  stream, the VFE, the attentive scatter (bucket threshold, masked attention
  of the points and of their memory reconstructions), the dual-pass
  backbone, the dual heads with their losses, backward and the
  adam_onecycle update. Each train kernel (K4 ball query, one sweep for
  both radii of an SA level, K5 FPS, K6/K7 the
  memory reconstruction forward/backward, K8 the bucket threshold, K9/K10
  the masked attention forward/backward) is held against its plain version
  at the shapes of one step (K9's pairs, the selected points and bf16
  weights K10 reduces, exactly; K9's two kernels, the dense sweep of the
  points' call and the pair pass of the memory call, which reads the first
  call's selection, the pair pass also against the plain version that
  recomputes the selection; K10 also against the dense plain backward,
  which recomputes every row's weights), one step through the kernels
  must equal one step through the plain versions from the same state bit
  for bit under torch's deterministic algorithms (each gradient, loss term
  and updated weight), and 5 more steps must launch each kernel its
  expected number of times; the step's peak memory is read with the
  captured inputs freed.
- the bucketed 3-NN (K11), which no path of the model calls (the FP modules
  keep the exact 3-NN, as in the JAX package): on the inputs of the two
  ``pointnet2.three_nn`` calls of one fused step it must equal its plain
  version (indices and distances) and launch once a call; the share of
  points whose bucket set is the exact set is printed.
- exact FPS (``furthest_point_sample(num_chunks=1)``, K5's long path) over
  the fused batch's 4 whole scans of 16,384 points, npoint 4096: equal to
  its plain version, timed, one launch.
- training in ``TRAIN_ATTEND_MODE: gather``: the kernel step must equal the
  plain step as above, and 2 timed steps must launch K4-K7 and never K8-K10.

Device times by kernel (torch.profiler) are printed for K2, K3, K4 (per
SA level, and per level and radius the same kernel for that radius alone,
each beside its bound), K7, K8, K9 (the dense sweep and the pair pass) and
K10's parts, and for K6 run to the end of its sweep, of its row chain and
whole; K6's count of nonzero weights a row, and the FP64-tensor-core
(DMMA) bounds of K6-K9 beside their bf16 bounds. Yardsticks (timed, never
called by the port): K2 beside ``scaled_dot_product_attention`` over the
selected sets, K3 beside ``torch.zeros`` + ``index_put_``, K9 beside
``scaled_dot_product_attention``.

It prints a ``{"kernels": [...]}`` JSON line (times, bounds, launches,
errors), the card's name and power limit as nvidia-smi reports them, and
last ``{"ok": true, "device": {...}}``. Any failed check exits nonzero.
Without a CUDA device it exits 2 at once.
"""

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CFG = 'tools/cfgs/kitti_models/hvpr.yaml'
BATCH = 8
TRAIN_BATCH = 4
N_POINTS = 16384
TRAIN_STEPS = 5                    # timed fused steps after the two comparison steps
GATHER_STEPS = 2                   # timed steps of the gather mode
TOTAL_STEPS = 100                  # the OneCycle schedule's length
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
BF16_FLOPS_PER_S = 989e12          # H100 SXM dense bf16 tensor cores
F32_FLOPS_PER_S = 67e12            # H100 SXM f32 outside the tensor cores
F64_TC_FLOPS_PER_S = 67e12         # H100 SXM f64 on the tensor cores (DMMA)
INFER_KERNELS = ('segment_sweep', 'memory_lookup', 'bev_canvas')
# launches of each train kernel in one step of hvpr.yaml: one ball query per
# SA level (both radii in one sweep), one FPS per level, one reconstruction
# each way, one threshold, and the masked attention of the points (K9's
# dense sweep) and of their reconstructions (K9's pair pass, on the first
# call's selection), and both backwards (the last four in fused mode only)
STEP_LAUNCHES = {'ball_query': 2, 'fps_chunks': 2, 'memory_recon_fwd': 1,
                 'memory_recon_bwd': 1, 'bucket_threshold': 1,
                 'masked_attend_fwd': 1, 'masked_attend_pairs': 1, 'masked_attend_bwd': 2}
ATTEND_KERNELS = ('bucket_threshold', 'masked_attend_fwd', 'masked_attend_pairs',
                  'masked_attend_bwd')
EXACT_FPS_NPOINT = 4096            # hvpr.yaml's SA1 npoint, over whole scans
# K6/K7 and K9/K10 against their plain versions: both accumulate exact
# products in f64 and round once, so they agree but for an order-dependent
# last f64 bit of a sum; allowed: 1e-5 of the output's largest magnitude
RECON_RTOL = 1e-5
META = {
    'segment_sweep': ('hvpr_tpu_torch/csrc/segment_sweep.cu',
                      'hvpr_tpu/ops/segment_sweep.py:106'),
    'memory_lookup': ('hvpr_tpu_torch/csrc/memory_lookup.cu',
                      'hvpr_tpu/ops/memory_lookup.py:168'),
    'bev_canvas': ('hvpr_tpu_torch/csrc/bev_canvas.cu',
                   'hvpr_tpu/ops/bev_canvas.py:128'),
    'ball_query': ('hvpr_tpu_torch/csrc/ball_query.cu',
                   'hvpr_tpu/ops/pn2_select.py:135'),
    'fps_chunks': ('hvpr_tpu_torch/csrc/fps_chunks.cu',
                   'hvpr_tpu/ops/pn2_select.py:302'),
    'memory_recon_fwd': ('hvpr_tpu_torch/csrc/memory_recon.cu',
                         'hvpr_tpu/ops/memory_recon.py:141'),
    'memory_recon_bwd': ('hvpr_tpu_torch/csrc/memory_recon.cu',
                         'hvpr_tpu/ops/memory_recon.py:169'),
    'bucket_threshold': ('hvpr_tpu_torch/csrc/topk_attend.cu',
                         'hvpr_tpu/ops/topk_attend.py:179'),
    'masked_attend_fwd': ('hvpr_tpu_torch/csrc/topk_attend.cu',
                          'hvpr_tpu/ops/topk_attend.py:376'),
    'masked_attend_pairs': ('hvpr_tpu_torch/csrc/topk_attend.cu',
                            'hvpr_tpu/ops/topk_attend.py:376'),
    'masked_attend_bwd': ('hvpr_tpu_torch/csrc/topk_attend.cu',
                          'hvpr_tpu/ops/topk_attend.py:427'),
    'three_nn_bucket': ('hvpr_tpu_torch/csrc/three_nn.cu',
                        'hvpr_tpu/ops/pn2_select.py:135'),
}


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


def device_times(fn, reps=3):
    """{kernel name: device milliseconds per call of ``fn()``} of each CUDA
    kernel (and memset) that ``fn()`` launches, from torch.profiler; empty
    when the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, 'self_device_time_total', 0.0)
        if us > 0:
            name = e.key.replace('(anonymous namespace)::', '')
            name = name.split('(')[0].split('<')[0].split()[-1].split('::')[-1]
            out[name] = out.get(name, 0.0) + us / 1e3 / reps
    return out


def device_breakdown(fn, reps=3):
    """'name ms, ...' of :func:`device_times`; 'not measured' when the
    profiler records no device time."""
    return ', '.join(f'{k} {v:.4f}' for k, v in device_times(fn, reps).items()) \
        or 'not measured'


def seed_weights(module, seed):
    """Seeded random weights: He-normal convs/linears (the point stream's
    1x1 convs too), the memory uniform in +-1/sqrt(C), BN running statistics
    and affine terms perturbed so that BN is exercised, and the cls bias at
    0 so that thousands of anchors clear SCORE_THRESH and reach NMS."""
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


def flat(out):
    """A wrapper's output as a flat tuple of tensors."""
    if isinstance(out, (tuple, list)):
        return tuple(t for o in out for t in flat(o))
    return (out,)


def capture_calls(modules_and_names, run):
    """Run ``run()`` with the named wrapper functions recorded: returns
    {name: [(args, kwargs), ...]} with tensor arguments cloned."""
    import torch
    calls = {}
    saved = []

    def recorder(key, fn):
        def wrapped(*args, **kwargs):
            calls.setdefault(key, []).append((
                tuple(a.detach().clone() if isinstance(a, torch.Tensor) else a
                      for a in args),
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


def load_cfg(train_attend_mode=None):
    from hvpr_tpu_torch.config import ConfigDict, cfg_from_yaml_file
    cfg = ConfigDict()
    cfg_from_yaml_file(CFG, cfg)
    if train_attend_mode is not None:
        cfg.MODEL.MAP_TO_BEV.TRAIN_ATTEND_MODE = train_attend_mode
    return cfg


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


def bound(ops, flops_per_s, nbytes):
    """(bound ms, 'operations' or 'bytes') of work of ``ops`` operations at
    ``flops_per_s`` that moves ``nbytes``."""
    t_ops, t_bytes = ops / flops_per_s, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, 'operations' if t_ops > t_bytes else 'bytes'


def inference_phase(smi):
    """Kernels K1-K3 against their plain versions and the inference path.
    Returns ({kernel: entry}, the path's launch counts)."""
    import numpy as np
    import torch
    from hvpr_tpu_torch.models import DatasetMeta, build_network
    from hvpr_tpu_torch.models.backbones_2d.map_to_bev import (
        memory_module, pointpillar_scatter)
    from hvpr_tpu_torch.models.backbones_3d.vfe import pillar_vfe
    from hvpr_tpu_torch.ops import _kernels
    from hvpr_tpu_torch.utils.scans import realistic_scans

    cfg = load_cfg()
    meta = DatasetMeta(cfg.DATA_CONFIG, cfg.CLASS_NAMES)
    net = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), meta, device='cuda')
    seed_weights(net.module, seed=0)
    pcr = meta.point_cloud_range
    points = torch.from_numpy(realistic_scans(np.random.default_rng(0), BATCH,
                                              N_POINTS, pcr)).cuda()
    mask = torch.ones(BATCH, N_POINTS, dtype=torch.bool, device='cuda')

    # capture every wrapper call of one pipeline run (the warm-up)
    calls = capture_calls(
        [(pillar_vfe, 'segment_sweep', 'segment_sweep'),
         (memory_module, 'memory_lookup_fused', 'memory_lookup'),
         (pointpillar_scatter, 'canvas_from_sorted', 'bev_canvas')],
        lambda: net.pipeline(points, mask))
    torch.cuda.synchronize()

    # each kernel against its plain version at the main path's shapes
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
        if name in ('segment_sweep', 'memory_lookup', 'bev_canvas'):
            print(f'{name}: device ms per forward by kernel (torch.profiler): '
                  + device_breakdown(lambda: [fn(*a, **kw) for a, kw in calls[name]]))
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
    b_ms, b_by = bound(ops, BF16_FLOPS_PER_S, nbytes)
    lib_ms = _lookup_library_ms(pill, memw, row_mask, th_k)
    entries['memory_lookup'].update(bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
    print(f'memory_lookup: scaled_dot_product_attention over the valid rows with the '
          f'selected sets as its mask (the function of _apply_kernel only) {lib_ms:.4f} ms')
    k2_ms = entries['memory_lookup']['ms']
    print(f'memory_lookup: K2 {k2_ms:.4f} ms against the SDPA yardstick {lib_ms:.4f} ms: '
          f'{"below" if k2_ms < lib_ms else "NOT below"} it ({k2_ms / lib_ms:.3f}x); bound '
          f'{b_ms:.4f} ms ({b_by}, bf16 tensor cores), on the FP64 tensor cores '
          f'{2.0 * r_valid * m * c / F64_TC_FLOPS_PER_S * 1e3:.4f} ms for the logits')

    # K3's yardstick: zeroing the canvas and index_put_ in one window, as the
    # kernel writes the whole canvas; beside it the earlier yardstick,
    # index_put_ into a canvas zeroed outside the window
    canvas_bytes, lib_ms, put_ms, yardsticks = 0, 0.0, 0.0, []
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

        def zeros_put(b=b, ny=ny, nx=nx, cc=cc, out_dtype=out_dtype, bi=bi, cell=cell,
                      rows=rows):
            torch.zeros(b, ny * nx, cc, dtype=out_dtype, device='cuda').index_put_(
                (bi, cell), rows)
        lib_ms += cuda_ms(zeros_put)
        yardsticks.append(zeros_put)
        canvas = torch.zeros(b, ny * nx, cc, dtype=out_dtype, device='cuda')
        put_ms += cuda_ms(lambda: canvas.index_put_((bi, cell), rows))
        del canvas
    entries['bev_canvas'].update(bound_ms=canvas_bytes / HBM_BYTES_PER_S * 1e3,
                                 bound_by='bytes', library_ms=lib_ms)
    print(f'bev_canvas: torch.zeros + index_put_ {lib_ms:.4f} ms; index_put_ into a '
          f'canvas zeroed outside the window {put_ms:.4f} ms')
    print('bev_canvas: torch.zeros + index_put_, device ms per forward by kernel '
          '(torch.profiler): ' + device_breakdown(lambda: [f() for f in yardsticks]))
    del yardsticks

    # the main path, counts from zero
    _kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = net.pipeline(points, mask)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = _kernels.launch_counts()
    print(f'inference path launches: {launches}')
    for name in INFER_KERNELS:
        if launches[name] == 0:
            fail(f'the inference path launched {name} no time')

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
    return entries, launches


def train_stage_ms(net, batch, reps=3):
    """Median milliseconds of each part of ``Network.train_step``, run as it
    is: forward hooks on the five stages and a wrapper of the optimizer's
    ``step`` record CUDA events, and each part is the device timeline between
    its two events (host gaps included). The parts: the five forward stages
    (the head with its targets and losses), the backward (the head's end to
    the optimizer's start) and the optimizer update with its clip."""
    import torch
    mod = net.module
    opt = net.train_state.optimizer
    stages = [('backbone_3d', mod.backbone_3d), ('vfe', mod.vfe),
              ('map_to_bev', mod.map_to_bev_module),
              ('backbone_2d', mod.backbone_2d), ('dense_head+loss', mod.dense_head)]
    events = {}

    def mark(key):
        events[key] = torch.cuda.Event(enable_timing=True)
        events[key].record()

    handles = []
    for name, stage in stages:
        handles.append(stage.register_forward_pre_hook(
            lambda *_, n=name: mark(n + ':start')))
        handles.append(stage.register_forward_hook(
            lambda *_, n=name: mark(n + ':end')))
    opt_step = opt.step

    def timed_opt_step(grads):
        mark('optimizer:start')
        norm = opt_step(grads)
        mark('optimizer:end')
        return norm

    opt.step = timed_opt_step
    spans = [(n, n + ':start', n + ':end') for n, _ in stages] + [
        ('backward', 'dense_head+loss:end', 'optimizer:start'),
        ('optimizer', 'optimizer:start', 'optimizer:end')]
    times = {name: [] for name, _, _ in spans}
    try:
        for _ in range(reps):
            net.train_step(batch)
            torch.cuda.synchronize()
            for name, start, end in spans:
                times[name].append(events[start].elapsed_time(events[end]))
    finally:
        for h in handles:
            h.remove()
        del opt.step
    return {name: statistics.median(v) for name, v in times.items()}


def ball_stop(idx, cnt, nsample, n):
    """(B, S) points a centre's sweep for one radius needs: up to the first
    hit of its nsample-th bucket, else all ``n``."""
    import torch
    return torch.where(cnt == nsample, idx[..., -1].long() + 1, n)


def ball_bytes(xyz, new_xyz, mask, nsamples):
    """Bytes a ball query moves: points, centres and mask in, idx and cnt
    out for each nsample."""
    b, s = new_xyz.shape[:2]
    return (xyz.numel() + new_xyz.numel()) * 4 + mask.numel() + sum(
        b * s * (ns + 1) * 4 for ns in nsamples)


def _train_bounds(name, calls, plain_outs, selected, recon_nonzero):
    """(bound ms, bound_by, DMMA bound ms or None) of one step's calls of
    train kernel ``name``, from this run's inputs (and, for the ball query,
    the plain results, which say where each centre's sweep may stop; for the
    masked attention, ``selected``: {shared: selected points summed over the
    valid rows}; for K6, ``recon_nonzero``: the nonzero weights n W needs).
    The DMMA bound is the time of the same products on the FP64 tensor
    cores, where the kernel runs them there (K6, K7, K9's dense sweep)."""
    import torch
    from hvpr_tpu_torch.ops.topk_attend import PAIR_CAP
    ops = nbytes = 0.0
    dmma_ops = None
    flops = F32_FLOPS_PER_S
    for (args, _), out in zip(calls, plain_outs):
        if name == 'ball_query':
            # one call a level, both radii: ~8 f32 operations for the
            # distance and a compare a radius, per (centre, point) pair up
            # to the point at which the centre has both radii's nsample
            # distinct buckets (else all N)
            radii, nsamples, xyz, new_xyz, mask = args
            visited = float(torch.stack([ball_stop(idx, cnt, ns, xyz.shape[1])
                                         for (idx, cnt), ns in zip(out, nsamples)])
                            .amax(dim=0).sum())
            ops += (8.0 + len(radii)) * visited
            nbytes += ball_bytes(xyz, new_xyz, mask, nsamples)
        elif name == 'fps_chunks':
            # ~10 f32 operations per row and step (3 sub, 3 mul, 2 add,
            # min, compare)
            pts, valid, nsamp = args
            r, l, _ = pts.shape
            ops += 10.0 * r * l * nsamp
            nbytes += pts.numel() * 4 + valid.numel() + r * nsamp * 4
        elif name.startswith('memory_recon'):
            # products of R x M x C multiply-adds on bf16 tensor cores: the
            # forward's x W^T and n W over the nonzero weights of n (a sparse
            # product), the backward's five dense ones (x W^T, dy W^T, dl W,
            # dl^T x, n^T dy)
            x, w = args[0], args[1]
            r, c = x.shape
            m = w.shape[0]
            if name == 'memory_recon_fwd':
                work = 2.0 * r * m * c + 2.0 * c * recon_nonzero
                nbytes += (2 * r * c + m * c) * 4
            else:
                work = 5 * 2.0 * r * m * c
                nbytes += (3 * r * c + 2 * m * c) * 4
            ops += work
            dmma_ops = (dmma_ops or 0.0) + work
            flops = BF16_FLOPS_PER_S
        else:
            # the dense (R, N) score product s of the R valid rows on bf16
            # tensor cores; K9 and K10 add 2 C flops a selected point for
            # the value product (out, or dval), and where the tables are
            # split 2 C more for its logit l, which only the selected
            # points need; K9's pair pass makes no dense product but for its
            # overflow rows
            pill, table = args[0], args[1]
            b, v, c = pill.shape
            n = table.shape[1]
            row_mask = args[{'bucket_threshold': 4, 'masked_attend_fwd': 6,
                             'masked_attend_pairs': 6, 'masked_attend_bwd': 9}[name]]
            r = float(row_mask.sum())
            io = pill.numel() + table.numel() + b * n + b * v       # in, f32
            outs = b * v * c * 4 + 3 * b * v * 4 + b * v * PAIR_CAP * 6
            if name == 'bucket_threshold':
                ops += 2.0 * r * n * c
                dmma_ops = (dmma_ops or 0.0) + 2.0 * r * n * c
                nbytes += io * 4 + b * v + b * v * 4
                flops = BF16_FLOPS_PER_S
            elif name == 'masked_attend_fwd':         # + out, mx, den, count, pairs
                shared = args[5]
                work = 2.0 * r * n * c + (1 if shared else 2) * 2.0 * c * selected[shared]
                ops += work
                dmma_ops = (dmma_ops or 0.0) + work
                io += 0 if shared else table.numel()
                nbytes += io * 4 + b * v + outs
                flops = BF16_FLOPS_PER_S
            elif name == 'masked_attend_pairs':
                # the selection's count and listed indices in, each selected
                # value row read once
                shared, (sel_cnt, _) = args[5], args[7]
                ovf = float(((sel_cnt > PAIR_CAP) & row_mask).sum())
                listed = float(torch.where((sel_cnt <= PAIR_CAP) & row_mask, sel_cnt, 0).sum())
                per = 1 if shared else 2
                ops += per * 2.0 * c * selected[shared] + per * 2.0 * c * n * ovf
                nbytes += (r * c + args[2].numel() + b * n + b * v * 2) * 4 + b * v \
                    + listed * 4 + outs
                flops = BF16_FLOPS_PER_S
            else:
                # the reduce over the listed pairs: reads the valid rows of
                # dout and the pairs, writes dval; 2 C flops a pair; the
                # overflow rows' scores (and split logits) at every point
                shared, cnt = args[8], args[12]
                n_ovf = float(((cnt > PAIR_CAP) & row_mask).sum())
                listed = float(torch.where((cnt <= PAIR_CAP) & row_mask, cnt, 0).sum())
                ops += 2.0 * c * selected[shared] + (1 if shared else 2) * 2.0 * c * n * n_ovf
                nbytes += r * c * 4 + listed * 6 + b * n * c * 4
                flops = F32_FLOPS_PER_S
    b_ms, b_by = bound(ops, flops, nbytes)
    return b_ms, b_by, None if dmma_ops is None else dmma_ops / F64_TC_FLOPS_PER_S * 1e3


def _kernel_device_ms(fn, kernel):
    """Device milliseconds a call of ``fn()`` spends in the CUDA kernels
    whose names start with ``kernel`` (torch.profiler); nan when the
    profiler records none."""
    ms = [v for k, v in device_times(fn).items() if k.startswith(kernel)]
    return sum(ms) if ms else float('nan')


def _ball_query_detail(calls, plain_outs):
    """K4 per SA level (one call, both radii) and per (level, radius): the
    call's CUDA-event and device times beside its bound, and each radius's
    own bound beside the time of the same kernel for that radius alone
    (``ball_query_bucket``, one radius a sweep; timed only). Returns
    {'device_ms': of the step's calls, 'calls': [per level]}."""
    import torch
    from hvpr_tpu_torch.ops import pn2_select
    levels = []
    for level, ((args, _), out) in enumerate(zip(calls, plain_outs), 1):
        radii, nsamples, xyz, new_xyz, mask = args
        n = xyz.shape[1]
        stops = [ball_stop(idx, cnt, ns, n) for (idx, cnt), ns in zip(out, nsamples)]
        both = float(torch.stack(stops).amax(dim=0).sum())
        b_ms, b_by = bound((8.0 + len(radii)) * both, F32_FLOPS_PER_S,
                           ball_bytes(xyz, new_xyz, mask, nsamples))
        ms = cuda_ms(lambda: pn2_select.ball_query_bucket2(*args))
        dev = _kernel_device_ms(lambda: pn2_select.ball_query_bucket2(*args),
                                'ball_query_kernel')
        print(f'ball_query level {level}: {tuple(xyz.shape)} points, {tuple(new_xyz.shape)} '
              f'centres, radii {radii}, nsample {nsamples}: one call {ms:.4f} ms, device '
              f'{dev:.4f} ms, bound {b_ms:.4f} ms ({b_by}; {both:.4g} pairs needed)')
        per_radius = []
        for r, ns, stop, (_, cnt) in zip(radii, nsamples, stops, out):
            r_ms, r_by = bound(9.0 * float(stop.sum()), F32_FLOPS_PER_S,
                               ball_bytes(xyz, new_xyz, mask, (ns,)))
            alone = cuda_ms(lambda: pn2_select.ball_query_bucket(r, ns, xyz, new_xyz, mask))
            alone_dev = _kernel_device_ms(
                lambda: pn2_select.ball_query_bucket(r, ns, xyz, new_xyz, mask),
                'ball_query_kernel')
            full = float((cnt == ns).float().mean())
            print(f'  level {level}, radius {r}, nsample {ns}: bound {r_ms:.4f} ms ({r_by}; '
                  f'{float(stop.sum()):.4g} pairs needed, {full:.4f} of the centres fill '
                  f'their nsample); this radius alone {alone:.4f} ms, device {alone_dev:.4f}')
            per_radius.append({'radius': r, 'nsample': ns, 'bound_ms': r_ms,
                               'alone_ms': alone, 'alone_device_ms': alone_dev})
        levels.append({'level': level, 'ms': ms, 'device_ms': dev, 'bound_ms': b_ms,
                       'radii': per_radius})
    return {'device_ms': sum(lv['device_ms'] for lv in levels), 'calls': levels}


def _recon_nonzero(calls):
    """K6's nonzero weights: per row of each call, the count of nonzero
    bf16(n) (from the plain attention), printed as a distribution with the
    share of 16-row tiles that take the dense output (a row above the list
    cap, or lam = 0); returns their sum, the work of the sparse n W."""
    import ctypes
    import torch
    from hvpr_tpu_torch.ops import _kernels, memory_recon
    lib = _kernels.library('memory_recon')
    lib.hvpr_memory_recon_fwd_cap.restype = ctypes.c_int
    cap = lib.hvpr_memory_recon_fwd_cap()
    total = 0.0
    for (x, w, lam), _ in calls:
        counts = torch.cat([(memory_recon._attention(xc, w, lam)[3].to(torch.bfloat16) != 0)
                            .sum(dim=1) for xc in x.split(8192)])
        tiles = torch.nn.functional.pad(counts, (0, -len(counts) % 16)).reshape(-1, 16)
        dense = (tiles > cap).any(dim=1) if lam > 0 else torch.ones(len(tiles), dtype=bool)
        total += float(counts.sum())
        q = torch.quantile(counts.float(), torch.tensor([0.5, 0.99], device=counts.device))
        print(f'memory_recon_fwd: nonzero weights a row (lam {lam}, list cap {cap}) mean '
              f'{float(counts.float().mean()):.3f}, median {float(q[0]):.0f}, 99th '
              f'percentile {float(q[1]):.0f}, max {int(counts.max())}; rows with none '
              f'{float((counts == 0).float().mean()):.4f}; tiles on the dense output '
              f'{float(dense.float().mean()):.4f} of {len(tiles)}')
    return total


def _recon_parts(calls):
    """'sweep ms, row chain ms, output ms': device times of K6 run to the end
    of its sweep, of its row chain, and whole (hvpr_memory_recon_fwd_part),
    the differences of their torch.profiler device times. Launched by the
    library entry, not the wrapper: these launches count for no path."""
    import ctypes
    import torch
    from hvpr_tpu_torch.ops import _kernels
    fn = _kernels.library('memory_recon').hvpr_memory_recon_fwd_part
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int,
                                                                ctypes.c_void_p]
    fn.restype = ctypes.c_int
    times = []
    for stop in (1, 2, 0):
        def run(stop=stop):
            for (x, w, lam), _ in calls:
                xb = x.to(torch.bfloat16).contiguous()
                wb = w.to(torch.bfloat16).contiguous()
                y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
                if fn(_kernels.ptr(xb), _kernels.ptr(wb), _kernels.ptr(y), x.shape[0],
                      w.shape[0], x.shape[1], float(lam), stop, _kernels.stream_handle(x)):
                    fail('memory_recon_fwd: a part run failed to launch')
        got = device_breakdown(run)
        ms = [float(p.split()[-1]) for p in got.split(', ') if p.startswith('recon_fwd_kernel')]
        times.append(ms[0] if ms else float('nan'))
    sweep, chain, whole = times
    return (f'sweep {sweep:.4f}, row chain {chain - sweep:.4f}, output {whole - chain:.4f} '
            f'(whole {whole:.4f})')


def _attend_library_ms(calls):
    """CUDA-event ms of scaled_dot_product_attention (bf16, scale 1) over the
    same work as each masked-attention forward call: per scan, the pillar
    rows inside the row mask as queries and the boolean mask of the points
    they select (``topk_attend.selection``), gathered outside the timed
    window; summed over the scans and calls. Timed only; the port never
    calls it."""
    import torch
    import torch.nn.functional as F
    from hvpr_tpu_torch.ops import topk_attend
    total = 0.0
    for args, _ in calls:
        pill, sel, val, neg, th, shared, row_mask = args[:7]
        kv_all = (sel if shared else val).to(torch.bfloat16)
        for bi, rows, sel_mask in topk_attend.selection(pill, sel, neg, th, row_mask):
            q = pill[bi, rows].to(torch.bfloat16)[None]
            kv, mask = kv_all[bi][None], sel_mask[None]
            total += cuda_ms(lambda: F.scaled_dot_product_attention(
                q, kv, kv, attn_mask=mask, scale=1.0), reps=5, warmup=1)
            del q, kv, mask, sel_mask
    return total


def _lookup_library_ms(pill, memw, row_mask, thresh):
    """CUDA-event ms of scaled_dot_product_attention (bf16, scale 1) over the
    function of K2's ``_apply_kernel``: per scan, the valid pillar rows as
    queries, the memory as keys and values, and as mask the columns whose
    logit (exact bf16 products, as K2 computes them) is at or above the row's
    threshold, built outside the timed window; summed over the scans. Timed
    only; the port never calls it."""
    import torch
    import torch.nn.functional as F
    mem_bf = memw.to(torch.bfloat16)
    v = pill.shape[0] // BATCH
    total = 0.0
    for bi in range(BATCH):
        rows = bi * v + torch.nonzero(row_mask[bi * v:(bi + 1) * v]).squeeze(1)
        q = pill[rows].to(torch.bfloat16)
        logits = (q.double() @ mem_bf.double().t()).float()
        mask = (logits >= thresh[rows, None])[None]
        del logits
        q, kv = q[None], mem_bf[None]
        total += cuda_ms(lambda: F.scaled_dot_product_attention(
            q, kv, kv, attn_mask=mask, scale=1.0), reps=5, warmup=1)
        del q, mask
    return total


# float outputs that must equal the plain version's exactly: K8's thresholds,
# K9's row maxima and pair weights (and every integer output: counts, pair
# indices); the rest within RECON_RTOL
EXACT_OUTPUTS = {'bucket_threshold': (0,), 'masked_attend_fwd': (1, 5),
                 'masked_attend_pairs': (1, 5)}


def train_phase(smi, mode):
    """One train step of hvpr.yaml at batch 4 in TRAIN_ATTEND_MODE ``mode``
    through the kernels against one through the plain versions, and the
    timed steps. In the shipped mode, fused, also each train kernel (K4-K10)
    against its plain version at the step's shapes and the part times.
    Returns ({kernel: entry}, the timed steps' launch counts, the kernel
    step's metrics, the step's ``pointnet2.three_nn`` calls)."""
    import numpy as np
    import torch
    from hvpr_tpu_torch.models import DatasetMeta, build_network
    from hvpr_tpu_torch.models.backbones_2d.map_to_bev import pointpillar_scatter
    from hvpr_tpu_torch.ops import (_kernels, memory_recon, pn2_select, pointnet2,
                                    topk_attend)
    from hvpr_tpu_torch.parallel import loss_and_grads
    from hvpr_tpu_torch.utils.scans import realistic_scans_with_boxes

    fused = mode == 'fused'
    # hvpr.yaml sets no TRAIN_ATTEND_MODE: as shipped it trains fused
    cfg = load_cfg(None if fused else mode)
    meta = DatasetMeta(cfg.DATA_CONFIG, cfg.CLASS_NAMES, mode='train')
    net = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), meta, device='cuda',
                        train=True)
    if net.module.map_to_bev_module.train_attend_mode != mode:
        fail(f'the train network runs {net.module.map_to_bev_module.train_attend_mode}, '
             f'expected {mode}')
    seed_weights(net.module, seed=0)
    pts, gt = realistic_scans_with_boxes(np.random.default_rng(0), TRAIN_BATCH,
                                         N_POINTS, meta.point_cloud_range)
    points = torch.from_numpy(pts).cuda()
    mask = torch.ones(TRAIN_BATCH, N_POINTS, dtype=torch.bool, device='cuda')
    batch = dict(net.voxelize(points, mask), gt_boxes=torch.from_numpy(gt).cuda())
    print(f'train batch ({mode}): {TRAIN_BATCH} scans, '
          f'{int(batch["voxel_mask"].sum())} pillars, {gt.shape[1]} boxes a scan')
    state0 = {k: v.clone() for k, v in net.module.state_dict().items()}
    n_params = sum(p.numel() for p in net.module.parameters())
    step_launches = {k: n for k, n in STEP_LAUNCHES.items() if fused or k not in ATTEND_KERNELS}
    wrappers = {'ball_query': (pointnet2, 'ball_query_bucket2', pn2_select.ball_query_bucket2),
                'fps_chunks': (pointnet2, 'fps_chunks', pn2_select.fps_chunks),
                'memory_recon_fwd': (memory_recon, 'recon_forward', memory_recon.recon_forward),
                'memory_recon_bwd': (memory_recon, 'recon_backward',
                                     memory_recon.recon_backward),
                'bucket_threshold': (pointpillar_scatter, 'bucket_threshold',
                                     topk_attend.bucket_threshold),
                'masked_attend_fwd': (topk_attend, 'masked_attend_fwd',
                                      topk_attend.masked_attend_fwd),
                # the same wrapper; its calls that carry a selection
                'masked_attend_pairs': (None, None, topk_attend.masked_attend_fwd),
                'masked_attend_bwd': (topk_attend, 'masked_attend_bwd',
                                      topk_attend.masked_attend_bwd)}
    wrappers = {k: w for k, w in wrappers.items() if k in step_launches}

    def fresh():
        net.module.load_state_dict(state0)
        net.init_training(cfg.OPTIMIZATION, TOTAL_STEPS)

    # 1-2. one step through the kernels, every train kernel's wrapper call
    # captured, and the same step from the same state through the plain
    # versions, under torch's deterministic algorithms. Without them the
    # backward's gathers sum by atomics in run order and two plain steps
    # differ by some percent in a point-stream gradient (its bf16 BN
    # backwards amplify the noise; printed below); with them two plain steps
    # are bit-identical, and the kernels equal their plain versions, so the
    # kernel step must equal the plain step to the bit: each gradient leaf
    # (before the optimizer), each loss term, grad_norm, and each updated
    # weight and BN statistic.
    runs = {}
    torch.use_deterministic_algorithms(True)
    try:
        for run in ('kernels', 'plain'):
            with contextlib.ExitStack() as stack:
                if run == 'plain':
                    stack.enter_context(_kernels.plain_versions())
                fresh()
                _, grads = loss_and_grads(net.train_state, batch)
                fresh()
                if run == 'kernels':
                    out = []
                    # and the FP modules' exact 3-NN, whose inputs K11 takes
                    calls = capture_calls(
                        [(mod, attr, name) for name, (mod, attr, _) in wrappers.items()
                         if mod is not None]
                        + [(pointnet2, 'three_nn', 'three_nn')],
                        lambda: out.append(net.train_step(batch)))
                    metrics = out[0]
                else:
                    metrics = net.train_step(batch)
            runs[run] = (grads, {k: float(v) for k, v in metrics.items()},
                         {k: v.clone() for k, v in net.module.state_dict().items()})
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    (grads_k, metrics_k, params_k), (grads_p, metrics_p, params_p) = \
        runs['kernels'], runs['plain']
    print(f'step 1 ({mode}), kernels/plain: ' + ', '.join(
        f'{k} {metrics_k[k]:.7g}/{metrics_p[k]:.7g}' for k in sorted(metrics_k)))
    for k, v in metrics_k.items():
        if not np.isfinite(v):
            fail(f'train step {k} is not finite')
    names = [n for n, _ in net.module.named_parameters()]
    differ = ([n for n, g, w in zip(names, grads_k, grads_p) if not torch.equal(g, w)]
              + [k for k in params_p if not torch.equal(params_k[k], params_p[k])]
              + [k for k in metrics_p if metrics_k[k] != metrics_p[k]])
    print(f'step 1 ({mode}), kernels vs plain: {len(names)} gradient leaves, '
          f'{len(params_p)} weight and statistic tensors, {len(metrics_p)} metrics; '
          f'{len(differ)} differ')
    if differ:
        fail(f'the {mode} kernel step differs from the plain step in {differ[:5]}')
    if fused:
        # K9's calls: the dense sweep's (no selection), the pair pass's
        fwd = calls.pop('masked_attend_fwd', [])
        calls['masked_attend_fwd'] = [cl for cl in fwd if cl[0][7] is None]
        calls['masked_attend_pairs'] = [cl for cl in fwd if cl[0][7] is not None]
        del fwd                 # the captures are freed with `calls` below
    for name, per_step in step_launches.items():
        if len(calls.get(name, ())) != per_step:
            fail(f'one {mode} train step called {name} {len(calls.get(name, ()))} '
                 f'times, expected {per_step}')
    del runs, grads_k, grads_p, params_k, params_p

    entries = {}
    if fused:
        # what deterministic mode removes: two plain steps' gradients without it
        noisy = []
        for _ in range(2):
            fresh()
            with _kernels.plain_versions():
                noisy.append(loss_and_grads(net.train_state, batch)[1])
        rel = {n: float(torch.linalg.vector_norm((a - b).double())
                        / torch.linalg.vector_norm(b.double()).clamp_min(1e-30))
               for n, a, b in zip(names, *noisy)}
        worst = max(rel, key=rel.get)
        print(f'without deterministic algorithms two plain steps differ in '
              f'{sum(v > 0 for v in rel.values())} of {len(rel)} gradient leaves, '
              f'most in {worst}: {rel[worst]:.3g} of its L2 norm')
        del noisy

        # 3. each kernel against its plain version at this step's shapes
        outs = {}
        for name, (_, _, fn) in wrappers.items():
            err = ms = plain_ms = 0.0
            plain_outs = []
            for args, kwargs in calls[name]:
                got = fn(*args, **kwargs)
                with _kernels.plain_versions():
                    want = fn(*args, **kwargs)
                torch.cuda.synchronize()
                plain_outs.append(want)
                # K4's two radii: ((idx, cnt), (idx, cnt))
                got, want = flat(got), flat(want)
                for i, (g, w) in enumerate(zip(got, want)):
                    if g.shape != w.shape or g.dtype != w.dtype:
                        fail(f'{name}: {g.shape}/{g.dtype} vs plain {w.shape}/{w.dtype}')
                    if not torch.isfinite(g.float()).all():
                        fail(f'{name}: non-finite output')
                    e = float((g.double() - w.double()).abs().max())
                    err = max(err, e)
                    if w.is_floating_point() and i not in EXACT_OUTPUTS.get(name, ()):
                        if e > RECON_RTOL * float(w.abs().max()):
                            fail(f'{name}: kernel differs from plain by {e} '
                                 f'(largest |plain| {float(w.abs().max())})')
                    elif e != 0.0:
                        fail(f'{name}: kernel output {i} differs from plain by {e}')
                ms += cuda_ms(lambda: fn(*args, **kwargs), reps=10, warmup=2)
                with _kernels.plain_versions():
                    plain_ms += cuda_ms(lambda: fn(*args, **kwargs), reps=3, warmup=1)
            outs[name] = plain_outs
            entries[name] = {'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
                             'library_ms': None}
            shapes = [tuple(tuple(a.shape) for a in args if isinstance(a, torch.Tensor))
                      for args, _ in calls[name]]
            print(f'{name}: {len(calls[name])} call(s) per step at {shapes}, max_abs_err '
                  f'{err}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms')
            if name in ('memory_recon_bwd', 'masked_attend_bwd'):
                print(f'{name}: device ms per step by kernel (torch.profiler): '
                      + device_breakdown(lambda: [fn(*a, **kw) for a, kw in calls[name]]))
            if name == 'memory_recon_fwd':
                print('memory_recon_fwd: device ms per step (torch.profiler) of K6 run to '
                      'the end of its sweep, of its row chain, and whole: '
                      + _recon_parts(calls[name]))
            if name == 'masked_attend_pairs':
                # the pair pass on the shared call's selection against the
                # plain version that recomputes the selection: the same bits
                for (args, kwargs), want in zip(calls[name], plain_outs):
                    got = fn(*args, **kwargs)
                    with _kernels.plain_versions():
                        fresh_sel = fn(*args[:7])
                    torch.cuda.synchronize()
                    for i, (g, w) in enumerate(zip(got, fresh_sel)):
                        e = float((g.double() - w.double()).abs().max())
                        if (e != 0.0 if i != 0 and i != 2
                                else e > RECON_RTOL * float(w.abs().max())):
                            fail(f'{name}: output {i} differs from the plain version that '
                                 f'recomputes the selection by {e}')
                    print(f'{name}: against the plain version that recomputes the '
                          f'selection: cnt, mx and pairs equal, out/den max_abs_err '
                          f'{float((got[0] - fresh_sel[0]).abs().max())}/'
                          f'{float((got[2] - fresh_sel[2]).abs().max())}')
                    del got, fresh_sel
                print('masked_attend: device ms per step by kernel, the dense sweep and '
                      'the pair pass (torch.profiler): ' + device_breakdown(
                          lambda: [fn(*a, **kw) for key in ('masked_attend_fwd', name)
                                   for a, kw in calls[key]]))
            if name == 'masked_attend_bwd':
                # K10 reduces K9's pairs; the dense plain version recomputes
                # every row's scores and weights: the oracle of both
                for (args, kwargs), want in zip(calls[name], plain_outs):
                    got = fn(*args, **kwargs)
                    oracle = topk_attend.masked_attend_bwd_plain(*args[:10])
                    torch.cuda.synchronize()
                    scale = float(oracle.abs().max())
                    e_k, e_p = (float((x - oracle).abs().max()) for x in (got, want))
                    print(f'{name}: against the dense oracle, kernel {e_k}, plain (pairs) '
                          f'{e_p}, largest |dval| {scale}')
                    if max(e_k, e_p) > RECON_RTOL * scale:
                        fail(f'{name}: differs from the dense oracle by {max(e_k, e_p)}')
                    del got, oracle

        # the selected sets: points per valid pillar row, per K9 call
        selected = {}
        for (args, _), fwd_out in zip(calls['masked_attend_fwd'] + calls['masked_attend_pairs'],
                                      outs['masked_attend_fwd'] + outs['masked_attend_pairs']):
            shared, row_mask = args[5], args[6]
            cnt, pidx = fwd_out[3], fwd_out[4]
            c = cnt[row_mask].float()
            selected[shared] = float(c.sum())
            # the pairs K10 reduces: per point, the rows that list it
            b_, v_, _ = pidx.shape
            n_ = args[1].shape[1]
            keys = (pidx.long() + n_ * torch.arange(b_, device=pidx.device)[:, None, None])
            per_point = torch.bincount(keys[pidx >= 0], minlength=b_ * n_)
            print(f'masked_attend ({"shared" if shared else "split"}): selected points per '
                  f'valid pillar mean {c.mean().item():.3f} (k={cfg.MODEL.MAP_TO_BEV.NUM_K}), '
                  f'min {int(c.min())}, max {int(c.max())}, over {c.numel()} rows; '
                  f'rows above the 128-point list (overflow rows): {int((c > 128).sum())}; '
                  f'{int(per_point.sum())} listed pairs, rows per point mean '
                  f'{float(per_point.float().mean()):.3f}, max {int(per_point.max())}; '
                  f'pair buffers {b_ * v_ * topk_attend.PAIR_CAP * 6 / 2**20:.1f} MiB a call')
            del keys, per_point
        recon_nonzero = _recon_nonzero(calls['memory_recon_fwd'])
        for name in wrappers:
            b_ms, b_by, dmma_ms = _train_bounds(name, calls[name], outs[name], selected,
                                                recon_nonzero)
            entries[name].update(bound_ms=b_ms, bound_by=b_by)
            on_dmma = '' if dmma_ms is None else \
                f'; its products on the FP64 tensor cores (DMMA) {dmma_ms:.4f} ms'
            print(f'{name}: bound {b_ms:.4f} ms ({b_by}){on_dmma}')
            if dmma_ms is not None:
                entries[name]['dmma_bound_ms'] = dmma_ms
        entries['ball_query'].update(_ball_query_detail(calls['ball_query'],
                                                        outs['ball_query']))
        k8 = calls['bucket_threshold']
        entries['bucket_threshold']['device_ms'] = _kernel_device_ms(
            lambda: [topk_attend.bucket_threshold(*a, **kw) for a, kw in k8],
            'bucket_threshold_kernel')
        print(f'bucket_threshold: {len(k8)} call(s) a step, CUDA events '
              f'{entries["bucket_threshold"]["ms"]:.4f} ms, device '
              f'{entries["bucket_threshold"]["device_ms"]:.4f} ms (torch.profiler)')
        for name in ('masked_attend_fwd', 'masked_attend_pairs'):
            entries[name]['library_ms'] = _attend_library_ms(calls[name])
            print(f'{name}: scaled_dot_product_attention over the same valid rows and '
                  f'selected sets {entries[name]["library_ms"]:.4f} ms')
        del outs

    # 4. the main path: the timed steps, counts from zero. The captured
    # inputs are the check's, not the step's: they are freed first, so that
    # the peak below is the step's own (this script used to hold them through
    # the timed steps: the figure counted that way is printed beside it)
    def nbytes(tensors):
        return sum(t.numel() * t.element_size() for t in tensors
                   if isinstance(t, torch.Tensor))
    held = nbytes(a for key, cs in calls.items() if key != 'three_nn'
                  for args, _ in cs for a in args)
    held_pairs = nbytes(a for args, _ in calls.get('masked_attend_bwd', ())
                        for a in args[10:])
    calls = {'three_nn': calls.get('three_nn', [])}
    n_steps = TRAIN_STEPS if fused else GATHER_STEPS
    fresh()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    times, losses = [], []
    for _ in range(n_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = net.train_step(batch)
        loss = float(metrics['loss'])           # synchronizes
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
    launches = _kernels.launch_counts()
    print(f'train path ({mode}) launches in {n_steps} steps: {launches}')
    for name in _kernels.KERNELS:
        want = step_launches.get(name, 0) * n_steps
        if launches[name] != want:
            fail(f'{n_steps} {mode} train steps launched {name} {launches[name]} '
                 f'times, expected {want}')
    if not all(np.isfinite(losses)):
        fail(f'non-finite train loss: {losses}')
    step_s = statistics.median(times)
    print(f'train losses ({mode}) over {n_steps} steps: {losses}')
    peak = torch.cuda.max_memory_allocated()
    print(f'train step ({mode}): median of {n_steps} {step_s * 1e3:.3f} ms per batch of '
          f'{TRAIN_BATCH} -> {TRAIN_BATCH / step_s:.3f} scans/s, peak memory '
          f'{peak / 2**30:.3f} GiB ({(peak + held - held_pairs) / 2**30:.3f} GiB with the '
          f'captured inputs held, as counted before; those held {held / 2**30:.3f} GiB, '
          f'{held_pairs / 2**30:.3f} of it K10\'s pairs), {n_params} parameters, on {smi}')
    if fused:
        stages = train_stage_ms(net, batch)
        print(f'train step ({mode}) stage ms (median of 3, CUDA events inside '
              'Network.train_step): '
              + ', '.join(f'{k} {v:.3f}' for k, v in stages.items())
              + f'; sum {sum(stages.values()):.3f}')
    return entries, launches, metrics_k, calls['three_nn']


def three_nn_phase(calls):
    """K11, the bucketed 3-NN, on the inputs of the FP modules' exact 3-NN in
    one fused train step (no path of the model calls it, as no path of the
    JAX package does): held against its plain version (indices and distances
    equal), timed, and driven as its own path with the counts from zero.
    Returns ({'three_nn_bucket': entry}, that path's launch counts)."""
    import torch
    from hvpr_tpu_torch.ops import _kernels, pn2_select, pointnet2

    if len(calls) != 2:
        fail(f'one fused train step called three_nn {len(calls)} times, expected 2')
    fn = pn2_select.three_nn_bucket
    err = ms = plain_ms = 0.0
    ops = nbytes = 0.0
    for (unknown, known, known_mask), _ in calls:
        (dist, idx) = fn(unknown, known, known_mask)
        with _kernels.plain_versions():
            (dist_p, idx_p) = fn(unknown, known, known_mask)
        torch.cuda.synchronize()
        if not (torch.equal(idx, idx_p) and torch.equal(dist, dist_p)):
            fail(f'three_nn_bucket differs from its plain version at {tuple(unknown.shape)} '
                 f'x {tuple(known.shape)}: {int((idx != idx_p).sum())} indices, max '
                 f'distance diff {float((dist - dist_p).abs().max())}')
        if not torch.isfinite(dist).all():
            fail('three_nn_bucket: non-finite distances')
        err = max(err, float((dist - dist_p).abs().max()))
        ms += cuda_ms(lambda: fn(unknown, known, known_mask))
        with _kernels.plain_versions():
            plain_ms += cuda_ms(lambda: fn(unknown, known, known_mask), reps=3, warmup=1)
        # for information: unknown points whose bucket 3-NN set is the exact set
        _, idx_x = pointnet2.three_nn(unknown, known, known_mask)
        same = (torch.sort(idx.long(), dim=-1).values
                == torch.sort(idx_x, dim=-1).values).all(dim=-1)
        b, n, _ = unknown.shape
        s = known.shape[1]
        print(f'three_nn_bucket: {tuple(unknown.shape)} x {tuple(known.shape)}, indices and '
              f'distances equal to plain; bucket set = exact three_nn set for '
              f'{float(same.float().mean()):.4f} of the unknown points')
        # ~10 f32 operations per (unknown, known) pair; inputs and outputs once
        ops += 10.0 * b * n * s
        nbytes += (unknown.numel() + known.numel()) * 4 + known_mask.numel() + b * n * 3 * 8
    b_ms, b_by = bound(ops, F32_FLOPS_PER_S, nbytes)
    print(f'three_nn_bucket: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms for both calls, '
          f'bound {b_ms:.4f} ms ({b_by})')

    # its path: both calls, counts from zero
    _kernels.reset_launch_counts()
    for (unknown, known, known_mask), _ in calls:
        fn(unknown, known, known_mask)
    torch.cuda.synchronize()
    launches = _kernels.launch_counts()
    if launches['three_nn_bucket'] != len(calls):
        fail(f'the three_nn_bucket path launched K11 {launches["three_nn_bucket"]} times')
    return {'three_nn_bucket': {'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
                                'bound_ms': b_ms, 'bound_by': b_by,
                                'library_ms': None}}, launches


def exact_fps_phase(smi):
    """K5's long path: exact FPS, ``furthest_point_sample(num_chunks=1)``,
    over the 4 whole scans of the fused train batch (16,384 points a set),
    hvpr.yaml's SA1 npoint, held against its plain version (indices equal),
    timed, and driven as its own path with the counts from zero. Returns
    ({'ms', 'plain_ms', 'bound_ms', 'launches'}, that path's launch counts)."""
    import numpy as np
    import torch
    from hvpr_tpu_torch.models import DatasetMeta
    from hvpr_tpu_torch.ops import _kernels, pointnet2
    from hvpr_tpu_torch.utils.scans import realistic_scans_with_boxes

    cfg = load_cfg()
    meta = DatasetMeta(cfg.DATA_CONFIG, cfg.CLASS_NAMES, mode='train')
    pts, _ = realistic_scans_with_boxes(np.random.default_rng(0), TRAIN_BATCH, N_POINTS,
                                        meta.point_cloud_range)
    xyz = torch.from_numpy(np.ascontiguousarray(pts[..., :3])).cuda()
    mask = torch.ones(TRAIN_BATCH, N_POINTS, dtype=torch.bool, device='cuda')

    def run():
        return pointnet2.furthest_point_sample(xyz, mask, EXACT_FPS_NPOINT, num_chunks=1)
    got = run()
    with _kernels.plain_versions():
        want = run()
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail(f'exact FPS differs from its plain version in {int((got != want).sum())} '
             f'indices')
    if got.shape != (TRAIN_BATCH, EXACT_FPS_NPOINT) or any(
            len(set(row.tolist())) != EXACT_FPS_NPOINT for row in got):
        fail('exact FPS: wrong shape or a repeated index')
    ms = cuda_ms(run, reps=10, warmup=2)
    with _kernels.plain_versions():
        plain_ms = cuda_ms(run, reps=1, warmup=0)
    # ~10 f32 operations per row and step; the real bound is the chain of
    # npoint dependent steps
    b_ms, b_by = bound(10.0 * TRAIN_BATCH * N_POINTS * EXACT_FPS_NPOINT, F32_FLOPS_PER_S,
                       xyz.numel() * 4 + mask.numel() + TRAIN_BATCH * EXACT_FPS_NPOINT * 4)
    _kernels.reset_launch_counts()
    run()
    torch.cuda.synchronize()
    launches = _kernels.launch_counts()
    if launches['fps_chunks'] != 1 or sum(launches.values()) != 1:
        fail(f'the exact FPS path launched {launches}, expected K5 once')
    print(f'exact FPS (K5 long path): ({TRAIN_BATCH}, {N_POINTS}) -> {EXACT_FPS_NPOINT}, '
          f'equal to plain, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms '
          f'({b_by}; latency: {EXACT_FPS_NPOINT} dependent steps), on {smi}')
    return {'ms': ms, 'plain_ms': plain_ms, 'bound_ms': b_ms, 'launches': 1}, launches


def main():
    import torch

    if not torch.cuda.is_available():
        print('chip_smoke: torch sees no CUDA device', file=sys.stderr)
        return 2
    # cuBLAS is deterministic only with a fixed workspace, set before its
    # first use (the train phase compares steps under deterministic mode)
    os.environ.setdefault('CUBLAS_WORKSPACE_CONFIG', ':4096:8')
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)      # the configs' _BASE_CONFIG_ paths are repo-relative
    from hvpr_tpu_torch.ops import _kernels

    # fp32 convs and matmuls in full f32 (no TF32), deterministic cuDNN:
    # the kernel and plain runs below must differ only by the kernels
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False

    # build
    t0 = time.perf_counter()
    report = _kernels.build_all()
    print(f'build: {time.perf_counter() - t0:.2f} s for {sorted(report)}')
    for name, rep in sorted(report.items()):
        for line in rep['log'].splitlines():
            if any(w in line for w in ('registers', 'spill', 'smem', 'error', 'warning')):
                print(f'  {name}: {line.strip()}')

    # the card
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()[0]
    print(f'card: {smi}')

    t0 = time.perf_counter()
    entries, launches = inference_phase(smi)
    print(f'inference phase: {time.perf_counter() - t0:.1f} s')
    t0 = time.perf_counter()
    train_entries, train_launches, fused_metrics, nn_calls = train_phase(smi, 'fused')
    print(f'train phase (fused, as shipped): {time.perf_counter() - t0:.1f} s')
    t0 = time.perf_counter()
    nn_entries, nn_launches = three_nn_phase(nn_calls)
    del nn_calls
    print(f'three_nn phase: {time.perf_counter() - t0:.1f} s')
    t0 = time.perf_counter()
    exact_fps, _ = exact_fps_phase(smi)
    print(f'exact FPS phase: {time.perf_counter() - t0:.1f} s')
    t0 = time.perf_counter()
    _, _, gather_metrics, _ = train_phase(smi, 'gather')
    print(f'train phase (gather): {time.perf_counter() - t0:.1f} s')
    # for information: the fused selection is a superset of the exact top-k,
    # so the two modes' losses differ from the same state
    print('step 1 from the same state, fused - gather: ' + ', '.join(
        f'{k} {fused_metrics[k] - gather_metrics[k]:.6g}' for k in sorted(fused_metrics)))
    entries.update(train_entries)
    entries.update(nn_entries)
    launches.update({k: train_launches[k] for k in STEP_LAUNCHES})
    launches['three_nn_bucket'] = nn_launches['three_nn_bucket']

    kernels = []
    for name in _kernels.KERNELS:
        e = entries[name]
        kernels.append({'name': name, 'route': 'cuda', 'source': META[name][0],
                        'replaces': META[name][1], 'launches': launches[name],
                        'max_abs_err': e['max_abs_err'], 'ms': e['ms'],
                        'plain_ms': e['plain_ms'], 'bound_ms': e['bound_ms'],
                        'bound_by': e['bound_by'], 'library_ms': e['library_ms']})
        for extra in ('dmma_bound_ms', 'device_ms', 'calls'):
            if extra in e:
                kernels[-1][extra] = e[extra]
        if name == 'fps_chunks':
            kernels[-1]['exact_fps'] = exact_fps
    print(json.dumps({'kernels': kernels}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
