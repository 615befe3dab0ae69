#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``hvpr_tpu_torch/csrc`` into
``build/`` (one nvcc per source, all at once), then drives the paths of
the four shipped model configs at full width on seeded scans with seeded
random weights, ``tools/cfgs/kitti_models/hvpr.yaml`` first:

- inference, batch 8: voxelize -> PillarVFE_Scale -> memory scatter -> scale
  BEV backbone -> anchor head -> rotated NMS. Each inference kernel (K1-K3,
  and K13, the NMS's rotated IoU) is held against its plain PyTorch
  version at the shapes the path gives it, the path must launch each of
  them, and its detections must equal those of the same pipeline through
  the plain versions. K13 at the NMS's 4,096 x 4,096 planes: its
  CUDA-event time, its bound (the planes' bytes), the plain time and the
  share of pairs it clipped in full (``nms.iou_clipped``). Every other
  phase holds the other kernels to their counts; K13 runs wherever boxes
  meet (each NMS, the recall, the rotated assigners).
- multiclass: ``hvpr_multiclass.yaml`` (Car, Pedestrian, Cyclist; one
  rotated NMS a class; f32) through the same pipeline at batch 8 (K1-K3
  against their plain versions, the detections against the plain
  pipeline's bit for bit, the candidates of each class above SCORE_THRESH
  and the post-processing time printed), then its fused train step at
  batch 4 through the train phase's checks below (K4-K10 against their
  plain versions, the kernel step equal to a plain step bit for bit under
  deterministic algorithms, two kernel steps without them equal).
- pointpillar: ``pointpillar.yaml`` (no point stream, no memory) through the
  pipeline at batch 8 (K1 and K3 only, held as above; the stage medians),
  then 3 train steps at batch 4, which must launch no kernel (the plain
  sweeps and scatter under autograd, as in the JAX package), with their
  peak memory.
- nuscenes: ``pointpillar_nuscenes.yaml`` on a synthetic nuScenes tree by
  ``utils.scans.build_nuscenes_root`` (10 sweeps of 34,000 points a
  sample, 5 classes): the pipeline at batch 4 on the data layer's frames
  (K1 at max_seg 20 and K3 at 512 x 512 x 64 held to their plain versions,
  with their bounds and K3's yardstick), then the test CLI (padded, 4
  workers, ``--save_to_file``: annos, one submission file a frame, the
  centre-distance AP string) and the train CLI (one epoch, then its
  evaluation), neither launching a kernel.
- eval_cli: the evaluation entry point ``python -m hvpr_tpu_torch.tools.test``
  (its ``main``) at batch 8 on a synthetic KITTI tree of 16 val scenes with
  its infos and a ``.pth`` of seeded random weights, all written by the
  port: host-voxelized padded pillars, 2 batches, ``result.pkl``, KITTI
  ``.txt`` files and the official AP. It must launch K2 once a batch and no
  other kernel, give the same annos through the plain versions, and on the
  first batch detections that agree with the flat device path's on the
  same points (scores 2e-4, boxes 2e-3); the loop's scans/s and DataLoader
  wait share (whole, and past the first batch), forward median and
  evaluator seconds are printed. ``tools/torch_port/eval_times.py`` times
  the loop over more scenes and the two layouts' stages.
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
  and updated weight), two kernel steps without them must give the same
  gradients bit for bit (K12, the row gathers' backward, sums in a fixed
  order, and equals its plain version on the CPU bit for bit), and 5 more
  steps must launch each kernel its expected number of times; the step's
  peak memory is read with the captured inputs freed.
- the bucketed 3-NN (K11), which no path of the model calls (the FP modules
  keep the exact 3-NN, as in the JAX package): on the inputs of the two
  ``pointnet2.three_nn`` calls of one fused step it must equal its plain
  version (indices and distances) and launch once a call; the share of
  points whose bucket set is the exact set is printed.
- exact FPS (``furthest_point_sample(num_chunks=1)``, K5's long path) over
  the fused batch's 4 whole scans of 16,384 points, npoint 4096: equal to
  its plain version, timed, one launch.
- training in ``TRAIN_ATTEND_MODE: gather``: the kernel step must equal the
  plain step as above, two kernel steps without deterministic algorithms
  must give the same bits (the pooling's and the memory path's gathers
  take K12's backward too), and 2 timed steps must launch K4-K7 and K12
  (13 times a step) and never K8-K10. The fused and ATSS phases print
  K12's set-up/kernel split at their calls (``k12_split``: wall, host
  issue, device ms by kernel) and K12's share of the step (``k12_share``).
- train_cli: the training entry point ``python -m hvpr_tpu_torch.tools.train``
  (its ``main``) at batch 4 with ``--fix_random_seed`` on a synthetic KITTI
  tree of 16 train and 8 val scenes with its infos and gt database, all
  written by the port (hvpr.yaml's gt sampling names no class of
  CLASS_NAMES, so nothing is pasted, as in the JAX package): 2 epochs of
  augmented, host-voxelized padded batches and the post-train evaluation
  of the last checkpoints, then ``--epochs 3`` with the same tag, which
  must resume from ``checkpoint_epoch_2.pth`` (epoch 2, it 8, the OneCycle
  lr of step 8), then the 2 epochs again through the plain versions. Each
  step must launch K4-K10 as above and the evaluation K2 once a batch,
  never K1, K3 or K11; the checkpoints must hold the optimizer state and
  it = 4, 8, 12; the kernel run's ``checkpoint_epoch_2.pth`` must equal the
  plain run's bit for bit (weights, BN statistics, AdamW state, count);
  the evaluation must write 8 annos with the Car AP keys. The loop's
  scans/s and DataLoader wait share (whole, and past the first batch), the
  step's median (CUDA events) and the peak device memory are printed.
- ddp: data-parallel training and evaluation over 2 processes, spawned
  ranks that share the one card over gloo (they measure correctness and
  the exchange's overhead, not scaling): (a) the fused batch's 4 scans as
  2 + 2, 2 steps from seed_weights, against one process's 2 steps on the
  4 (loss terms and grad_norm rtol 1e-4; after the first step 99% of the
  weights within 1e-6 relative, after the second 90% within 0.1 lr, the
  tolerances of tests/test_torch_port_train_step.py), the ranks bit-equal, each rank's run repeated bit for bit
  without deterministic algorithms, each rank's kernels launched as a
  step launches them (over NCCL too, a rank a card, where there are two
  cards or more); (b) the train CLI with ``--launcher pytorch`` over the 2
  ranks, then its test CLI, which must give one process's annos and
  result string; (c) ``torchrun`` of the train CLI over NCCL on every card
  (on one card a group of one). Each kernel entry gains rank 0's
  ``ddp_launches`` of (a).
- second: the sparse voxel path at the published widths of upstream
  OpenPCDet's ``tools/cfgs/kitti_models/second.yaml`` (``second_cfg``: a
  1408 x 1600 x 40 grid, MeanVFE, the sparse VoxelBackBone8x, HeightCompression,
  BaseBEVBackbone, 3 classes) at batch 4 on host-voxelized
  ``realistic_scans``: (a) an eval forward with AnchorHeadSingle that must
  keep every site at the default cap and equal the port's CPU forward of
  scan 0 (SECOND_RTOL), with each sparse level's sites, bytes and time,
  the stage medians, the peak, and the sparse backbone timed again at the
  full 40,000-voxel eval cap (its device time split into the products and
  the rest); K14 (a sparse conv's rulebook, once a conv: 12 a forward) at
  the forward's shapes held to its plain version by torch.equal, timed
  beside its plain version and its byte bound; (b) AnchorHeadMulti (a
  head a class, a 64-channel shared conv), its head held to the CPU; (c)
  ATSS training under adam_onecycle: two backwards bit-equal without
  deterministic algorithms, K12 (one launch a differentiable row gather of
  the sparse convs) against its plain version, 2 timed steps. No TPU
  kernel lies on this path: the eval forms launch K14 only, a train step
  K14 and K12.
- nofp: PointNet2MSG_NOFP at hvpr.yaml's SA_CONFIG, batch 4: K4 and K5
  against their plain versions (exactly), timed beside their bounds, two
  launches each a forward.
- demo: the demo CLI's ``main`` (hvpr.yaml, a seeded ``.pth``, 2 ``.bin``
  scans, --save_3d), its launches counted from zero (K2 once a scan): its
  detections equal bit for bit to the padded pipeline's here, its PLY
  files written; then ``python -m hvpr_tpu_torch.tools.vis`` in a
  subprocess on a synthetic KITTI tree. A PNG needs matplotlib: without
  it, none is expected.
- options: hvpr.yaml at full width with every option the shipped configs
  leave off (``options_cfg``: the sequential DUAL_PASS, MATCH_HEIGHT,
  POS_FRACTION subsampling, NORM_BY_NUM_EXAMPLES, the sincos box coder,
  TOPK_MODE approx, the adam and sgd optimizers): 4 adam steps (the
  warmup, then a decay) and 2 sgd steps at batch 4 through the kernels,
  counts from zero, equal to the plain steps bit for bit; the subsample's
  counts within their cap and budget; the step timed with and without
  MATCH_HEIGHT; the sequential backbone against the stacked one (bf16 and
  f32); the batch-8 pipeline with approx (K1 and K3, no K2) equal to the
  plain and the exact runs; the train CLI resumed from epoch 1 equal to
  the uninterrupted run's epoch 2 checkpoint.

- profile: the port's seven profilers (``hvpr_tpu_torch/tools/profile_*.py``,
  the counterparts of the JAX package's ``tools/profile_*.py``) at
  hvpr.yaml's full width and the JAX tools' batches (16 inference, 4
  train): the stage profile of inference and of the train step, post-
  processing's parts, the head, the point stream, the memory lookup and the
  whole step, each region's ms, GFLOP, GB, ``mfu`` and ``hbm_frac`` against
  the card's published peaks beside its power limit (records under
  ``chiprun_out/profile/``); the rows must carry the JAX records' keys and
  no ``mfu`` may pass 1; the profiled forward and step, counted again with
  every kernel call captured, must report each kernel's work as its work
  function (the bound column's) gives it for those calls, under its dense
  formula, and launch K1 x3, K2, K3 x2 and STEP_LAUNCHES.

``python3 chip_smoke.py --only second,nofp,demo`` (any of the phase names
of PHASES) runs the build and those phases alone, for development: it
prints no kernels line and no last line.

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
errors; each entry also the launches of every other path, K1's and K3's
the ``nuscenes`` shapes' times and bounds, K4's and K5's the ``nofp``
shapes', K12's the ``second`` train step's; ``options_launches``: the
options phase's adam steps and forward; ``profile_launches``: the profile
phase's counted forward and step), the card's name and power
limit as nvidia-smi reports them, and
last ``{"ok": true, "device": {...}}``. Any failed check exits nonzero.
Without a CUDA device it exits 2 at once. It leaves no process running:
the DataLoader's fork server and resource tracker are stopped after the
last phase, and whatever still runs below the script when it ends, as
after a failed check, is killed and reaped.
"""

import contextlib
import glob
import inspect
import json
import os
import signal
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
INFER_KERNELS = ('segment_sweep', 'memory_lookup', 'bev_canvas')
# launches of each train kernel in one step of hvpr.yaml: one ball query per
# SA level (both radii in one sweep), one FPS per level, one reconstruction
# each way, one threshold, and the masked attention of the points (K9's
# dense sweep) and of their reconstructions (K9's pair pass, on the first
# call's selection), and both backwards (those four in fused mode only);
# K12, the row gathers' deterministic backward: SA2's two groupings of SA1's
# features and the two FP modules' 3-NN interpolations
STEP_LAUNCHES = {'ball_query': 2, 'fps_chunks': 2, 'memory_recon_fwd': 1,
                 'memory_recon_bwd': 1, 'bucket_threshold': 1,
                 'masked_attend_fwd': 1, 'masked_attend_pairs': 1, 'masked_attend_bwd': 2,
                 'gather_grad': 4}
ATTEND_KERNELS = ('bucket_threshold', 'masked_attend_fwd', 'masked_attend_pairs',
                  'masked_attend_bwd')
EXACT_FPS_NPOINT = 4096            # hvpr.yaml's SA1 npoint, over whole scans
# K6/K7 and K9/K10 against their plain versions: both accumulate exact
# products in f64 and round once, so they agree but for an order-dependent
# last f64 bit of a sum; allowed: 1e-5 of the output's largest magnitude
RECON_RTOL = 1e-5
# the TPU kernel (or XLA op) each kernel of ops/_kernels.ENTRIES replaces
META = {
    'segment_sweep': 'hvpr_tpu/ops/segment_sweep.py:106',
    'memory_lookup': 'hvpr_tpu/ops/memory_lookup.py:168',
    'bev_canvas': 'hvpr_tpu/ops/bev_canvas.py:128',
    'ball_query': 'hvpr_tpu/ops/pn2_select.py:135',
    'fps_chunks': 'hvpr_tpu/ops/pn2_select.py:302',
    'memory_recon_fwd': 'hvpr_tpu/ops/memory_recon.py:141',
    'memory_recon_bwd': 'hvpr_tpu/ops/memory_recon.py:169',
    'bucket_threshold': 'hvpr_tpu/ops/topk_attend.py:179',
    'masked_attend_fwd': 'hvpr_tpu/ops/topk_attend.py:376',
    'masked_attend_pairs': 'hvpr_tpu/ops/topk_attend.py:376',
    'masked_attend_bwd': 'hvpr_tpu/ops/topk_attend.py:427',
    'three_nn_bucket': 'hvpr_tpu/ops/pn2_select.py:135',
    # no TPU kernel: the backward of the JAX package's XLA gather
    'gather_grad': 'hvpr_tpu/ops/pointnet2.py:189',
    # no TPU kernel: the JAX package's rotated IoU is XLA
    'rotated_iou': 'hvpr_tpu/ops/rotated_iou.py:136',
    # no TPU kernel: the JAX package's sparse convs' lookups are XLA
    'sparse_rulebook': 'hvpr_tpu/ops/sparse_conv.py:50',
}


def without_iou(launches):
    """The launch counts of every kernel but K13 (the rotated IoU), which
    runs in every NMS, in the recall and in the assigners that take the
    rotated IoU: the phases hold the other kernels to their exact counts;
    K13's own calls are held to the plain version and counted where a phase
    captures them (:func:`flat_phase`, the profile phase)."""
    return {k: v for k, v in launches.items() if k != 'rotated_iou'}


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


# K12's summing kernels; every other device record of a K12 call is its set-up
K12_SUM_KERNELS = ('k12_sum', 'k12_sum_narrow')


def k12_split(run, reps=20):
    """Where the time of ``run()`` (K12 calls through a wrapper) goes: its
    CUDA-event median (wall), the host's time to issue it (perf_counter,
    no synchronize after), and torch.profiler's device ms by kernel, split
    into the summing kernel and the set-up (every other record)."""
    import torch
    wall = cuda_ms(run, reps=reps)
    host = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    dev = device_times(run, reps=5)
    kernel = sum(v for k, v in dev.items() if k in K12_SUM_KERNELS)
    return {'wall_ms': wall, 'host_ms': statistics.median(host),
            'setup_ms': sum(dev.values()) - kernel if dev else None,
            'kernel_ms': kernel if dev else None, 'by_name': dev}


def k12_split_text(split):
    dev = split['by_name']
    return (f'wall {split["wall_ms"]:.4f} ms (CUDA events), host issue '
            f'{split["host_ms"]:.4f} ms; device: '
            + (f'set-up {split["setup_ms"]:.4f}, kernel {split["kernel_ms"]:.4f} ('
               + ', '.join(f'{k} {v:.4f}' for k, v in dev.items()) + ')'
               if dev else 'not measured'))


def k12_share(step, reps=3):
    """(median ms of ``step()``, K12's ms in that step, K12 calls a step):
    each K12 call's span on the stream between two CUDA events recorded
    around its wrapper, summed over the step (host clock for the step)."""
    import torch
    from hvpr_tpu_torch.ops import gather_rows
    fn = gather_rows.gather_rows_backward
    spans = []

    def timed(*args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        end.record()
        spans.append((start, end))
        return out
    rows = []
    gather_rows.gather_rows_backward = timed
    try:
        for _ in range(reps):
            spans.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            rows.append(((time.perf_counter() - t0) * 1e3,
                         sum(s.elapsed_time(e) for s, e in spans), len(spans)))
    finally:
        gather_rows.gather_rows_backward = fn
    return sorted(rows)[len(rows) // 2]


def print_k12_split(calls, where):
    """Print K12's set-up/kernel split over ``calls`` ([(grad, index, n)])."""
    from hvpr_tpu_torch.ops import gather_rows
    print(f'gather_grad: at {where}: ' + k12_split_text(k12_split(
        lambda: [gather_rows.gather_rows_backward(*a) for a in calls])))


def device_breakdown(fn, reps=3):
    """'name ms, ...' of :func:`device_times`; 'not measured' when the
    profiler records no device time."""
    return ', '.join(f'{k} {v:.4f}' for k, v in device_times(fn, reps).items()) \
        or 'not measured'


def seed_weights(module, seed, box_std=None):
    """Seeded random weights: He-normal convs/linears (the point stream's
    1x1 convs and the sparse convs' (taps, C_in, C_out) weights too), the
    memory uniform in +-1/sqrt(C), BN running statistics and affine terms
    perturbed so that BN is exercised, and the cls bias at 0 so that
    thousands of anchors clear SCORE_THRESH and reach NMS.
    ``box_std``: the box head's weights normal at this std instead (the
    reference's init is 0.001): nuScenes' raw intensities (0-255) carry
    He-normal activations to box residuals whose exp overflows f32."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if box_std is not None and name.endswith('conv_box.weight'):
                v = torch.randn(p.shape, generator=gen) * box_std
            elif name.endswith('memory.weight'):
                bound = p.shape[1] ** -0.5
                v = (torch.rand(p.shape, generator=gen) * 2 - 1) * bound
            elif p.dim() == 3:          # a sparse conv's (taps, C_in, C_out)
                v = torch.randn(p.shape, generator=gen) * (2.0 / (p.shape[0] * p.shape[1])) ** 0.5
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
    {name: [(args, kwargs), ...]} with tensor arguments cloned. A call made
    inside a recorded call of the same name (a wrapper that runs itself
    again under a ``utils.flops.Counter``) is not recorded again."""
    import torch
    calls = {}
    saved = []
    depth = {}

    def recorder(key, fn):
        def wrapped(*args, **kwargs):
            if depth.get(key):
                return fn(*args, **kwargs)
            calls.setdefault(key, []).append((
                tuple(a.detach().clone() if isinstance(a, torch.Tensor) else a
                      for a in args),
                dict(kwargs)))
            depth[key] = 1
            try:
                return fn(*args, **kwargs)
            finally:
                depth[key] = 0
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


def load_cfg(train_attend_mode=None, path=CFG):
    from hvpr_tpu_torch.config import ConfigDict, cfg_from_yaml_file
    cfg = ConfigDict()
    cfg_from_yaml_file(path, cfg)
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


def _sweep_work(calls):
    """K1's work over its captured calls (``utils.flops.segment_sweep_work``:
    each (C, R) input read and the output written once in f32, the slots
    read once)."""
    from hvpr_tpu_torch.utils import flops
    return flops.total(flops.segment_sweep_work(*a[0].shape) for a, _ in calls)


def _sweep_bound(calls):
    """K1's bound over its captured calls."""
    from hvpr_tpu_torch.utils import flops
    b_ms, b_by, _ = flops.work_bound(_sweep_work(calls))
    return {'bound_ms': b_ms, 'bound_by': b_by, 'library_ms': None}


def _canvas_work(calls):
    """K3's work over its captured calls (``utils.flops.bev_canvas_work``:
    the canvas written once, the valid pillars' rows read once, coords and
    mask read)."""
    import torch
    from hvpr_tpu_torch.utils import flops
    works = []
    for a, kw in calls:
        feat, coords, vmask, ny, nx = a[:5]
        out_dtype = a[5] if len(a) > 5 else kw.get('out_dtype', torch.float32)
        works.append(flops.bev_canvas_work(*feat.shape, ny, nx, int(vmask.sum()),
                                           torch.finfo(out_dtype).bits // 8,
                                           feat.element_size()))
    return flops.total(works)


def _lookup_work(args, count):
    """K2's work of one captured call (``utils.flops.memory_lookup_work``)
    whose selected counts are ``count``: empty pillar slots are not looked
    up."""
    from hvpr_tpu_torch.utils import flops
    pill, memw, _k, row_mask = args[:4]
    r, c = pill.shape
    return flops.memory_lookup_work(r, r if row_mask is None else int(row_mask.sum()),
                                    memw.shape[0], c, float(count.sum()))


def _canvas_bound_and_yardstick(calls, label=''):
    """K3's bound (the canvas written once, the valid pillars' rows read
    once, coords and mask read) and its yardstick over the captured calls:
    ``torch.zeros`` + ``index_put_`` in one window, as the kernel writes
    the whole canvas; beside it ``index_put_`` into a canvas zeroed outside
    the window."""
    import torch
    from hvpr_tpu_torch.utils import flops
    lib_ms, put_ms, yardsticks = 0.0, 0.0, []
    for a, kw in calls:
        feat, coords, vmask, ny, nx = a[:5]
        out_dtype = a[5] if len(a) > 5 else kw.get('out_dtype', torch.float32)
        b, v, cc = feat.shape
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
    print(f'bev_canvas{label}: torch.zeros + index_put_ {lib_ms:.4f} ms; index_put_ into a '
          f'canvas zeroed outside the window {put_ms:.4f} ms')
    print(f'bev_canvas{label}: torch.zeros + index_put_, device ms per forward by kernel '
          '(torch.profiler): ' + device_breakdown(lambda: [f() for f in yardsticks]))
    b_ms, b_by, _ = flops.work_bound(_canvas_work(calls))
    return {'bound_ms': b_ms, 'bound_by': b_by, 'library_ms': lib_ms}


def flat_phase(smi, label, cfg, points, mask, kernels, reps=5, box_std=None):
    """One config's eval network through ``Network.pipeline`` on the card
    (seeded weights, the flat layout of the device voxelizer): every call
    of the inference kernels' wrappers in one run captured and each held
    against its plain version (bit for bit), the main path run with the
    counts from zero (each of ``kernels`` launched as often as the capture
    called it, no other kernel), its detections against the same pipeline
    through the plain versions (bit for bit), then the pipeline's median
    over ``reps`` batches, the stage medians and the candidates of each
    class above SCORE_THRESH. Returns (network, calls, {kernel: entry},
    launch counts, detections). ``box_std``: see :func:`seed_weights`. K13
    (the NMS's rotated IoU, once a scan and class) joins ``kernels`` on
    every path."""
    import torch
    from hvpr_tpu_torch.models import DatasetMeta, build_network
    from hvpr_tpu_torch.models.backbones_2d.map_to_bev import (
        memory_module, pointpillar_scatter)
    from hvpr_tpu_torch.models.backbones_3d.vfe import pillar_vfe
    from hvpr_tpu_torch.ops import _kernels, nms as nms_module

    meta = DatasetMeta(cfg.DATA_CONFIG, cfg.CLASS_NAMES)
    net = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), meta, device='cuda')
    seed_weights(net.module, seed=0, box_std=box_std)
    b = points.shape[0]
    kernels = (*kernels, 'rotated_iou')

    # capture every wrapper call of one pipeline run (the warm-up)
    calls = capture_calls(
        [(pillar_vfe, 'segment_sweep', 'segment_sweep'),
         (memory_module, 'memory_lookup_fused', 'memory_lookup'),
         (pointpillar_scatter, 'canvas_from_sorted', 'bev_canvas'),
         (nms_module, 'boxes_iou_bev', 'rotated_iou')],
        lambda: net.pipeline(points, mask))
    torch.cuda.synchronize()
    if set(calls) != set(kernels):
        fail(f'{label}: the pipeline called {sorted(calls)}, expected {sorted(kernels)}')

    # each kernel against its plain version at the path's shapes
    entries = {}
    wrappers = {'segment_sweep': pillar_vfe.segment_sweep,
                'memory_lookup': memory_module.memory_lookup_fused,
                'bev_canvas': pointpillar_scatter.canvas_from_sorted,
                'rotated_iou': nms_module.boxes_iou_bev}
    for name in kernels:
        fn = wrappers[name]
        err = ms = plain_ms = 0.0
        for args, kwargs in calls[name]:
            got = fn(*args, **kwargs)
            with _kernels.plain_versions():
                want = fn(*args, **kwargs)
            torch.cuda.synchronize()
            if got.shape != want.shape or got.dtype != want.dtype:
                fail(f'{label} {name}: {got.shape}/{got.dtype} vs plain '
                     f'{want.shape}/{want.dtype}')
            if not torch.isfinite(got.float()).all():
                fail(f'{label} {name}: non-finite output')
            err = max(err, float((got.float() - want.float()).abs().max()))
            ms += cuda_ms(lambda: fn(*args, **kwargs))
            with _kernels.plain_versions():
                plain_ms += cuda_ms(lambda: fn(*args, **kwargs), reps=5, warmup=1)
        entries[name] = {'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms}
        shapes = [tuple(tuple(a.shape) for a in args if isinstance(a, torch.Tensor))
                  + tuple(a for a in args if isinstance(a, (int, str)))
                  for args, _ in calls[name]]
        print(f'{label} {name}: {len(calls[name])} call(s) per forward at {shapes}, '
              f'max_abs_err {err}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms')
        print(f'{label} {name}: device ms per forward by kernel (torch.profiler): '
              + device_breakdown(lambda: [fn(*a, **kw) for a, kw in calls[name]]))
        # the kernels repeat the plain versions' arithmetic: bit-identical
        if err != 0.0:
            fail(f'{label} {name}: kernel differs from its plain version by {err}')

    # the main path, counts from zero
    _kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = net.pipeline(points, mask)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = _kernels.launch_counts()
    print(f'{label} path launches: {launches}')
    for name, n in launches.items():
        if n != len(calls.get(name, ())):
            fail(f'the {label} path launched {name} {n} times, expected '
                 f'{len(calls.get(name, ()))}')

    post = cfg.MODEL.POST_PROCESSING
    nms = post.NMS_CONFIG
    slots = int(nms.NMS_POST_MAXSIZE) * (len(cfg.CLASS_NAMES) if nms.MULTI_CLASSES_NMS else 1)
    for key, shape in (('pred_boxes', (b, slots, 7)), ('pred_scores', (b, slots)),
                       ('pred_labels', (b, slots)), ('pred_mask', (b, slots))):
        if tuple(res[key].shape) != shape:
            fail(f'{label}: {key} shape {tuple(res[key].shape)}, expected {shape}')
    if not (torch.isfinite(res['pred_boxes']).all() and torch.isfinite(res['pred_scores']).all()):
        fail(f'{label}: non-finite detections')
    kept = res['pred_mask'].sum(dim=1)
    if int(kept.min()) == 0:
        fail(f'{label}: a scan kept no box: {kept.tolist()}')
    if int((res['pred_scores'][res['pred_mask']] < post.SCORE_THRESH).sum()):
        fail(f'{label}: a kept box scores below SCORE_THRESH')
    labels = res['pred_labels'][res['pred_mask']]
    if int(labels.min()) < 1 or int(labels.max()) > len(cfg.CLASS_NAMES):
        fail(f'{label}: labels outside 1..{len(cfg.CLASS_NAMES)}')

    # the same pipeline through the plain versions: the same detections
    with _kernels.plain_versions():
        ref = net.pipeline(points, mask)
    torch.cuda.synchronize()
    differ = [k for k in ('pred_mask', 'pred_labels', 'pred_boxes', 'pred_scores',
                          'num_capped') if not torch.equal(res[k], ref[k])]
    print(f'{label} detections vs plain pipeline: kept per scan {kept.tolist()}, '
          f'keys that differ {differ}')
    if differ:
        fail(f'{label}: detections differ from the plain pipeline in {differ}')

    # throughput, host clock around synchronized batches
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.pipeline(points, mask)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    batch_s = statistics.median(times)
    print(f'{label} pipeline: first run {first_s:.4f} s, median of {reps} {batch_s:.4f} s '
          f'per batch of {b} -> {b / batch_s:.2f} scans/s on {smi}')
    stages = stage_ms(net, points, mask, reps=reps)
    print(f'{label} stage ms (median of {reps}, synchronized): '
          + ', '.join(f'{k} {v:.3f}' for k, v in stages.items()))
    with torch.no_grad():
        cls = net.module(net_batch(net, points, mask))['batch_cls_preds']
    live = (torch.sigmoid(cls) >= post.SCORE_THRESH).sum(dim=1)          # (B, C)
    per_class = {name: live[:, i].tolist() for i, name in enumerate(cfg.CLASS_NAMES)}
    print(f'{label}: candidates clearing SCORE_THRESH per scan, by class: {per_class} '
          f'(MULTI_CLASSES_NMS {bool(nms.MULTI_CLASSES_NMS)}, NMS_PRE_MAXSIZE '
          f'{nms.NMS_PRE_MAXSIZE}); post-processing {stages["post_processing"]:.3f} ms '
          f'a batch of {b}')
    return net, calls, entries, launches, res


def inference_phase(smi):
    """Kernels K1-K3 against their plain versions and the inference path of
    hvpr.yaml at batch 8, with K2's selected sets, the bounds and the
    library yardsticks. Returns ({kernel: entry}, the path's launch
    counts)."""
    import numpy as np
    import torch
    from hvpr_tpu_torch.models.backbones_2d.map_to_bev import memory_module
    from hvpr_tpu_torch.ops import _kernels
    from hvpr_tpu_torch.utils import flops
    from hvpr_tpu_torch.utils.scans import realistic_scans

    cfg = load_cfg()
    pcr = cfg.DATA_CONFIG.POINT_CLOUD_RANGE
    points = torch.from_numpy(realistic_scans(np.random.default_rng(0), BATCH,
                                              N_POINTS, pcr)).cuda()
    mask = torch.ones(BATCH, N_POINTS, dtype=torch.bool, device='cuda')
    _, calls, entries, launches, _ = flat_phase(smi, 'inference', cfg, points, mask,
                                                INFER_KERNELS)

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
    entries['segment_sweep'].update(_sweep_bound(calls['segment_sweep']))
    pill, memw, row_mask = args[0], args[1], args[3]
    # empty pillar slots are not looked up
    print(f'memory_lookup: {int(row_mask.sum())} of {pill.shape[0]} rows are valid pillars')
    # the valid rows' logits + 2C flops a selected column, on bf16 tensor cores
    b_ms, b_by, dmma_ms = flops.work_bound(_lookup_work(args, cnt_k))
    lib_ms = _lookup_library_ms(pill, memw, row_mask, th_k)
    entries['memory_lookup'].update(bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
    print(f'memory_lookup: scaled_dot_product_attention over the valid rows with the '
          f'selected sets as its mask (the function of _apply_kernel only) {lib_ms:.4f} ms')
    k2_ms = entries['memory_lookup']['ms']
    print(f'memory_lookup: K2 {k2_ms:.4f} ms against the SDPA yardstick {lib_ms:.4f} ms: '
          f'{"below" if k2_ms < lib_ms else "NOT below"} it ({k2_ms / lib_ms:.3f}x); bound '
          f'{b_ms:.4f} ms ({b_by}, bf16 tensor cores), on the FP64 tensor cores '
          f'{dmma_ms:.4f} ms for the logits')
    entries['bev_canvas'].update(_canvas_bound_and_yardstick(calls['bev_canvas']))
    entries['rotated_iou'].update(_iou_bound_and_share(calls['rotated_iou']))
    return entries, launches


def _iou_bound_and_share(calls, label=''):
    """K13 at the NMS's shapes (batch 8: a 4,096 x 4,096 plane a scan): its
    bound, the planes' bytes at 3.35 TB/s (the write no design avoids; the
    plain arithmetic's operations at the f32 peak printed beside it), and
    the share of pairs it clipped in full, ``nms.iou_clipped`` over
    ``nms.iou_pairs`` as the kernel counts them while the recorder is on."""
    import torch
    from hvpr_tpu_torch.ops import nms as nms_module
    from hvpr_tpu_torch.utils import flops, profiler
    work = flops.total(flops.rotated_iou_work(a[0].shape[0], a[1].shape[0], True)
                       for a, _ in calls)
    bytes_ms = work.nbytes / flops.H100['hbm'] * 1e3
    ops_ms = work.ops / flops.H100['f32'] * 1e3
    profiler.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for a, kw in calls:
            nms_module.boxes_iou_bev(*a, **kw)
        profiler.record()
        counted = profiler.counters()
    profiler.clear()
    share = 100.0 * counted['nms.iou_clipped'] / counted['nms.iou_pairs']
    print(f'rotated_iou{label}: {len(calls)} call(s) at {[tuple(a[0].shape) for a, _ in calls]}; '
          f'pairs clipped in full {share:.4f}% ({counted["nms.iou_clipped"]} of '
          f'{counted["nms.iou_pairs"]}); bound {bytes_ms:.4f} ms (bytes: the planes '
          f'written), the plain arithmetic\'s operations at the f32 peak {ops_ms:.4f} ms')
    return {'bound_ms': bytes_ms, 'bound_by': 'bytes', 'library_ms': None,
            'clipped_share': share}


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


def _train_work(name, calls, outs, selected, recon_nonzero):
    """The ``utils.flops.Work`` of one step's calls of train kernel ``name``,
    from this run's inputs (and, for the ball query, its results, which say
    where each centre's sweep may stop; for the masked attention,
    ``selected``: {shared: selected points summed over the valid rows}; for
    K6, ``recon_nonzero``: the nonzero weights n W needs)."""
    import torch
    from hvpr_tpu_torch.ops.topk_attend import PAIR_CAP, pair_counts
    from hvpr_tpu_torch.utils import flops
    works = []
    for (args, _), out in zip(calls, outs):
        if name == 'gather_grad':
            grad, _index, n = args
            works.append(flops.gather_grad_work(*grad.shape, grad.element_size(), n))
        elif name == 'ball_query':
            # one call a level, both radii: up to the point at which the
            # centre has both radii's nsample distinct buckets (else all N)
            radii, nsamples, xyz, new_xyz, mask = args
            visited = float(torch.stack([flops.ball_stop(idx, cnt, ns, xyz.shape[1])
                                         for (idx, cnt), ns in zip(out, nsamples)])
                            .amax(dim=0).sum())
            works.append(flops.ball_query_work(*xyz.shape[:2], new_xyz.shape[1], nsamples,
                                               visited))
        elif name == 'fps_chunks':
            pts, _valid, nsamp = args
            works.append(flops.fps_work(*pts.shape[:2], nsamp))
        elif name == 'memory_recon_fwd':
            x, w = args[0], args[1]
            works.append(flops.memory_recon_fwd_work(x.shape[0], w.shape[0], x.shape[1],
                                                     recon_nonzero))
        elif name == 'memory_recon_bwd':
            x, w = args[0], args[1]
            works.append(flops.memory_recon_bwd_work(x.shape[0], w.shape[0], x.shape[1]))
        else:
            pill, table = args[0], args[1]
            b, v, c = pill.shape
            n = table.shape[1]
            row_mask = args[{'bucket_threshold': 4, 'masked_attend_fwd': 6,
                             'masked_attend_pairs': 6, 'masked_attend_bwd': 9}[name]]
            r = int(row_mask.sum())
            if name == 'bucket_threshold':
                works.append(flops.bucket_threshold_work(b, v, n, c, r))
            elif name == 'masked_attend_fwd':
                shared = args[5]
                works.append(flops.masked_attend_fwd_work(b, v, n, c, r, selected[shared],
                                                          shared, PAIR_CAP))
            elif name == 'masked_attend_pairs':
                shared, (sel_cnt, _) = args[5], args[7]
                works.append(flops.masked_attend_pairs_work(
                    b, v, n, c, r, selected[shared], shared, *pair_counts(sel_cnt, row_mask),
                    PAIR_CAP))
            else:
                shared, cnt = args[8], args[12]
                works.append(flops.masked_attend_bwd_work(b, v, n, c, r, selected[shared],
                                                          shared, *pair_counts(cnt, row_mask)))
    return flops.total(works)


def _train_bounds(name, calls, outs, selected, recon_nonzero):
    """(bound ms, bound_by, DMMA bound ms or None) of :func:`_train_work`:
    the DMMA bound is the time of the same products on the FP64 tensor
    cores, where the kernel runs them there (K6, K7, K8, K9's dense
    sweep)."""
    from hvpr_tpu_torch.utils import flops
    return flops.work_bound(_train_work(name, calls, outs, selected, recon_nonzero))


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
    from hvpr_tpu_torch.utils import flops
    levels = []
    for level, ((args, _), out) in enumerate(zip(calls, plain_outs), 1):
        radii, nsamples, xyz, new_xyz, mask = args
        b, n = xyz.shape[:2]
        s = new_xyz.shape[1]
        stops = [flops.ball_stop(idx, cnt, ns, n) for (idx, cnt), ns in zip(out, nsamples)]
        both = float(torch.stack(stops).amax(dim=0).sum())
        b_ms, b_by, _ = flops.work_bound(flops.ball_query_work(b, n, s, nsamples, both))
        ms = cuda_ms(lambda: pn2_select.ball_query_bucket2(*args))
        dev = _kernel_device_ms(lambda: pn2_select.ball_query_bucket2(*args),
                                'ball_query_kernel')
        print(f'ball_query level {level}: {tuple(xyz.shape)} points, {tuple(new_xyz.shape)} '
              f'centres, radii {radii}, nsample {nsamples}: one call {ms:.4f} ms, device '
              f'{dev:.4f} ms, bound {b_ms:.4f} ms ({b_by}; {both:.4g} pairs needed)')
        per_radius = []
        for r, ns, stop, (_, cnt) in zip(radii, nsamples, stops, out):
            r_ms, r_by, _ = flops.work_bound(flops.ball_query_work(b, n, s, (ns,),
                                                                   float(stop.sum())))
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
    import torch
    from hvpr_tpu_torch.ops import _kernels, memory_recon
    cap = _kernels.entry('memory_recon_fwd_cap')()
    total = 0.0
    for (x, w, lam), _ in calls:
        counts = memory_recon.nonzero_weights(x, w, lam)
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
    the differences of their torch.profiler device times. Launched through
    its table entry, not the wrapper: these launches count for no path."""
    import torch
    from hvpr_tpu_torch.ops import _kernels
    times = []
    for stop in (1, 2, 0):
        def run(stop=stop):
            for (x, w, lam), _ in calls:
                xb = x.to(torch.bfloat16).contiguous()
                wb = w.to(torch.bfloat16).contiguous()
                y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
                _kernels.launch('memory_recon_fwd_part', x, _kernels.ptr(xb), _kernels.ptr(wb),
                                _kernels.ptr(y), x.shape[0], w.shape[0], x.shape[1],
                                float(lam), stop)
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
                 'masked_attend_pairs': (1, 5), 'gather_grad': (0,)}


def _train_wrappers():
    """{train kernel: (module, attribute, wrapper)}: where the train step
    calls each kernel's wrapper (the attribute that :func:`capture_calls`
    records), and the wrapper."""
    from hvpr_tpu_torch.models.backbones_2d.map_to_bev import pointpillar_scatter
    from hvpr_tpu_torch.ops import gather_rows, memory_recon, pn2_select, pointnet2, topk_attend
    return {'ball_query': (pointnet2, 'ball_query_bucket2', pn2_select.ball_query_bucket2),
            'fps_chunks': (pointnet2, 'fps_chunks', pn2_select.fps_chunks),
            'memory_recon_fwd': (memory_recon, 'recon_forward', memory_recon.recon_forward),
            'memory_recon_bwd': (memory_recon, 'recon_backward', memory_recon.recon_backward),
            'bucket_threshold': (pointpillar_scatter, 'bucket_threshold',
                                 topk_attend.bucket_threshold),
            'masked_attend_fwd': (topk_attend, 'masked_attend_fwd',
                                  topk_attend.masked_attend_fwd),
            # the same wrapper; its calls that carry a selection
            'masked_attend_pairs': (None, None, topk_attend.masked_attend_fwd),
            'masked_attend_bwd': (topk_attend, 'masked_attend_bwd',
                                  topk_attend.masked_attend_bwd),
            'gather_grad': (gather_rows, 'gather_rows_backward',
                            gather_rows.gather_rows_backward)}


def _split_attend_calls(calls):
    """K9's captured calls split in place: the dense sweep's (no selection)
    stay under masked_attend_fwd, the pair pass's go to masked_attend_pairs."""
    fwd = calls.pop('masked_attend_fwd', [])
    calls['masked_attend_fwd'] = [cl for cl in fwd if cl[0][7] is None]
    calls['masked_attend_pairs'] = [cl for cl in fwd if cl[0][7] is not None]


def train_phase(smi, mode, cfg_path=CFG, n_steps=None):
    """One train step of ``cfg_path`` (hvpr.yaml, or hvpr_multiclass.yaml)
    at batch 4 in TRAIN_ATTEND_MODE ``mode`` through the kernels against one
    through the plain versions, two kernel steps without deterministic
    algorithms against each other, and ``n_steps`` timed steps
    (TRAIN_STEPS fused, GATHER_STEPS gather by default). In the shipped
    mode, fused, also each train kernel (K4-K10) against its plain version
    at the step's shapes and the part times. Returns ({kernel: entry}, the
    timed steps' launch counts, the kernel step's metrics, the step's
    ``pointnet2.three_nn`` calls)."""
    import numpy as np
    import torch
    from hvpr_tpu_torch.models import DatasetMeta, build_network
    from hvpr_tpu_torch.models.backbones_2d.map_to_bev import pointpillar_scatter
    from hvpr_tpu_torch.ops import _kernels, gather_rows, pointnet2, topk_attend
    from hvpr_tpu_torch.parallel import loss_and_grads
    from hvpr_tpu_torch.utils.scans import realistic_scans_with_boxes

    fused = mode == 'fused'
    label = mode if cfg_path == CFG else f'{mode}, {os.path.basename(cfg_path)}'
    # hvpr.yaml sets no TRAIN_ATTEND_MODE: as shipped it trains fused
    cfg = load_cfg(None if fused else mode, path=cfg_path)
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
    print(f'train batch ({label}): {TRAIN_BATCH} scans, '
          f'{int(batch["voxel_mask"].sum())} pillars, {gt.shape[1]} boxes a scan')
    state0 = {k: v.clone() for k, v in net.module.state_dict().items()}
    n_params = sum(p.numel() for p in net.module.parameters())
    step_launches = {k: n for k, n in STEP_LAUNCHES.items() if fused or k not in ATTEND_KERNELS}
    if not fused:
        # the gather mode's gathers: the pooling's, a chunk of pillars at a
        # time, and the memory path's reconstructions
        chunk = inspect.signature(
            pointpillar_scatter.attentive_point_pooling).parameters['chunk'].default
        step_launches['gather_grad'] += -(-meta.max_voxels // chunk) + 1
    wrappers = {k: w for k, w in _train_wrappers().items() if k in step_launches}

    def fresh():
        net.module.load_state_dict(state0)
        net.init_training(cfg.OPTIMIZATION, TOTAL_STEPS)

    # 1-2. one step through the kernels, every train kernel's wrapper call
    # captured, and the same step from the same state through the plain
    # versions, under torch's deterministic algorithms. Without them the
    # plain versions' gathers sum by atomics in run order and two plain steps
    # differ by some percent in a point-stream gradient (its bf16 BN
    # backwards amplify the noise; printed below; the kernel step, whose
    # gathers K12 sums in order, needs no switch); with them two plain steps
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
    print(f'step 1 ({label}), kernels/plain: ' + ', '.join(
        f'{k} {metrics_k[k]:.7g}/{metrics_p[k]:.7g}' for k in sorted(metrics_k)))
    for k, v in metrics_k.items():
        if not np.isfinite(v):
            fail(f'train step {k} is not finite')
    names = [n for n, _ in net.module.named_parameters()]
    differ = ([n for n, g, w in zip(names, grads_k, grads_p) if not torch.equal(g, w)]
              + [k for k in params_p if not torch.equal(params_k[k], params_p[k])]
              + [k for k in metrics_p if metrics_k[k] != metrics_p[k]])
    print(f'step 1 ({label}), kernels vs plain: {len(names)} gradient leaves, '
          f'{len(params_p)} weight and statistic tensors, {len(metrics_p)} metrics; '
          f'{len(differ)} differ')
    if differ:
        fail(f'the {label} kernel step differs from the plain step in {differ[:5]}')
    if fused:
        _split_attend_calls(calls)
    for name, per_step in step_launches.items():
        if len(calls.get(name, ())) != per_step:
            fail(f'one {label} train step called {name} {len(calls.get(name, ()))} '
                 f'times, expected {per_step}')
    del runs, grads_k, grads_p, params_k, params_p

    # without deterministic algorithms: two kernel steps must give the same
    # bits (K12 sums the gathers' gradients without atomics, the gather
    # mode's pooling and memory gathers too; ROADMAP C3); the plain
    # versions' gathers still add by atomics (printed in the fused mode)
    for run in ('kernels', 'plain') if fused else ('kernels',):
        twice = []
        for _ in range(2):
            fresh()
            with _kernels.plain_versions() if run == 'plain' else \
                    contextlib.nullcontext():
                twice.append(loss_and_grads(net.train_state, batch)[1])
        rel = {n: float(torch.linalg.vector_norm((a - b).double())
                        / torch.linalg.vector_norm(b.double()).clamp_min(1e-30))
               for n, a, b in zip(names, *twice)}
        worst = max(rel, key=rel.get)
        n_differ = sum(v > 0 for v in rel.values())
        kind = 'kernel' if run == 'kernels' else 'plain'
        print(f'without deterministic algorithms two {kind} steps ({label}) differ in '
              f'{n_differ} of {len(rel)} gradient leaves, most in {worst}: {rel[worst]:.3g} '
              f'of its L2 norm')
        if run == 'kernels' and n_differ:
            fail(f'two {label} kernel steps without deterministic algorithms differ in '
                 f'{n_differ} gradient leaves')
        del twice

    entries = {}
    if fused:
        # 3. each kernel against its plain version at this step's shapes
        outs = {}
        for name, (_, _, fn) in wrappers.items():
            err = ms = plain_ms = 0.0
            plain_outs = []
            for args, kwargs in calls[name]:
                got = fn(*args, **kwargs)
                if name == 'gather_grad':
                    # its plain version sums in order on the CPU (on the
                    # card its index_add_ adds by atomics): the same bits
                    want = gather_rows.gather_rows_backward_plain(
                        args[0].cpu(), args[1].cpu(), args[2]).to(got.device)
                else:
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

        # K12's yardstick: index_add_ (atomic adds) into a zeroed buffer
        lib_ms = 0.0
        for (grad, index, n), _ in calls['gather_grad']:
            buf = torch.zeros(n, grad.shape[1], dtype=grad.dtype, device=grad.device)
            lib_ms += cuda_ms(lambda: buf.index_add_(0, index, grad), reps=10, warmup=2)
        entries['gather_grad']['library_ms'] = lib_ms
        print(f'gather_grad: equal bit for bit to its plain version on the CPU at '
              f'{[(tuple(a[0].shape), str(a[0].dtype), a[2]) for a, _ in calls["gather_grad"]]}; '
              f'index_add_ {lib_ms:.4f} ms')
        del buf
        print_k12_split([a for a, _ in calls['gather_grad']], f'the {label} step\'s calls')

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
    if n_steps is None:
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
    print(f'train path ({label}) launches in {n_steps} steps: {launches}')
    for name in without_iou(launches):
        want = step_launches.get(name, 0) * n_steps
        if launches[name] != want:
            fail(f'{n_steps} {label} train steps launched {name} {launches[name]} '
                 f'times, expected {want}')
    if not all(np.isfinite(losses)):
        fail(f'non-finite train loss: {losses}')
    step_s = statistics.median(times)
    print(f'train losses ({label}) over {n_steps} steps: {losses}')
    peak = torch.cuda.max_memory_allocated()
    print(f'train step ({label}): median of {n_steps} {step_s * 1e3:.3f} ms per batch of '
          f'{TRAIN_BATCH} -> {TRAIN_BATCH / step_s:.3f} scans/s, peak memory '
          f'{peak / 2**30:.3f} GiB ({(peak + held - held_pairs) / 2**30:.3f} GiB with the '
          f'captured inputs held, as counted before; those held {held / 2**30:.3f} GiB, '
          f'{held_pairs / 2**30:.3f} of it K10\'s pairs), {n_params} parameters, on {smi}')
    if fused and cfg_path == CFG:
        step_ms, k12_ms, n_k12 = k12_share(lambda: net.train_step(batch))
        print(f'gather_grad: {n_k12} calls {k12_ms:.4f} ms of a {label} step of {step_ms:.3f} '
              f'ms ({k12_ms / step_ms:.4f}; CUDA events around each call, median step of 3)')
    if fused:
        stages = train_stage_ms(net, batch)
        print(f'train step ({label}) stage ms (median of 3, CUDA events inside '
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
    from hvpr_tpu_torch.utils import flops

    if len(calls) != 2:
        fail(f'one fused train step called three_nn {len(calls)} times, expected 2')
    fn = pn2_select.three_nn_bucket
    err = ms = plain_ms = 0.0
    works = []
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
        print(f'three_nn_bucket: {tuple(unknown.shape)} x {tuple(known.shape)}, indices and '
              f'distances equal to plain; bucket set = exact three_nn set for '
              f'{float(same.float().mean()):.4f} of the unknown points')
        works.append(flops.three_nn_work(*unknown.shape[:2], known.shape[1]))
    b_ms, b_by, _ = flops.work_bound(flops.total(works))
    print(f'three_nn_bucket: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms for both calls, '
          f'bound {b_ms:.4f} ms ({b_by}); device ms (torch.profiler): '
          + device_breakdown(lambda: [fn(*a) for a, _ in calls]))
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
    from hvpr_tpu_torch.utils import flops
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
    # the real bound is the chain of npoint dependent steps
    b_ms, b_by, _ = flops.work_bound(flops.fps_work(TRAIN_BATCH, N_POINTS, EXACT_FPS_NPOINT))
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


EVAL_VAL_SCENES = 16               # the eval_cli phase's KITTI tree: 16 val scenes,
EVAL_TRAIN_SCENES = 4              # 4 train scenes (2 batches of 8 in val)
EVAL_WORKERS = 4


def _eval_result(root_dir, extra_tag):
    """The annos of ``result.pkl`` that the test CLI wrote for ``extra_tag``."""
    import pickle
    from pathlib import Path
    found = sorted(Path(root_dir).glob(f'output/**/{extra_tag}/eval/**/result.pkl'))
    if len(found) != 1:
        fail(f'eval_cli: expected one result.pkl for {extra_tag}, found {found}')
    with open(found[0], 'rb') as f:
        return pickle.load(f), found[0]


def _annos_equal(a, b):
    import numpy as np
    return len(a) == len(b) and all(
        x.keys() == y.keys() and all(np.array_equal(np.asarray(x[k]), np.asarray(y[k]))
                                     for k in x)
        for x, y in zip(a, b))


def write_eval_tree(tmp, cfg, n_val):
    """A synthetic KITTI tree of ``n_val`` val and EVAL_TRAIN_SCENES train
    scenes under ``tmp`` (the port's writer), its infos
    (``create_kitti_infos``) and a ``.pth`` of seeded random weights (the
    port's checkpoint writer): (data root, checkpoint path)."""
    from hvpr_tpu_torch.datasets.kitti.kitti_dataset import create_kitti_infos
    from hvpr_tpu_torch.models import DatasetMeta, build_network
    from hvpr_tpu_torch.utils.checkpoint import save_checkpoint
    from hvpr_tpu_torch.utils.scans import build_kitti_root

    root, _ = build_kitti_root(tmp / 'kitti', n_scenes=n_val + EVAL_TRAIN_SCENES,
                               n_train=EVAL_TRAIN_SCENES)
    create_kitti_infos(root, root)
    meta = DatasetMeta(cfg.DATA_CONFIG, cfg.CLASS_NAMES)
    writer = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), meta, device='cpu')
    seed_weights(writer.module, seed=0)
    ckpt = tmp / 'checkpoint_epoch_1.pth'
    save_checkpoint(writer.module, ckpt, epoch=1)
    return root, ckpt


def run_test_cli(tmp, root, ckpt, tag, workers, batch=BATCH):
    """``hvpr_tpu_torch.tools.test.main`` on the card: hvpr.yaml, batch
    ``batch``, --save_to_file, its output tree under ``tmp``; the result
    dict."""
    from hvpr_tpu_torch import config
    from hvpr_tpu_torch.tools import test as test_cli

    config.cfg.ROOT_DIR = tmp
    return test_cli.main([
        '--cfg_file', CFG, '--ckpt', str(ckpt), '--batch_size', str(batch),
        '--workers', str(workers), '--extra_tag', tag, '--save_to_file',
        '--set', 'DATA_CONFIG.DATA_PATH', str(root)])


def eval_cli_phase(smi):
    """The evaluation entry point: a synthetic KITTI tree (16 val scenes, 4
    train) written by the port's writer, its infos by ``create_kitti_infos``,
    a ``.pth`` of seeded random weights by the port's checkpoint writer, then
    ``hvpr_tpu_torch.tools.test.main`` on the card (hvpr.yaml, batch 8,
    --save_to_file, host-voxelized padded pillars from 4 DataLoader
    workers). Checks: 16 annos with the Car AP keys; K2 launched once a
    batch and no other kernel; the same run under the plain versions gives
    the same annos; and the padded path's detections on the first batch
    agree with those of the flat device path on the same sampled points
    within the JAX package's limits for its two layouts (scores 2e-4,
    boxes 2e-3, the same labels, on the detections both keep). Returns that
    path's launch counts."""
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch
    from hvpr_tpu_torch.datasets import build_dataloader
    from hvpr_tpu_torch.models import build_network, load_data_to_gpu
    from hvpr_tpu_torch.ops import _kernels
    from hvpr_tpu_torch.utils.checkpoint import load_params_from_file

    cfg = load_cfg()
    build_dir = Path(ROOT) / 'build'
    build_dir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        t0 = time.perf_counter()
        root, ckpt = write_eval_tree(Path(tmp), cfg, EVAL_VAL_SCENES)
        print(f'eval_cli: KITTI tree, infos and checkpoint written in '
              f'{time.perf_counter() - t0:.2f} s')

        def run(tag):
            return run_test_cli(Path(tmp), root, ckpt, tag, EVAL_WORKERS)

        # the main path, counts from zero
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        ret = run('kernels')
        wall_s = time.perf_counter() - t0
        launches = _kernels.launch_counts()
        print(f'eval_cli path launches: {launches}')
        n_batches = -(-EVAL_VAL_SCENES // BATCH)
        for name, n in without_iou(launches).items():
            want = n_batches if name == 'memory_lookup' else 0
            if n != want:
                fail(f'the eval_cli path launched {name} {n} times, expected {want}')
        annos, result_pkl = _eval_result(tmp, 'kernels')
        if len(annos) != EVAL_VAL_SCENES:
            fail(f'eval_cli: result.pkl holds {len(annos)} annos, expected {EVAL_VAL_SCENES}')
        txt = sorted(result_pkl.parent.glob('final_result/data/*.txt'))
        if len(txt) != EVAL_VAL_SCENES:
            fail(f'eval_cli: {len(txt)} KITTI .txt files, expected {EVAL_VAL_SCENES}')
        want_keys = {f'Car_{m}/{d}{r}' for m in ('3d', 'bev', 'image')
                     for d in ('easy', 'moderate', 'hard') for r in ('', '_R40')}
        if not want_keys <= set(ret):
            fail(f'eval_cli: AP keys missing: {sorted(want_keys - set(ret))}')
        if not all(np.isfinite(float(ret[k])) for k in want_keys):
            fail('eval_cli: non-finite AP')
        per_scan = [len(a['name']) for a in annos]
        boxes = np.concatenate([a['boxes_lidar'] for a in annos])
        if not np.isfinite(boxes).all():
            fail('eval_cli: non-finite boxes')
        print(f'eval_cli: {len(annos)} annos, detections per scan {per_scan}, '
              f'Car 3d AP moderate {float(ret["Car_3d/moderate"]):.4f}, R40 '
              f'{float(ret["Car_3d/moderate_R40"]):.4f} (random weights)')

        # the same run through the plain versions: the same annos
        with _kernels.plain_versions():
            run('plain')
        plain_annos, _ = _eval_result(tmp, 'plain')
        if not _annos_equal(annos, plain_annos):
            fail('eval_cli: annos differ from the run through the plain versions')
        print('eval_cli: annos equal to those of the run through the plain versions')

        # padded vs flat on the first batch's sampled points
        test_set, _, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, BATCH,
                                          root_path=root, workers=0, item_seed=0)
        batch = test_set.collate_batch([test_set[i] for i in range(BATCH)])
        net = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), test_set, device='cuda')
        load_params_from_file(net.module, ckpt)
        dev_batch = load_data_to_gpu(batch, net.device)
        padded = net.eval_forward(dev_batch)
        flat = net.pipeline(dev_batch['points'], dev_batch['point_valid_mask'])
        torch.cuda.synchronize()
        # the same batch as the CLI's first (scene i's draws seeded with i)
        for i in range(BATCH):
            kept = padded['pred_boxes'][i][padded['pred_mask'][i]].cpu().numpy()
            if not np.array_equal(kept, annos[i]['boxes_lidar']):
                fail(f'eval_cli: the first batch rebuilt in process differs from the '
                     f'CLI\'s at scan {i}')
        if not torch.equal(padded['pred_mask'].sum(1), flat['pred_mask'].sum(1)):
            fail(f'eval_cli: kept per scan padded {padded["pred_mask"].sum(1).tolist()} '
                 f'vs flat {flat["pred_mask"].sum(1).tolist()}')
        m = padded['pred_mask'] & flat['pred_mask']
        score_err = float((padded['pred_scores'][m] - flat['pred_scores'][m]).abs().max())
        box_err = float((padded['pred_boxes'][m] - flat['pred_boxes'][m]).abs().max())
        pillars = int(dev_batch['voxel_mask'].sum())
        print(f'eval_cli: padded vs flat path on the first batch ({pillars} pillars, '
              f'{int(dev_batch["point_valid_mask"].sum())} points): kept per scan '
              f'{padded["pred_mask"].sum(1).tolist()}, max score diff {score_err}, '
              f'max box diff {box_err}')
        if score_err > 2e-4 or box_err > 2e-3 or not torch.equal(
                padded['pred_labels'][m], flat['pred_labels'][m]):
            fail('eval_cli: padded and flat detections differ')

        del net, dev_batch, padded, flat

    print(f'eval_cli: {float(ret["eval_time/scans_per_s"]):.3f} scans/s over the eval loop, '
          f'{float(ret["eval_time/loader_wait_share"]):.4f} of the loop waiting on the '
          f'DataLoader ({EVAL_WORKERS} workers start for the '
          f'{n_batches} batches); past the first batch '
          f'{float(ret["eval_time/steady_scans_per_s"]):.3f} scans/s, wait share '
          f'{float(ret["eval_time/steady_loader_wait_share"]):.4f} (one batch); '
          f'Network.eval_forward (detector and post-processing) median '
          f'{float(ret["eval_time/forward_median_ms"]):.3f} ms a batch of {BATCH}, '
          f'evaluator {float(ret["eval_time/evaluator_s"]):.3f} s, main() {wall_s:.2f} s; '
          f'random weights put the NMS at its NMS_PRE_MAXSIZE cap; on {smi}')
    return launches


TRAIN_CLI_TRAIN_SCENES = 16        # the train_cli phase's KITTI tree: 16 train scenes
TRAIN_CLI_VAL_SCENES = 8           # (4 steps an epoch at batch 4) and 8 val scenes
TRAIN_CLI_WORKERS = 4
TRAIN_CLI_EPOCHS = 2               # the kernel and the plain run; the resumed run adds one


def _differ(a, b, where=''):
    """Where two checkpoint payloads (nested dicts, lists, tensors, numbers)
    differ: tensors by dtype, shape and every bit, the rest by equality."""
    import torch
    if isinstance(a, torch.Tensor):
        same = isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
        return [] if same else [where]
    if isinstance(a, dict):
        if not isinstance(b, dict) or a.keys() != b.keys():
            return [where]
        return [d for k in a for d in _differ(a[k], b[k], f'{where}.{k}')]
    if isinstance(a, (list, tuple)):
        if not isinstance(b, (list, tuple)) or len(a) != len(b):
            return [where]
        return [d for i, (x, y) in enumerate(zip(a, b)) for d in _differ(x, y, f'{where}[{i}]')]
    return [] if a == b else [where]


def train_cli_phase(smi):
    """The training entry point: a synthetic KITTI tree (16 train scenes, 8
    val) written by the port's writer, its infos and gt database by
    ``create_kitti_infos``, then ``hvpr_tpu_torch.tools.train.main`` on the
    card: hvpr.yaml at full width, batch 4 (4 steps an epoch of augmented,
    host-voxelized padded batches of 16,384 points a scan from 4
    DataLoader workers), --fix_random_seed, deterministic algorithms, the
    model's own initialization, 2 epochs with the post-train evaluation of
    the last checkpoints; then --epochs 3 with the same tag, which resumes
    from checkpoint_epoch_2.pth; then the 2 epochs again through the plain
    versions. Checks: every run ends; checkpoints 1-3 hold the optimizer
    state and it = 4, 8, 12; the resumed run starts at epoch 2, it 8, with
    the OneCycle lr of step 8; the kernel runs launch K4-K10 their
    STEP_LAUNCHES a step and K2 once an evaluated batch, never K1, K3 or
    K11; the kernel run's checkpoint_epoch_2.pth equals the plain run's bit
    for bit (weights, BN statistics, AdamW moments and steps, count); the
    evaluation writes 8 annos with the Car AP keys. Returns the kernel
    runs' launch counts."""
    import pickle
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch
    from hvpr_tpu_torch import config
    from hvpr_tpu_torch.datasets.kitti.kitti_dataset import create_kitti_infos
    from hvpr_tpu_torch.ops import _kernels
    from hvpr_tpu_torch.optimization import one_cycle_schedules
    from hvpr_tpu_torch.tools import train
    from hvpr_tpu_torch.utils.scans import build_kitti_root

    cfg = load_cfg()
    steps_per_epoch = TRAIN_CLI_TRAIN_SCENES // TRAIN_BATCH
    val_batches = -(-TRAIN_CLI_VAL_SCENES // TRAIN_BATCH)
    build_dir = Path(ROOT) / 'build'
    build_dir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        root, _ = build_kitti_root(tmp / 'kitti',
                                   n_scenes=TRAIN_CLI_TRAIN_SCENES + TRAIN_CLI_VAL_SCENES,
                                   n_train=TRAIN_CLI_TRAIN_SCENES)
        create_kitti_infos(root, root)
        with open(root / 'kitti_dbinfos_train.pkl', 'rb') as f:
            db = {str(k): len(v) for k, v in pickle.load(f).items()}
        n_crops = len(list((root / 'gt_database').glob('*.bin')))
        gt_cfg = [a for a in cfg.DATA_CONFIG.DATA_AUGMENTOR.AUG_CONFIG_LIST
                  if a['NAME'] == 'gt_sampling'][0]
        print(f'train_cli: KITTI tree, infos and gt database ({n_crops} crops, {db}) '
              f'written in {time.perf_counter() - t0:.2f} s; hvpr.yaml samples '
              f'{list(gt_cfg["SAMPLE_GROUPS"])} for CLASS_NAMES {list(cfg.CLASS_NAMES)}, so '
              f'the sampler loads and filters the database and pastes nothing, as in the '
              f'JAX package (the paste is held on the CPU against the JAX package)')
        if n_crops != 49 * TRAIN_CLI_TRAIN_SCENES or db.get('Car') != n_crops:
            fail(f'train_cli: gt database of {n_crops} crops, {db}')

        config.cfg.ROOT_DIR = tmp
        common = ['--cfg_file', CFG, '--batch_size', str(TRAIN_BATCH),
                  '--workers', str(TRAIN_CLI_WORKERS), '--fix_random_seed',
                  '--num_epochs_to_eval', '1', '--set', 'DATA_CONFIG.DATA_PATH', str(root)]
        out = tmp / 'output' / 'cfgs' / 'kitti_models' / 'hvpr'

        def run(tag, epochs):
            # under deterministic algorithms, where the plain versions'
            # scatter-adds sum in order too (the CLI leaves the switch as it
            # finds it: its kernel path needs none)
            _kernels.reset_launch_counts()
            torch.use_deterministic_algorithms(True)
            t0 = time.perf_counter()
            try:
                ret = train.main(['--epochs', str(epochs), '--extra_tag', tag] + common)
            finally:
                torch.use_deterministic_algorithms(False)
            torch.cuda.synchronize()
            return ret, _kernels.launch_counts(), time.perf_counter() - t0

        def evaluated(tag):
            return (out / tag / 'eval' / 'eval_with_train' / 'eval_list_val.txt'
                    ).read_text().split()

        # the main path, counts from zero before each run
        torch.cuda.reset_peak_memory_stats()
        first, launches1, wall1 = run('kernels', TRAIN_CLI_EPOCHS)
        peak = torch.cuda.max_memory_allocated()
        evals1 = evaluated('kernels')
        resumed, launches2, wall2 = run('kernels', TRAIN_CLI_EPOCHS + 1)
        evals2 = evaluated('kernels')[len(evals1):]
        print(f'train_cli path launches: {launches1} (epochs 1-2, evaluated {evals1}); '
              f'{launches2} (resumed, epoch 3, evaluated {evals2})')
        for launches, steps, evals in ((launches1, TRAIN_CLI_EPOCHS * steps_per_epoch, evals1),
                                       (launches2, steps_per_epoch, evals2)):
            for name, n in without_iou(launches).items():
                want = STEP_LAUNCHES.get(name, 0) * steps
                if name == 'memory_lookup':
                    want = len(evals) * val_batches
                if n != want:
                    fail(f'the train_cli path launched {name} {n} times, expected {want}')
        if evals1 != ['1', '2'] or evals2 != ['3']:
            fail(f'train_cli: evaluated {evals1}, then {evals2}')

        with _kernels.plain_versions():
            plain, _, wall_plain = run('plain', TRAIN_CLI_EPOCHS)

        blobs = {}
        for tag, epoch in (('kernels', 1), ('kernels', 2), ('kernels', 3), ('plain', 2)):
            path = out / tag / 'ckpt' / f'checkpoint_epoch_{epoch}.pth'
            if not path.exists():
                fail(f'train_cli: {path.name} of the {tag} run is missing')
            blobs[tag, epoch] = torch.load(path, map_location='cpu', weights_only=True)
            blob = blobs[tag, epoch]
            if blob['epoch'] != epoch or blob['it'] != epoch * steps_per_epoch \
                    or blob['optimizer_state'] is None \
                    or blob['optimizer_state']['count'] != epoch * steps_per_epoch:
                fail(f'train_cli: {tag} checkpoint_epoch_{epoch}.pth holds epoch '
                     f'{blob["epoch"]}, it {blob["it"]}')
        print(f'train_cli: checkpoint_epoch_{{1,2,3}}.pth hold it 4, 8, 12 and the optimizer '
              f'state ({len(blobs["kernels", 2]["model_state"])} weight and statistic tensors)')

        oc = cfg.OPTIMIZATION
        lr_fn, _ = one_cycle_schedules(
            float(oc.LR), steps_per_epoch * (TRAIN_CLI_EPOCHS + 1), moms=tuple(oc.MOMS),
            div_factor=float(oc.DIV_FACTOR), pct_start=float(oc.PCT_START))
        logs = ''.join(p.read_text() for p in (out / 'kernels').glob('log_train_*.txt'))
        if (resumed['start_epoch'], resumed['start_it']) != (2, 8) \
                or resumed['first_lr'] != lr_fn(8) or '(epoch 2, it 8)' not in logs:
            fail(f'train_cli: the resumed run started at epoch {resumed["start_epoch"]}, '
                 f'it {resumed["start_it"]}, lr {resumed["first_lr"]!r} (want 2, 8, '
                 f'{lr_fn(8)!r})')
        print(f'train_cli: the resumed run started from checkpoint_epoch_2.pth at epoch 2, '
              f'it 8, OneCycle lr {resumed["first_lr"]!r} = lr_fn(8)')

        differ = _differ(blobs['kernels', 2], blobs['plain', 2])
        if differ:
            fail(f'train_cli: the kernel run\'s checkpoint_epoch_2.pth differs from the plain '
                 f'run\'s in {differ[:5]}')
        n_opt = len(blobs['kernels', 2]['optimizer_state']['adamw']['state'])
        print(f'train_cli: checkpoint_epoch_2.pth of the kernel run equals the plain run\'s '
              f'bit for bit (weights, BN statistics, the AdamW state of {n_opt} parameters, '
              f'count {blobs["kernels", 2]["optimizer_state"]["count"]}), over '
              f'{TRAIN_CLI_EPOCHS * steps_per_epoch} steps')

        want_keys = {f'Car_{m}/{d}{r}' for m in ('3d', 'bev', 'image')
                     for d in ('easy', 'moderate', 'hard') for r in ('', '_R40')}
        for ret in (first, resumed, plain):
            if not want_keys <= set(ret['eval'] or {}):
                fail('train_cli: the post-train evaluation lacks the Car AP keys')
        with open(out / 'kernels' / 'eval' / 'eval_with_train' / 'epoch_2' / 'val'
                  / 'result.pkl', 'rb') as f:
            annos = pickle.load(f)
        if len(annos) != TRAIN_CLI_VAL_SCENES:
            fail(f'train_cli: result.pkl holds {len(annos)} annos')
        boxes = np.concatenate([a['boxes_lidar'] for a in annos])
        if not np.isfinite(boxes).all():
            fail('train_cli: non-finite boxes')
        per_scan = [len(a['name']) for a in annos]
        losses = [json.loads(x) for x in (out / 'kernels' / 'train_log.jsonl').read_text()
                  .splitlines()]

    def t(ret):
        return (f'{ret["train_time/scans_per_s"]:.3f} scans/s over the loop, '
                f'{ret["train_time/steady_scans_per_s"]:.3f} past its first batch; '
                f'DataLoader wait share {ret["train_time/loader_wait_share"]:.4f}, '
                f'{ret["train_time/steady_loader_wait_share"]:.4f} past its first batch; '
                f'Network.train_step median {ret["train_time/step_median_ms"]:.3f} ms '
                f'(CUDA events, {ret["train_time/steps"]} steps)')
    print(f'train_cli: epochs 1-2 through the kernels: {t(first)}; main() {wall1:.2f} s; '
          f'peak device memory {peak / 2**30:.3f} GiB (training and evaluation); on {smi}')
    print(f'train_cli: resumed epoch 3: {t(resumed)}; main() {wall2:.2f} s; on {smi}')
    print(f'train_cli: epochs 1-2 through the plain versions: {t(plain)}; main() '
          f'{wall_plain:.2f} s; on {smi}')
    print('train_cli: train_log.jsonl: ' + '; '.join(
        f'it {x["it"]} loss {x["loss"]:.6g} lr {x["lr"]:.6g} grad_norm {x["grad_norm"]:.6g}'
        for x in losses))
    print(f'train_cli: post-train evaluation of checkpoint_epoch_2.pth: {len(annos)} annos, '
          f'detections per scan {per_scan}, Car 3d AP moderate '
          f'{float(first["eval"]["Car_3d/moderate"]):.4f} (8 steps from the model\'s '
          f'initialization), eval loop {float(first["eval"]["eval_time/scans_per_s"]):.3f} '
          f'scans/s; on {smi}')
    return {k: launches1[k] + launches2[k] for k in launches1}


MULTICLASS_CFG = 'tools/cfgs/kitti_models/hvpr_multiclass.yaml'
MULTICLASS_STEPS = 2               # timed fused steps of hvpr_multiclass.yaml
POINTPILLAR_CFG = 'tools/cfgs/kitti_models/pointpillar.yaml'
POINTPILLAR_STEPS = 3              # timed train steps of pointpillar.yaml
NUSC_CFG = 'tools/cfgs/nuscenes_models/pointpillar_nuscenes.yaml'
NUSC_BATCH = 4
NUSC_TRAIN_SCENES = 4              # the nuscenes phase's tree: 4 train samples (20 infos
NUSC_VAL_SCENES = 8                # after the balanced resampling, 5 steps) and 8 val
NUSC_WORKERS = 4
NUSC_BOX_STD = 0.001               # the box head's seeded weights (seed_weights)


def multiclass_phase(smi):
    """hvpr_multiclass.yaml (Car, Pedestrian, Cyclist; per-class NMS; f32,
    the fused train mode, as shipped): the flat pipeline at batch 8 on
    ``realistic_scans(seed 0)`` with K1-K3 held to their plain versions and
    its detections to the plain pipeline's, then one fused train step at
    batch 4 with K4-K10 captured and held to their plain versions, the step
    to a plain step bit for bit under deterministic algorithms, and
    MULTICLASS_STEPS timed steps. Returns (the pipeline's launch counts,
    the timed steps')."""
    import numpy as np
    import torch
    from hvpr_tpu_torch.utils.scans import realistic_scans

    cfg = load_cfg(path=MULTICLASS_CFG)
    points = torch.from_numpy(realistic_scans(np.random.default_rng(0), BATCH, N_POINTS,
                                              cfg.DATA_CONFIG.POINT_CLOUD_RANGE)).cuda()
    mask = torch.ones(BATCH, N_POINTS, dtype=torch.bool, device='cuda')
    _, _, _, launches, _ = flat_phase(smi, 'multiclass', cfg, points, mask, INFER_KERNELS)
    _, train_launches, _, _ = train_phase(smi, 'fused', cfg_path=MULTICLASS_CFG,
                                          n_steps=MULTICLASS_STEPS)
    return launches, train_launches


def pointpillar_phase(smi):
    """pointpillar.yaml (grid 440 x 500, 16,000 pillars of 32 points, the
    64/128/256 -> 384 backbone): the flat pipeline at batch 8 on
    ``realistic_scans(seed 0)`` with K1 and K3 held to their plain versions
    and its detections to the plain pipeline's, then POINTPILLAR_STEPS
    train steps at batch 4 on ``realistic_scans_with_boxes(seed 0)``, which
    launch no kernel (the plain sweeps and scatter under autograd, as in
    the JAX package), with the step's peak memory. Returns (the pipeline's
    launch counts, the train steps')."""
    import numpy as np
    import torch
    from hvpr_tpu_torch.models import DatasetMeta, build_network
    from hvpr_tpu_torch.ops import _kernels
    from hvpr_tpu_torch.utils.scans import realistic_scans, realistic_scans_with_boxes

    cfg = load_cfg(path=POINTPILLAR_CFG)
    pcr = cfg.DATA_CONFIG.POINT_CLOUD_RANGE
    points = torch.from_numpy(realistic_scans(np.random.default_rng(0), BATCH, N_POINTS,
                                              pcr)).cuda()
    mask = torch.ones(BATCH, N_POINTS, dtype=torch.bool, device='cuda')
    net, _, _, launches, _ = flat_phase(smi, 'pointpillar', cfg, points, mask,
                                        ('segment_sweep', 'bev_canvas'))
    print(f'pointpillar: grid {net.dataset.grid_size.tolist()}, {net.dataset.max_voxels} '
          f'pillars of {net.dataset.max_points_per_voxel} points, backbone '
          f'{list(cfg.MODEL.BACKBONE_2D.NUM_FILTERS)} -> '
          f'{net.module.backbone_2d.num_bev_features} channels')
    del net

    meta = DatasetMeta(cfg.DATA_CONFIG, cfg.CLASS_NAMES, mode='train')
    net = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), meta, device='cuda', train=True)
    if net.module.backbone_3d is not None:
        fail('pointpillar: the train network has a point stream')
    seed_weights(net.module, seed=0)
    net.init_training(cfg.OPTIMIZATION, TOTAL_STEPS)
    pts, gt = realistic_scans_with_boxes(np.random.default_rng(0), TRAIN_BATCH, N_POINTS, pcr)
    mask = torch.ones(TRAIN_BATCH, N_POINTS, dtype=torch.bool, device='cuda')
    batch = dict(net.voxelize(torch.from_numpy(pts).cuda(), mask),
                 gt_boxes=torch.from_numpy(gt).cuda())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    times, metrics = [], []
    for _ in range(POINTPILLAR_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = net.train_step(batch)
        metrics.append({k: float(v) for k, v in m.items()})     # synchronizes
        times.append(time.perf_counter() - t0)
    train_launches = _kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f'pointpillar train path launches in {POINTPILLAR_STEPS} steps: {train_launches}')
    if any(without_iou(train_launches).values()):
        fail('the pointpillar train step launched a kernel (it runs the plain versions '
             'under autograd)')
    for m in metrics:
        if not all(np.isfinite(v) for v in m.values()):
            fail(f'pointpillar: non-finite train metrics {m}')
        zero = [k for k in ('rpn_loss_cls_pt', 'rpn_loss_loc_pt', 'rpn_loss_dir_pt',
                            'mem_loss') if m[k] != 0.0]
        if zero:
            fail(f'pointpillar: {zero} are not zero without a point stream')
    print(f'pointpillar train step: losses {[m["loss"] for m in metrics]}; median of '
          f'{POINTPILLAR_STEPS} {statistics.median(times) * 1e3:.3f} ms per batch of '
          f'{TRAIN_BATCH} (the first included), peak memory {peak / 2**30:.3f} GiB, '
          f'{sum(p.numel() for p in net.module.parameters())} parameters, on {smi}')
    return launches, train_launches


def nuscenes_phase(smi):
    """pointpillar_nuscenes.yaml (grid 512 x 512, 30,000 pillars of 20
    points, 5 classes, 5-channel points of 10 sweeps) on a synthetic tree
    of NUSC_TRAIN_SCENES train and NUSC_VAL_SCENES val samples written by
    ``utils.scans.build_nuscenes_root`` (34,000 points a sweep): the flat
    pipeline at batch 4 on the first val frames as the data layer reads
    them, with K1 (max_seg 20) and K3 (512 x 512 x 64) held to their plain
    versions, their bounds and K3's yardstick, the detections held to the
    plain pipeline's; then the test CLI (batch 4, NUSC_WORKERS workers,
    padded pillars, --save_to_file) and the train CLI (1 epoch at batch 4,
    then its evaluation) on the tree, through ``--device cuda``. Checks:
    annos of every val frame, one submission file a frame, the
    centre-distance AP string in the log, the checkpoint, and no kernel
    launched by the padded CLIs (the plain VFE and scatter, as in the JAX
    package). Returns ({kernel: entry} of K1 and K3 at these shapes, the
    pipeline's launch counts, the CLIs')."""
    import pickle
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch
    from hvpr_tpu_torch import config
    from hvpr_tpu_torch.datasets.nuscenes.nuscenes_dataset import NuScenesDataset
    from hvpr_tpu_torch.models import build_network
    from hvpr_tpu_torch.ops import _kernels
    from hvpr_tpu_torch.tools import test as test_cli, train
    from hvpr_tpu_torch.utils.checkpoint import save_checkpoint
    from hvpr_tpu_torch.utils.scans import build_nuscenes_root

    cfg = load_cfg(path=NUSC_CFG)
    build_dir = Path(ROOT) / 'build'
    build_dir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        root = build_nuscenes_root(tmp / 'nuscenes', n_train=NUSC_TRAIN_SCENES,
                                   n_val=NUSC_VAL_SCENES)
        print(f'nuscenes: tree of {NUSC_TRAIN_SCENES} train and {NUSC_VAL_SCENES} val samples '
              f'({cfg.DATA_CONFIG.MAX_SWEEPS} sweeps of 34,000 points each) written in '
              f'{time.perf_counter() - t0:.2f} s')

        test_set = NuScenesDataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES, training=False,
                                   root_path=root)
        host = test_set.collate_batch([test_set[i] for i in range(NUSC_BATCH)])
        points = torch.from_numpy(host['points']).cuda()
        mask = torch.from_numpy(host['point_valid_mask']).cuda()
        print(f'nuscenes: points a frame {host["point_valid_mask"].sum(1).tolist()} '
              f'({points.shape[2]} channels, time lags '
              f'{np.unique(host["points"][0, :, 4]).round(3).tolist()})')
        net, calls, entries, launches, _ = flat_phase(
            smi, 'nuscenes', cfg, points, mask, ('segment_sweep', 'bev_canvas'), reps=3,
            box_std=NUSC_BOX_STD)
        sweep_segs = {a[2] for a, _ in calls['segment_sweep']}
        canvas = {(a[3], a[4], a[0].shape[2]) for a, _ in calls['bev_canvas']}
        if sweep_segs != {20} or canvas != {(512, 512, 64)}:
            fail(f'nuscenes: K1 at max_seg {sweep_segs}, K3 at {canvas}')
        entries['segment_sweep'].update(_sweep_bound(calls['segment_sweep']))
        entries['bev_canvas'].update(_canvas_bound_and_yardstick(calls['bev_canvas'],
                                                                 ' (nuscenes)'))
        entries['rotated_iou'].update(_iou_bound_and_share(calls['rotated_iou'], ' (nuscenes)'))
        del net, calls, points, mask

        # the test CLI: a .pth of seeded weights, padded pillars from the workers
        writer = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), test_set, device='cpu')
        seed_weights(writer.module, seed=0, box_std=NUSC_BOX_STD)
        ckpt = tmp / 'checkpoint_epoch_1.pth'
        save_checkpoint(writer.module, ckpt, epoch=1)
        config.cfg.ROOT_DIR = tmp
        out = tmp / 'output' / 'cfgs' / 'nuscenes_models' / 'pointpillar_nuscenes' / 'nusc'
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        ret = test_cli.main(['--cfg_file', NUSC_CFG, '--ckpt', str(ckpt), '--batch_size',
                             str(NUSC_BATCH), '--workers', str(NUSC_WORKERS), '--extra_tag',
                             'nusc', '--save_to_file', '--set', 'DATA_CONFIG.DATA_PATH',
                             str(root)])
        eval_s = time.perf_counter() - t0
        cli_launches = _kernels.launch_counts()
        eval_dir = out / 'eval' / 'epoch_1' / 'val' / 'default'
        with open(eval_dir / 'result.pkl', 'rb') as f:
            annos = pickle.load(f)
        rows = sorted((eval_dir / 'final_result' / 'data').glob('*.json'))
        log = ''.join(p.read_text() for p in eval_dir.glob('log_eval_*.txt'))
        if len(annos) != NUSC_VAL_SCENES or len(rows) != NUSC_VAL_SCENES:
            fail(f'nuscenes test CLI: {len(annos)} annos, {len(rows)} submission files')
        if 'center-distance AP' not in log or 'mAP' not in ret:
            fail('nuscenes test CLI: no centre-distance AP')
        frame = json.loads(rows[0].read_text())
        if not frame or {r['detection_name'] for r in frame} - set(cfg.CLASS_NAMES):
            fail(f'nuscenes test CLI: submission rows {frame[:1]}')
        ap_str = log[log.index('center-distance AP'):].split('\n')
        print('nuscenes test CLI: ' + ' | '.join(ap_str[:len(cfg.CLASS_NAMES) + 2]))
        print(f'nuscenes test CLI: {len(annos)} annos, detections per frame '
              f'{[len(a["name"]) for a in annos]}, {len(frame)} submission rows in '
              f'{rows[0].name}; {ret["eval_time/scans_per_s"]:.3f} scans/s over the loop, '
              f'{ret["eval_time/loader_wait_share"]:.4f} waiting on the DataLoader '
              f'({NUSC_WORKERS} workers; past the first batch '
              f'{ret.get("eval_time/steady_scans_per_s", float("nan")):.3f} scans/s, '
              f'{ret.get("eval_time/steady_loader_wait_share", float("nan")):.4f}), forward '
              f'median {ret["eval_time/forward_median_ms"]:.3f} ms a batch of {NUSC_BATCH}, '
              f'evaluator {ret["eval_time/evaluator_s"]:.3f} s, main() {eval_s:.2f} s; '
              f'launches {({k: v for k, v in cli_launches.items() if v})} on {smi}')

        # the train CLI: one epoch, then the evaluation of its checkpoint
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        tret = train.main(['--cfg_file', NUSC_CFG, '--batch_size', str(NUSC_BATCH),
                           '--epochs', '1', '--workers', str(NUSC_WORKERS), '--extra_tag',
                           'nusc', '--num_epochs_to_eval', '1', '--set',
                           'DATA_CONFIG.DATA_PATH', str(root)])
        train_s = time.perf_counter() - t0
        train_launches = _kernels.launch_counts()
        if not (out / 'ckpt' / 'checkpoint_epoch_1.pth').exists():
            fail('nuscenes train CLI: no checkpoint_epoch_1.pth')
        if 'mAP' not in (tret['eval'] or {}):
            fail('nuscenes train CLI: the post-train evaluation has no mAP')
        losses = [json.loads(x) for x in (out / 'train_log.jsonl').read_text().splitlines()]
        if not all(np.isfinite(x['loss']) for x in losses):
            fail(f'nuscenes train CLI: non-finite loss {losses}')
        print(f'nuscenes train CLI: {tret["train_time/steps"]} steps, '
              f'{tret["train_time/scans_per_s"]:.3f} scans/s over the loop, '
              f'{tret["train_time/loader_wait_share"]:.4f} waiting on the DataLoader '
              f'({NUSC_WORKERS} workers), Network.train_step median '
              f'{tret["train_time/step_median_ms"]:.3f} ms; post-train mAP '
              f'{tret["eval"]["mAP"]:.4f}; main() {train_s:.2f} s; launches '
              f'{({k: v for k, v in train_launches.items() if v})} on {smi}')
        for name, n in without_iou({**cli_launches, **train_launches}).items():
            if n:
                fail(f'the nuscenes CLIs launched {name} (padded pillars take the plain '
                     f'VFE and scatter)')
    return entries, launches, {k: cli_launches[k] + train_launches[k] for k in cli_launches}


DDP_RANKS = 2                      # the ddp phase: 2 ranks, both on card 0 over gloo
DDP_STEPS = 2                      # (a): steps of 2 + 2 scans of the fused batch
DDP_CLI_TRAIN_SCENES = 8           # (b), (c): 2 steps an epoch at global batch 4
DDP_CLI_VAL_SCENES = 8
DDP_CLI_EPOCHS = 2
DDP_CLI_WORKERS = 2                # DataLoader workers a rank
DDP_TIMED_STEPS = 3                # (a): warm steps timed after the checked ones
# (a)'s yardstick is one process's own noise: the same step on the same 4
# scans in another order, which moves only the BatchNorms' sums, as 2 ranks
# do. hvpr.yaml runs its point stream, backbone and head in bf16, where an
# f32-ulp change flips roundings and the attention's selections: on an
# H100 80GB HBM3 (700 W) that reordering alone moves a loss term by up to
# 2.3e-3 after one step and 9.4e-3 after two, and leaves 88.8% of the
# weights within 1e-6 relative after one step. The 2-rank step must stay
# within NOISE_MARGIN times it: the largest relative difference of a loss
# term or grad_norm, and of a running statistic (over its tensor's largest
# magnitude), at most NOISE_MARGIN times the reordered step's; the share of
# weights within 0.1 lr at least the reordered step's less SHARE_MARGIN.
# (tests/test_torch_port_ddp.py holds hvpr_mini.yaml, in f32, to rtol 1e-5.)
NOISE_MARGIN, SHARE_MARGIN = 2.0, 0.02


def _card_flags():
    """The flags ``run_phases`` sets, in a spawned rank too."""
    import torch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def _cpu_state(net):
    """The module's state_dict and the optimizer's, on the host."""
    import torch
    opt = net.train_state.optimizer.state_dict()
    to_cpu = lambda x: x.detach().cpu().clone() if isinstance(x, torch.Tensor) else x
    return ({k: to_cpu(v) for k, v in net.module.state_dict().items()},
            {'count': opt['count'], 'adamw': {
                'state': {i: {k: to_cpu(v) for k, v in st.items()}
                          for i, st in opt['adamw']['state'].items()},
                'param_groups': opt['adamw']['param_groups']}})


def _ddp_step_rank(rank, world, device, state0_path, out_dir):
    """(a) on one rank: hvpr.yaml fused, seed_weights loaded on rank 0 only
    (rank 1 starts from its own initialization: the broadcast gives it rank
    0's), this rank's 2 of the fused batch's 4 scans, DDP_STEPS steps with
    launch counts from zero, the whole run twice from the same state (no
    deterministic algorithms), then DDP_TIMED_STEPS timed steps (CUDA
    events) and the gradient all-reduce alone."""
    import numpy as np
    import torch
    from hvpr_tpu_torch.models import DatasetMeta, build_network
    from hvpr_tpu_torch.ops import _kernels
    from hvpr_tpu_torch.parallel import average_over_ranks, broadcast_state
    from hvpr_tpu_torch.utils.scans import realistic_scans_with_boxes

    cfg = load_cfg()
    meta = DatasetMeta(cfg.DATA_CONFIG, cfg.CLASS_NAMES, mode='train')
    net = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), meta, device=device, train=True)
    state0 = torch.load(state0_path, map_location=device, weights_only=True)
    pts, gt = realistic_scans_with_boxes(np.random.default_rng(0), TRAIN_BATCH, N_POINTS,
                                         meta.point_cloud_range)
    b = TRAIN_BATCH // world
    share = slice(rank * b, (rank + 1) * b)
    mask = torch.ones(b, N_POINTS, dtype=torch.bool, device=device)
    batch = dict(net.voxelize(torch.from_numpy(pts[share]).to(device), mask),
                 gt_boxes=torch.from_numpy(gt[share]).to(device))
    runs = []
    for _ in range(2):
        if rank == 0:
            net.module.load_state_dict(state0)
        broadcast_state(net.module)
        net.init_training(cfg.OPTIMIZATION, TOTAL_STEPS)
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        _kernels.reset_launch_counts()
        metrics, states = [], []
        for _ in range(DDP_STEPS):
            metrics.append({k: float(v) for k, v in net.train_step(batch).items()})
            states.append(_cpu_state(net)[0])
        torch.cuda.synchronize(device)
        state, opt = _cpu_state(net)
        runs.append({'metrics': metrics, 'states': states, 'state': state, 'optimizer': opt,
                     'launches': _kernels.launch_counts(),
                     'peak': torch.cuda.max_memory_allocated(device),
                     'pillars': int(batch['voxel_mask'].sum())})
    repeat_differ = _differ(runs[0]['state'], runs[1]['state'], 'state') \
        + _differ(runs[0]['optimizer'], runs[1]['optimizer'], 'optimizer') \
        + ([] if runs[0]['metrics'] == runs[1]['metrics'] else ['metrics'])
    events = []
    for _ in range(DDP_TIMED_STEPS):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        net.train_step(batch)
        end.record()
        events.append((start, end))
    torch.cuda.synchronize(device)
    runs[0]['step_ms'] = [s.elapsed_time(e) for s, e in events]
    grads = [torch.randn_like(p) for p in net.train_state.optimizer.params]
    reduce_ms = []
    for _ in range(7):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        average_over_ranks(grads)
        torch.cuda.synchronize(device)
        reduce_ms.append((time.perf_counter() - t0) * 1e3)
    torch.save(dict(runs[0], repeat_differ=repeat_differ,
                    allreduce_ms=statistics.median(reduce_ms[2:]),
                    allreduce_bytes=sum(g.numel() * g.element_size() for g in grads)),
               os.path.join(out_dir, f'step_rank{rank}.pt'))


def _ddp_cli_rank(rank, device, root, out_dir):
    """(b) on one rank: the train CLI (--launcher pytorch, the group made
    already) for DDP_CLI_EPOCHS epochs at global batch 4, this rank's state
    when training ends kept, then the test CLI over the ranks on rank 0's
    last checkpoint."""
    from pathlib import Path

    import torch
    from hvpr_tpu_torch import config
    from hvpr_tpu_torch.ops import _kernels
    from hvpr_tpu_torch.tools import test, train, train_utils

    config.cfg.ROOT_DIR = os.path.join(out_dir, 'cli')
    launch = ['--launcher', 'pytorch', '--local_rank', str(device.index)]
    common = ['--cfg_file', CFG, '--batch_size', str(TRAIN_BATCH),
              '--workers', str(DDP_CLI_WORKERS), '--extra_tag', 'ddp',
              '--set', 'DATA_CONFIG.DATA_PATH', root]
    captured = {}

    def keep_state(net, *args, **kwargs):
        out = train_utils.train_model(net, *args, **kwargs)
        captured['state'], captured['optimizer'] = _cpu_state(net)
        return out

    train.train_model = keep_state
    _kernels.reset_launch_counts()
    try:
        ret = train.main(launch + ['--epochs', str(DDP_CLI_EPOCHS), '--fix_random_seed',
                                   '--num_epochs_to_eval', '1'] + common)
    finally:
        train.train_model = train_utils.train_model
    train_launches = _kernels.launch_counts()
    ckpt = next(Path(config.cfg.ROOT_DIR).glob(
        f'output/**/ddp/ckpt/checkpoint_epoch_{DDP_CLI_EPOCHS}.pth'))
    test_ret = test.main(launch + ['--ckpt', str(ckpt), '--save_to_file'] + common)
    torch.save(dict(captured, train=ret, test=test_ret, train_launches=train_launches),
               os.path.join(out_dir, f'cli_rank{rank}.pt'))


def _ddp_rank(rank, world, backend, store, state0_path, root, out_dir):
    """One rank of the ddp phase, spawned: joins the group (``file://``
    store), then (a) and, over gloo, (b)."""
    import torch
    import torch.distributed as dist
    from hvpr_tpu_torch.datasets import stop_worker_server

    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    _card_flags()
    device = torch.device('cuda', rank if backend == 'nccl' else 0)
    torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f'file://{store}', rank=rank,
                            world_size=world)
    try:
        _ddp_step_rank(rank, world, device, state0_path, out_dir)
        if backend == 'gloo':
            _ddp_cli_rank(rank, device, root, out_dir)
        dist.barrier()
    finally:
        stop_worker_server()
        dist.destroy_process_group()


def _weight_agreement(got, want, lr):
    """How close ``got``'s weights and BN statistics are to ``want``'s: (the
    share of the weights within 1e-6 relative (+1e-7), the share within
    0.1 ``lr``, the largest difference of a running statistic over the
    tensor's largest magnitude)."""
    import torch
    diffs, within, stats = [], [], 0.0
    for k, w in want.items():
        if 'num_batches' in k:
            continue
        g, w = got[k].double(), w.double()
        if 'running' in k:
            stats = max(stats, float((g - w).abs().max() / w.abs().max().clamp_min(1e-30)))
            continue
        diffs.append((g - w).abs().reshape(-1))
        within.append(diffs[-1] <= 1e-7 + 1e-6 * w.abs().reshape(-1))
    d = torch.cat(diffs)
    return (float(torch.cat(within).double().mean()), float((d <= 0.1 * lr).double().mean()),
            stats)


def ddp_phase(smi):
    """Data-parallel training and evaluation over DDP_RANKS processes
    (``hvpr_tpu_torch.parallel``, ``--launcher pytorch``). Two ranks share
    the one card over gloo: they measure correctness and the overhead of
    the exchange, not scaling.

    (a) hvpr.yaml fused, the fused batch's 4 scans as 2 + 2 on two ranks,
    DDP_STEPS steps from seed_weights (rank 0's, broadcast): the loss terms
    and grad_norm, the weights and BN statistics after each step within
    one process's own noise on the 4 scans (NOISE_MARGIN: against one
    process's steps on them, at most twice as far as one process's steps on
    the same scans in another order), the ranks bit-equal (weights, BN statistics, AdamW state), each rank's run
    repeated from the same state bit for bit without deterministic
    algorithms, each rank launching the train kernels STEP_LAUNCHES a step.
    With two cards or more, (a) runs over NCCL too (a rank a card).
    (b) the train CLI over the two ranks (gloo) on a tree of 8 train and 8
    val scenes, DDP_CLI_EPOCHS epochs of 2 steps at global batch 4: one set
    of checkpoints (rank 0's), the ranks bit-equal when training ends and
    equal to the last checkpoint, the post-train evaluation reading each
    val scene once; then the test CLI over the two ranks on the last
    checkpoint gives one process's annos (boxes 1e-4, scores 1e-5, as
    tests/test_torch_port_cli.py) and result string.
    (c) ``torchrun --nproc_per_node <cards>`` of the train CLI with
    ``--launcher pytorch`` over NCCL, DDP_CLI_EPOCHS epochs of 2 steps: it
    must exit 0 and write a checkpoint an epoch
    (on one card a group of one: the NCCL init, the broadcast and the
    all-reduces on the real backend).
    Returns rank 0's launch counts of (a)'s gloo run."""
    import copy
    import pickle
    import re
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch
    import torch.multiprocessing as mp
    from hvpr_tpu_torch.datasets.kitti.kitti_dataset import create_kitti_infos
    from hvpr_tpu_torch.datasets.kitti.kitti_object_eval_python.eval import (
        get_official_eval_result)
    from hvpr_tpu_torch.models import DatasetMeta, build_network
    from hvpr_tpu_torch.ops import _kernels
    from hvpr_tpu_torch.utils.scans import build_kitti_root, realistic_scans_with_boxes

    cards = torch.cuda.device_count()
    print(f'ddp: {DDP_RANKS} ranks on {cards} card(s); two ranks on one card measure '
          f'correctness and the exchange\'s overhead, not scaling')
    cfg = load_cfg()
    # the one-process reference: the same weights and 4 scans, DDP_STEPS steps
    meta = DatasetMeta(cfg.DATA_CONFIG, cfg.CLASS_NAMES, mode='train')
    net = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), meta, device='cuda', train=True)
    seed_weights(net.module, seed=0)
    state0 = {k: v.clone() for k, v in net.module.state_dict().items()}
    pts, gt = realistic_scans_with_boxes(np.random.default_rng(0), TRAIN_BATCH, N_POINTS,
                                         meta.point_cloud_range)
    mask = torch.ones(TRAIN_BATCH, N_POINTS, dtype=torch.bool, device='cuda')

    def one_process(order, timed=0):
        """DDP_STEPS steps on the 4 scans in ``order``, then ``timed`` more:
        (metrics, states, the timed steps' ms by CUDA events)."""
        batch = dict(net.voxelize(torch.from_numpy(pts[order]).cuda(), mask),
                     gt_boxes=torch.from_numpy(gt[order]).cuda())
        net.module.load_state_dict(state0)
        net.init_training(cfg.OPTIMIZATION, TOTAL_STEPS)
        metrics, states, ms = [], [], []
        for _ in range(DDP_STEPS):
            metrics.append({k: float(v) for k, v in net.train_step(batch).items()})
            states.append(_cpu_state(net)[0])
        for _ in range(timed):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            net.train_step(batch)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
        return metrics, states, ms

    ref_metrics, ref_states, ref_ms = one_process([0, 1, 2, 3], timed=DDP_TIMED_STEPS)
    # the noise floor: the same scans in another order, which changes only
    # the order of the BatchNorms' sums, as two ranks do
    floor_metrics, floor_states, _ = one_process([2, 3, 0, 1])
    lr = [net.train_state.optimizer.lr_fn(i) for i in range(DDP_STEPS)]
    del net
    torch.cuda.empty_cache()

    build_dir = Path(ROOT) / 'build'
    build_dir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        tmp = Path(tmp)
        torch.save(state0, tmp / 'state0.pth')
        del state0
        root, _ = build_kitti_root(tmp / 'kitti',
                                   n_scenes=DDP_CLI_TRAIN_SCENES + DDP_CLI_VAL_SCENES,
                                   n_train=DDP_CLI_TRAIN_SCENES)
        create_kitti_infos(root, root)
        backends = ['gloo'] + (['nccl'] if cards >= DDP_RANKS else [])
        outs = {}
        for backend in backends:
            out_dir = tmp / backend
            out_dir.mkdir()
            t0 = time.perf_counter()
            mp.start_processes(_ddp_rank, args=(DDP_RANKS, backend, str(tmp / f'store_{backend}'),
                                                str(tmp / 'state0.pth'), str(root), str(out_dir)),
                               nprocs=DDP_RANKS, start_method='spawn')
            print(f'ddp ({backend}): the ranks ran in {time.perf_counter() - t0:.1f} s')
            outs[backend] = [torch.load(out_dir / f'step_rank{r}.pt', weights_only=False)
                             for r in range(DDP_RANKS)]

        # (a)
        for backend, ranks in outs.items():
            where = f'ddp (a, {backend})'
            for i, (got, want) in enumerate(zip(ranks[0]['metrics'], ref_metrics)):
                print(f'{where}: step {i + 1}, 2 ranks / one process / one process on the '
                      f'scans in another order: ' + ', '.join(
                          f'{k} {got[k]:.9g}/{v:.9g}/{floor_metrics[i][k]:.9g}'
                          for k, v in sorted(want.items())))
                rel, rel_floor = (max(abs(m[k] - v) / max(abs(v), 1e-30)
                                      for k, v in want.items())
                                  for m in (got, floor_metrics[i]))
                agree = _weight_agreement(ranks[0]['states'][i], ref_states[i], lr[i])
                agree_floor = _weight_agreement(floor_states[i], ref_states[i], lr[i])
                print(f'{where}: step {i + 1} against one process, 2 ranks / the reordered '
                      f'step: largest relative difference of a loss term or grad_norm '
                      f'{rel:.3g} / {rel_floor:.3g}; weights within 1e-6 relative '
                      f'{agree[0]:.6f} / {agree_floor[0]:.6f}, within 0.1 lr {agree[1]:.6f} / '
                      f'{agree_floor[1]:.6f}; largest running-statistic difference '
                      f'{agree[2]:.3g} / {agree_floor[2]:.3g}')
                if rel > NOISE_MARGIN * rel_floor or agree[2] > NOISE_MARGIN * agree_floor[2] \
                        or agree[1] < agree_floor[1] - SHARE_MARGIN:
                    fail(f'{where}: step {i + 1} of 2 ranks is farther from one process\'s '
                         f'than one process\'s noise allows')
            for r, out in enumerate(ranks):
                if out['repeat_differ']:
                    fail(f'{where}: rank {r}\'s second run differs from its first in '
                         f'{out["repeat_differ"][:5]}')
                for name, n in without_iou(out['launches']).items():
                    if n != STEP_LAUNCHES.get(name, 0) * DDP_STEPS:
                        fail(f'{where}: rank {r} launched {name} {n} times in {DDP_STEPS} '
                             f'steps')
            differ = _differ(ranks[0]['state'], ranks[1]['state'], 'state') + \
                _differ(ranks[0]['optimizer'], ranks[1]['optimizer'], 'optimizer')
            if differ or ranks[0]['metrics'] != ranks[1]['metrics']:
                fail(f'{where}: the ranks differ in {differ[:5]} or their metrics')
            print(f'{where}: {DDP_STEPS} steps of {TRAIN_BATCH // DDP_RANKS} + '
                  f'{TRAIN_BATCH // DDP_RANKS} scans ({ranks[0]["pillars"]} and '
                  f'{ranks[1]["pillars"]} pillars) against one process\'s on the '
                  f'{TRAIN_BATCH}: within one process\'s own noise; ranks bit-equal '
                  f'(weights, BN statistics, AdamW state); each rank\'s run repeated bit for '
                  f'bit without deterministic algorithms; launches a rank {ranks[0]["launches"]}')
            print(f'{where}: median of {DDP_TIMED_STEPS} warm steps (CUDA events) rank 0 '
                  f'{statistics.median(ranks[0]["step_ms"]):.3f} ms, rank 1 '
                  f'{statistics.median(ranks[1]["step_ms"]):.3f} ms (steps {ranks[0]["step_ms"]}); '
                  f'one process on the {TRAIN_BATCH} scans {statistics.median(ref_ms):.3f} ms '
                  f'(steps {ref_ms}); the gradient all-reduce alone {ranks[0]["allreduce_ms"]:.3f} '
                  f'ms a step (host clock) for {ranks[0]["allreduce_bytes"]} bytes '
                  f'({ranks[0]["allreduce_bytes"] // 4} f32 parameters); peak memory a rank '
                  f'{ranks[0]["peak"] / 2**30:.3f} / {ranks[1]["peak"] / 2**30:.3f} GiB; '
                  f'two ranks share {"one card" if backend == "gloo" else "no card"}: correctness '
                  f'and overhead, not scaling; on {smi}')

        # (b)
        cli = [torch.load(tmp / 'gloo' / f'cli_rank{r}.pt', weights_only=False)
               for r in range(DDP_RANKS)]
        out_root = tmp / 'gloo' / 'cli'
        ckpts = sorted(p.name for p in out_root.glob('output/**/ddp/ckpt/*.pth'))
        want_ckpts = [f'checkpoint_epoch_{e + 1}.pth' for e in range(DDP_CLI_EPOCHS)]
        if ckpts != want_ckpts:
            fail(f'ddp (b): checkpoints {ckpts}, expected {want_ckpts} (from rank 0 alone)')
        differ = _differ(cli[0]['state'], cli[1]['state'], 'state') + \
            _differ(cli[0]['optimizer'], cli[1]['optimizer'], 'optimizer')
        if differ:
            fail(f'ddp (b): the ranks differ when training ends in {differ[:5]}')
        last = torch.load(next(out_root.glob(f'output/**/ddp/ckpt/{want_ckpts[-1]}')),
                          map_location='cpu', weights_only=True)
        if _differ(last['model_state'], cli[1]['state']):
            fail('ddp (b): rank 1\'s weights differ from the last checkpoint')
        with open(root / 'kitti_infos_val.pkl', 'rb') as f:
            val_ids = [i['point_cloud']['lidar_idx'] for i in pickle.load(f)]
        evals = next(out_root.glob('output/**/ddp/eval/eval_with_train/eval_list_val.txt')
                     ).read_text().split()
        found = sorted(out_root.glob(f'output/**/ddp/eval/eval_with_train/'
                                     f'epoch_{DDP_CLI_EPOCHS}/**/result.pkl'))
        if len(found) != 1 or evals[-1] != str(DDP_CLI_EPOCHS):
            fail(f'ddp (b): post-train evaluation results {found}, evaluated {evals}')
        with open(found[0], 'rb') as f:
            if [a['frame_id'] for a in pickle.load(f)] != val_ids:
                fail('ddp (b): the post-train evaluation did not read each val scene once')
        if cli[1]['train']['eval'] or cli[1]['test'] or \
                'Car_3d/moderate' not in cli[0]['train']['eval']:
            fail('ddp (b): the evaluation\'s result is not rank 0\'s alone')
        steps = DDP_CLI_EPOCHS * DDP_CLI_TRAIN_SCENES // TRAIN_BATCH
        for r, c in enumerate(cli):
            for name, n in without_iou(c['train_launches']).items():
                want = STEP_LAUNCHES.get(name, 0) * steps
                if name == 'memory_lookup':
                    # the rank's share of the val scenes, a batch of 2 a launch
                    want = len(evals) * -(-DDP_CLI_VAL_SCENES // TRAIN_BATCH)
                if n != want:
                    fail(f'ddp (b): rank {r}\'s train CLI launched {name} {n} times, '
                         f'expected {want}')
        # the test CLI over the two ranks against one process on that checkpoint
        found = sorted(out_root.glob('output/**/ddp/eval/epoch_*/**/result.pkl'))
        if len(found) != 1:
            fail(f'ddp (b): test CLI results {found}')
        with open(found[0], 'rb') as f:
            annos2 = pickle.load(f)
        ckpt = next(out_root.glob(f'output/**/ddp/ckpt/{want_ckpts[-1]}'))
        # one process at a rank's batch size, so that cuDNN runs the same
        # algorithms on each scan (the bf16 backbone's roundings, and the
        # NMS ties of random weights, follow them)
        one = run_test_cli(tmp / 'one', root, ckpt, 'one', DDP_CLI_WORKERS,
                           batch=TRAIN_BATCH // DDP_RANKS)
        annos1, _ = _eval_result(tmp / 'one', 'one')
        bad = [(a['frame_id'], len(a['name']), len(b['name']))
               for a, b in zip(annos1, annos2)
               if a['frame_id'] != b['frame_id'] or not np.array_equal(a['name'], b['name'])
               or not np.allclose(a['boxes_lidar'], b['boxes_lidar'], rtol=0, atol=1e-4)
               or not np.allclose(a['score'], b['score'], rtol=0, atol=1e-5)]
        if len(annos1) != len(annos2) or bad:
            fail(f'ddp (b): the test CLI over two ranks gives other annos than one process '
                 f'(frame, detections one process, two ranks): {bad}')
        with open(root / 'kitti_infos_val.pkl', 'rb') as f:
            gt_annos = [i['annos'] for i in pickle.load(f)]
        strings = [get_official_eval_result(copy.deepcopy(gt_annos), copy.deepcopy(a),
                                            list(cfg.CLASS_NAMES))[0] for a in (annos1, annos2)]
        aps = [{k: v for k, v in d.items() if not k.startswith('eval_time/')}
               for d in (one, cli[0]['test'])]
        if strings[0] != strings[1] or aps[0] != aps[1]:
            fail('ddp (b): the test CLI over two ranks gives another result than one process')
        box_err = max(float(np.abs(a['boxes_lidar'] - b['boxes_lidar']).max(initial=0))
                      for a, b in zip(annos1, annos2))
        ret = cli[0]['train']
        print(f'ddp (b): the train CLI over 2 ranks (gloo, one card), {DDP_CLI_EPOCHS} epochs '
              f'of {DDP_CLI_TRAIN_SCENES // TRAIN_BATCH} steps at global batch {TRAIN_BATCH}: '
              f'checkpoints {ckpts} from rank 0, ranks bit-equal at the end and equal to '
              f'the last checkpoint, the post-train evaluation (of epochs {evals}) read each '
              f'of the {len(val_ids)} val scenes once; train_step median '
              f'{ret["train_time/step_median_ms"]:.3f} ms a rank (CUDA events); the test CLI '
              f'over 2 ranks gives one process\'s {len(annos1)} annos '
              f'({sum(len(a["name"]) for a in annos1)} detections, largest box difference '
              f'{box_err}) and result string; on {smi}')

        # (c)
        env = dict(os.environ, HVPR_ROOT_DIR=str(tmp / 'nccl_cli'))
        cmd = [sys.executable, '-m', 'torch.distributed.run', '--standalone',
               '--nproc_per_node', str(cards), '-m', 'hvpr_tpu_torch.tools.train',
               '--launcher', 'pytorch', '--cfg_file', CFG, '--batch_size', str(TRAIN_BATCH),
               '--epochs', str(DDP_CLI_EPOCHS), '--workers', str(DDP_CLI_WORKERS),
               '--fix_random_seed',
               '--num_epochs_to_eval', '1', '--extra_tag', 'nccl',
               '--set', 'DATA_CONFIG.DATA_PATH', str(root)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                              timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            print(proc.stdout[-4000:] + proc.stderr[-8000:], file=sys.stderr)
            fail(f'ddp (c): torchrun exited {proc.returncode}')
        logs = proc.stdout + proc.stderr
        median = re.findall(r'train_step median ([0-9.]+) ms', logs)
        n_ckpt = len(list((tmp / 'nccl_cli').glob('output/**/nccl/ckpt/*.pth')))
        if not median or n_ckpt != DDP_CLI_EPOCHS or 'process(es)' not in logs:
            fail(f'ddp (c): the NCCL run printed no step median or wrote {n_ckpt} checkpoints')
        print(f'ddp (c): torchrun --nproc_per_node {cards} of the train CLI over NCCL, '
              f'{DDP_CLI_EPOCHS} epochs of {DDP_CLI_TRAIN_SCENES // TRAIN_BATCH} steps: rc 0 in '
              f'{wall:.1f} s, train_step median {median[-1]} ms (CUDA events, rank 0, the '
              f'first step\'s warm-up included; a group of {cards}: the NCCL init, the '
              f'broadcast and the all-reduces); on {smi}')
    return outs['gloo'][0]['launches']


SECOND_BATCH = 4
SECOND_POINTS = 20000              # points a scan of the second phase: ~19,700 voxels,
                                   # KITTI's in-range count (16-20k)
SECOND_CAP_POINTS = 43000          # points a scan that fill the eval cap: 40,000 voxels
SECOND_TRAIN_STEPS = 2
# K14 launches a forward of VoxelBackBone8x: one rulebook a sparse conv
# (conv_input, conv1, three stages of a strided and two submanifold convs,
# conv_out)
SECOND_RULEBOOKS = 12
SECOND_BOX_STD = 0.001             # the box convs' seeded weights (the reference's init)
# card against the port's CPU forward on the same scan and weights: the
# convolutions and products sum in other orders (no TF32: both f32); allowed
# 1e-3 of the output's largest magnitude
SECOND_RTOL = 1e-3
DEMO_SCANS = 2
DEMO_POINTS = 20000                # sample_points draws hvpr.yaml's 16,384 of them


def second_cfg(head='AnchorHeadSingle', assigner='AxisAlignedTargetAssigner'):
    """The SECOND configuration of upstream OpenPCDet's
    ``tools/cfgs/kitti_models/second.yaml`` at its published widths (cited,
    not read): range [0, -40, -3, 70.4, 40, 1], voxels 0.05 x 0.05 x 0.1 m
    (1408 x 1600 x 40), 5 points a voxel, 16,000 voxels in training and
    40,000 in eval, Car / Pedestrian / Cyclist anchors at stride 8; MeanVFE
    -> sparse VoxelBackBone8x (16 -> 32/64/64 -> 128) -> HeightCompression
    (256) -> BaseBEVBackbone ([5, 5] layers, strides [1, 2], [128, 256]
    filters, upsampled [1, 2] to [256, 256]) -> ``head``, adam_onecycle.
    ``head`` AnchorHeadMulti: one RPN head a class over a 64-channel shared
    conv, as upstream's multi-head configs."""
    from hvpr_tpu_torch.config import ConfigDict
    classes = ['Car', 'Pedestrian', 'Cyclist']

    def anchor(name, size, z, matched, unmatched):
        return {'class_name': name, 'anchor_sizes': [size], 'anchor_rotations': [0, 1.57],
                'anchor_bottom_heights': [z], 'align_center': False,
                'feature_map_stride': 8, 'matched_threshold': matched,
                'unmatched_threshold': unmatched}
    dense_head = {
        'NAME': head, 'CLASS_AGNOSTIC': False, 'USE_DIRECTION_CLASSIFIER': True,
        'DIR_OFFSET': 0.78539, 'DIR_LIMIT_OFFSET': 0.0, 'NUM_DIR_BINS': 2,
        'ANCHOR_GENERATOR_CONFIG': [anchor('Car', [3.9, 1.6, 1.56], -1.78, 0.6, 0.45),
                                    anchor('Pedestrian', [0.8, 0.6, 1.73], -0.6, 0.5, 0.35),
                                    anchor('Cyclist', [1.76, 0.6, 1.73], -0.6, 0.5, 0.35)],
        'TARGET_ASSIGNER_CONFIG': {'NAME': assigner, 'TOPK': 9, 'POS_FRACTION': -1.0,
                                   'SAMPLE_SIZE': 512, 'NORM_BY_NUM_EXAMPLES': False,
                                   'MATCH_HEIGHT': False, 'BOX_CODER': 'ResidualCoder'},
        'LOSS_CONFIG': {'LOSS_WEIGHTS': {'cls_weight': 1.0, 'loc_weight': 2.0,
                                         'dir_weight': 0.2, 'code_weights': [1.0] * 7}}}
    if head == 'AnchorHeadMulti':
        dense_head['SHARED_CONV_NUM_FILTER'] = 64
        dense_head['RPN_HEAD_CFGS'] = [{'HEAD_CLS_NAME': [c]} for c in classes]
    return ConfigDict({
        'CLASS_NAMES': classes,
        'DATA_CONFIG': {
            'POINT_CLOUD_RANGE': [0, -40, -3, 70.4, 40, 1],
            'POINT_FEATURE_ENCODING': {'encoding_type': 'absolute_coordinates_encoding',
                                       'used_feature_list': ['x', 'y', 'z', 'intensity'],
                                       'src_feature_list': ['x', 'y', 'z', 'intensity']},
            'DATA_PROCESSOR': [{'NAME': 'transform_points_to_voxels',
                                'VOXEL_SIZE': [0.05, 0.05, 0.1], 'MAX_POINTS_PER_VOXEL': 5,
                                'MAX_NUMBER_OF_VOXELS': {'train': 16000, 'test': 40000}}]},
        'MODEL': {
            'NAME': 'SECONDNet',
            'VFE': {'NAME': 'MeanVFE'},
            'BACKBONE_3D': {'NAME': 'VoxelBackBone8x'},
            'MAP_TO_BEV': {'NAME': 'HeightCompression', 'NUM_BEV_FEATURES': 256},
            'BACKBONE_2D': {'NAME': 'BaseBEVBackbone', 'LAYER_NUMS': [5, 5],
                            'LAYER_STRIDES': [1, 2], 'NUM_FILTERS': [128, 256],
                            'UPSAMPLE_STRIDES': [1, 2], 'NUM_UPSAMPLE_FILTERS': [256, 256]},
            'DENSE_HEAD': dense_head,
            'POST_PROCESSING': {'RECALL_THRESH_LIST': [0.3, 0.5, 0.7], 'SCORE_THRESH': 0.1,
                                'OUTPUT_RAW_SCORE': False, 'EVAL_METRIC': 'kitti',
                                'NMS_CONFIG': {'MULTI_CLASSES_NMS': False,
                                               'NMS_TYPE': 'nms_gpu', 'NMS_THRESH': 0.01,
                                               'NMS_PRE_MAXSIZE': 4096,
                                               'NMS_POST_MAXSIZE': 500}}},
        'OPTIMIZATION': {'BATCH_SIZE_PER_GPU': 4, 'NUM_EPOCHS': 80,
                         'OPTIMIZER': 'adam_onecycle', 'LR': 0.003, 'WEIGHT_DECAY': 0.01,
                         'MOMENTUM': 0.9, 'MOMS': [0.95, 0.85], 'PCT_START': 0.4,
                         'DIV_FACTOR': 10, 'DECAY_STEP_LIST': [35, 45], 'LR_DECAY': 0.1,
                         'LR_CLIP': 0.0000001, 'LR_WARMUP': False, 'WARMUP_EPOCH': 1,
                         'GRAD_NORM_CLIP': 10}})


def second_network(cfg, meta, device, train=False):
    """The registered ``SECONDNet`` (vfe -> backbone_3d -> map_to_bev ->
    backbone_2d -> dense_head) built by ``build_network`` on ``device``,
    in eval mode or with ``train=True`` in training, with seeded weights
    (the box convs at SECOND_BOX_STD)."""
    import torch
    from hvpr_tpu_torch.models import build_network

    net = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), meta, device=device, train=train)
    seed_weights(net.module, seed=0, box_std=SECOND_BOX_STD)
    head = net.module.dense_head
    if hasattr(head, 'rpn_heads'):          # AnchorHeadMulti: its box convs
        gen = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for h in head.rpn_heads:
                per = 3 if h.use_dir else 2
                for k in range(len(h.class_anchor_counts)):
                    w = h.convs[per * k + 1].weight
                    w.copy_(torch.randn(w.shape, generator=gen) * SECOND_BOX_STD)
    return net


def padded_voxels(points, meta):
    """(B, N, 4) scans -> the data layer's padded voxel batch (numpy): the
    first-seen MAX_NUMBER_OF_VOXELS voxels of each, 5 points a voxel."""
    import numpy as np
    from hvpr_tpu_torch.ops.voxelizer import VoxelGeneratorNumpy
    gen = VoxelGeneratorNumpy(meta.voxel_size, meta.point_cloud_range,
                              meta.max_points_per_voxel, meta.max_voxels)
    b, _, c = points.shape
    v, p = meta.max_voxels, meta.max_points_per_voxel
    out = {'voxels': np.zeros((b, v, p, c), np.float32),
           'voxel_coords': np.zeros((b, v, 3), np.int32),
           'voxel_num_points': np.zeros((b, v), np.int32)}
    for i in range(b):
        vox, coords, cnt = gen.generate(points[i])
        out['voxels'][i, :len(vox)] = vox
        out['voxel_coords'][i, :len(vox)] = coords
        out['voxel_num_points'][i, :len(vox)] = cnt
    out['voxel_mask'] = out['voxel_num_points'] > 0
    return out


def sparse_levels(backbone, run):
    """Run ``run()`` with the sparse backbone's stages observed: per stage
    (conv_input ... conv_out) its valid sites a scan, site slots, channels
    and the median milliseconds over the calls (synchronized around it)."""
    import torch
    seen, handles = {}, []
    for name in backbone.stage_names:
        stage = getattr(backbone, name)

        def pre(mod, inp, name=name):
            torch.cuda.synchronize()
            seen.setdefault(name, {'t': []})['t0'] = time.perf_counter()

        def post(mod, inp, out, name=name):
            torch.cuda.synchronize()
            rec = seen[name]
            rec['t'].append((time.perf_counter() - rec.pop('t0')) * 1e3)
            rec['sites'] = out[2].sum(dim=1).tolist()
            rec['slots'], rec['channels'] = out[0].shape[1], out[0].shape[2]
        handles += [stage.register_forward_pre_hook(pre), stage.register_forward_hook(post)]
    try:
        run()
    finally:
        for h in handles:
            h.remove()
    return {k: dict(v, ms=statistics.median(v['t'])) for k, v in seen.items()}


def _print_levels(label, levels, smi=None):
    for name, rec in levels.items():
        nbytes = [s * rec['channels'] * 4 for s in rec['sites']]
        print(f'second {label}: {name}: {rec["channels"]} channels, valid sites a scan '
              f'{rec["sites"]} of {rec["slots"]} slots, features {nbytes} bytes a scan '
              f'({rec["slots"] * rec["channels"] * 4} allocated), {rec["ms"]:.3f} ms'
              + (f', on {smi}' if smi else ''))


def _rel_err(got, want):
    """max |got - want| over the largest |want|."""
    return float((got.double() - want.double()).abs().max()) / max(
        float(want.double().abs().max()), 1e-30)


def _k12_bound(calls):
    """K12's bound over captured calls, as the train phase counts it
    (``utils.flops.gather_grad_work``)."""
    return _train_bounds('gather_grad', calls, [None] * len(calls), None, None)[:2]


def device_report(fn, wall_ms, reps=2):
    """'products P, the rest R, busy B of W (idle share I); largest: ...'
    of ``fn()`` (torch.profiler device ms a call): the cuBLAS products
    against every other kernel, and their sum against ``wall_ms``."""
    dev = device_times(fn, reps=reps)
    if not dev:
        return 'not measured'
    products = sum(v for k, v in dev.items()
                   if any(w in k.lower() for w in ('gemm', 'gemv', 'splitk'))
                   or k.startswith('Kernel'))
    busy = sum(dev.values())
    top = ', '.join(f'{k} {v:.3f}' for k, v in sorted(dev.items(), key=lambda kv: -kv[1])[:6])
    return (f'products {products:.3f}, the rest {busy - products:.3f}, busy {busy:.3f} of '
            f'{wall_ms:.3f} (idle share {1 - busy / wall_ms:.3f}); largest: {top}')


def second_phase(smi):
    """The sparse voxel path at SECOND's published widths (second_cfg) on
    4 seeded ``realistic_scans`` of SECOND_POINTS points, host-voxelized
    into padded batches: (a) an eval forward with AnchorHeadSingle, whose
    sites must all be kept at the default cap, its raw outputs on scan 0
    held to the port's CPU forward of that scan (SECOND_RTOL), the sites a
    level and each stage's time printed, K14's calls of the forward held to
    the plain rulebook and timed (:func:`rulebook_entry`), and the sparse
    backbone timed again on scans that fill the 40,000-voxel cap; (b) an
    eval forward
    with AnchorHeadMulti, its head held to the CPU on the card's BEV map;
    (c) ATSS training (TOPK 9) under adam_onecycle: two backwards from the
    same state bit-equal without deterministic algorithms, the sparse
    convs' row-gather backwards (K12) held against their plain version
    (bit for bit), then SECOND_TRAIN_STEPS timed steps. No TPU kernel of
    the JAX package lies on this path (its sparse convs are XLA): the eval
    forms must launch K14 once a sparse conv and no other kernel, a train
    step K14 as often and K12 once a differentiable row gather. Returns
    ({'a', 'b', 'c'}: launch counts, K12's entry at the path's shapes, K14's
    entry, :func:`rulebook_entry`)."""
    import numpy as np
    import torch
    from hvpr_tpu_torch.models import DatasetMeta, load_data_to_gpu
    from hvpr_tpu_torch.models.backbones_3d import sparse_backbone
    from hvpr_tpu_torch.models.detectors.detector3d_template import post_processing
    from hvpr_tpu_torch.ops import _kernels, gather_rows, sparse_conv
    from hvpr_tpu_torch.parallel import loss_and_grads
    from hvpr_tpu_torch.utils.scans import realistic_scans_with_boxes

    cfg = second_cfg()
    meta = DatasetMeta(cfg.DATA_CONFIG, cfg.CLASS_NAMES, mode='test')
    pts, gt = realistic_scans_with_boxes(np.random.default_rng(0), SECOND_BATCH,
                                         SECOND_POINTS, meta.point_cloud_range)
    host = padded_voxels(pts, meta)
    batch = load_data_to_gpu(host, 'cuda')
    print(f'second: grid {tuple(int(g) for g in meta.grid_size)} (x, y, z), batch '
          f'{SECOND_BATCH}, {SECOND_POINTS} points a scan, voxels a scan '
          f'{host["voxel_mask"].sum(1).tolist()} of {meta.max_voxels} slots')
    launches = {}

    # (a) AnchorHeadSingle: the main path with the counts from zero
    net = second_network(cfg, meta, 'cuda')
    bb = net.module.backbone_3d
    _kernels.reset_launch_counts()
    with torch.no_grad():
        out = net.module(batch)
        det = post_processing(out, net.post_cfg, net.num_class)
    torch.cuda.synchronize()
    launches['a'] = _kernels.launch_counts()
    if without_iou(launches['a']) != second_launches(launches['a']):
        fail(f'the second eval path launched {launches["a"]}, expected K14 '
             f'{SECOND_RULEBOOKS} times and no other kernel but K13')
    dropped = out['sparse_sites_dropped'].tolist()
    print(f'second (a): sparse_sites_dropped {dropped} at the default cap '
          f'(MAX_SITES 2 x {meta.max_voxels})')
    if any(dropped):
        fail(f'second (a): {dropped} sites dropped at the default cap')
    enc = out['encoded_spconv_tensor']
    nx, ny = (int(g) // 8 for g in meta.grid_size[:2])
    if tuple(enc.shape) != (SECOND_BATCH, 2, ny, nx, 128) or \
            tuple(out['spatial_features'].shape[1:]) != (ny, nx, 256):
        fail(f'second (a): encoded {tuple(enc.shape)}, BEV '
             f'{tuple(out["spatial_features"].shape)}')
    for k in ('batch_cls_preds', 'batch_box_preds'):
        if not torch.isfinite(out[k]).all():
            fail(f'second (a): non-finite {k}')
    kept = det['pred_mask'].sum(1).tolist()
    if not torch.isfinite(det['pred_boxes'][det['pred_mask']]).all() or not all(kept):
        fail(f'second (a): detections kept {kept}, or not finite')
    print(f'second (a): outputs {tuple(out["batch_cls_preds"].shape)} cls, '
          f'{tuple(out["batch_box_preds"].shape)} boxes, detections kept {kept}')

    # scan 0 through the port on the CPU, the same weights
    state = {k: v.detach().cpu() for k, v in net.module.state_dict().items()}
    cpu = second_network(cfg, meta, 'cpu')
    cpu.module.load_state_dict(state)
    t0 = time.perf_counter()
    with torch.no_grad():
        cpu_out = cpu.module({k: torch.from_numpy(v[:1]) for k, v in host.items()})
    cpu_s = time.perf_counter() - t0
    errs = {k: _rel_err(out[k][:1].cpu(), cpu_out[k])
            for k in ('pillar_features', 'encoded_spconv_tensor', 'spatial_features_2d',
                      'batch_cls_preds', 'batch_box_preds')}
    print(f'second (a): card vs the CPU forward of scan 0 ({cpu_s:.1f} s), max error over '
          f'the largest magnitude: ' + ', '.join(f'{k} {v:.3g}' for k, v in errs.items())
          + f' (allowed {SECOND_RTOL})')
    if max(errs.values()) > SECOND_RTOL or not torch.equal(
            out['sparse_sites_dropped'][:1].cpu(), cpu_out['sparse_sites_dropped']):
        fail('second (a): the card differs from the CPU')
    del cpu, cpu_out
    k14 = rulebook_entry(net, batch, smi)

    # stage times and the peak, the counts untouched
    stages = [('vfe', net.module.vfe), ('backbone_3d', bb),
              ('map_to_bev', net.module.map_to_bev_module),
              ('backbone_2d', net.module.backbone_2d), ('dense_head', net.module.dense_head)]
    times = {name: [] for name, _ in stages}
    times['post_processing'] = []
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        net.module(batch)
        fwd_peak = torch.cuda.max_memory_allocated()
        levels = sparse_levels(bb, lambda: [
            _timed_stages(stages, batch, net, times) for _ in range(3)])
    peak = torch.cuda.max_memory_allocated()
    bev = {'spatial_features': out['spatial_features']}
    peaks = {}
    with torch.no_grad():
        for name, fn in (('backbone_3d', lambda: bb(net.module.vfe(dict(batch)))),
                         ('backbone_2d', lambda: net.module.backbone_2d(dict(bev)))):
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            fn()
            peaks[name] = (torch.cuda.max_memory_allocated() - base) / 2**30
        fwd_ms = cuda_ms(lambda: net.module(batch), reps=3, warmup=1)
        report = device_report(lambda: net.module(batch), fwd_ms)
        flag_ms = {}
        for tf32 in (False, True):
            with cli_flags(conv_tf32=tf32):
                key = 'TF32' if tf32 else 'f32'
                flag_ms[key] = cuda_ms(lambda: net.module.backbone_2d(dict(bev)), reps=3,
                                       warmup=1)
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                net.module.backbone_2d(dict(bev))
                peaks[f'backbone_2d, cuDNN\'s own choice, {key}'] = (
                    torch.cuda.max_memory_allocated() - base) / 2**30
    _print_levels('(a) timed', levels, smi)
    print('second (a): stage medians ms: ' + ', '.join(
        f'{k} {statistics.median(v):.3f}' for k, v in times.items())
        + f'; the sparse backbone outside its stages (site sort, densify) '
        f'{statistics.median(times["backbone_3d"]) - sum(r["ms"] for r in levels.values()):.3f}; '
        f'backbone_2d with cuDNN\'s own choice (not its deterministic one) in f32 '
        f'{flag_ms["f32"]:.3f}, in TF32 (torch\'s default) {flag_ms["TF32"]:.3f}; peak {fwd_peak / 2**30:.2f} GiB the forward, {peak / 2**30:.2f} '
        f'with post-processing; above their inputs (GiB): '
        + ', '.join(f'{k} {v:.2f}' for k, v in peaks.items()) + f'; on {smi}')
    print(f'second (a): the forward {fwd_ms:.3f} ms, device ms (torch.profiler): {report}; '
          f'on {smi}')

    # the sparse backbone at the eval cap's load: 40,000 voxels a scan
    cap_pts, _ = realistic_scans_with_boxes(np.random.default_rng(1), SECOND_BATCH,
                                            SECOND_CAP_POINTS, meta.point_cloud_range)
    cap_batch = load_data_to_gpu(padded_voxels(cap_pts, meta), 'cuda')
    with torch.no_grad():
        cap_out = net.module.vfe(dict(cap_batch))
        cap_drop = bb(dict(cap_out))['sparse_sites_dropped'].tolist()
        bb.model_cfg['MAX_SITES'] = 4 * meta.max_voxels
        try:
            ms = cuda_ms(lambda: bb(dict(cap_out)), reps=3, warmup=1)
            levels = sparse_levels(bb, lambda: bb(dict(cap_out)))
            # the per-tap products (cuBLAS) against the rest: the lookups,
            # row gathers, masks and the output sites' sorts
            report = device_report(lambda: bb(dict(cap_out)), ms)
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            bb(dict(cap_out))
            bb_peak = torch.cuda.max_memory_allocated() - base
        finally:
            del bb.model_cfg['MAX_SITES']
    _print_levels('at the eval cap', levels)
    print(f'second: the sparse backbone at {int(cap_batch["voxel_mask"].sum()) // SECOND_BATCH} '
          f'voxels a scan: the default cap drops {cap_drop} sites; with MAX_SITES '
          f'{4 * meta.max_voxels} it keeps all, {ms:.3f} ms a forward of {SECOND_BATCH} '
          f'scans, {bb_peak / 2**30:.2f} GiB above its inputs; device ms a forward '
          f'(torch.profiler): {report}; on {smi}')
    del cap_batch, cap_out, net, out, det

    # (b) AnchorHeadMulti
    cfg_m = second_cfg(head='AnchorHeadMulti')
    net = second_network(cfg_m, meta, 'cuda')
    _kernels.reset_launch_counts()
    with torch.no_grad():
        out = net.module(batch)
        det = post_processing(out, net.post_cfg, net.num_class)
    torch.cuda.synchronize()
    launches['b'] = _kernels.launch_counts()
    if without_iou(launches['b']) != second_launches(launches['b']):
        fail(f'the second multi-head path launched {launches["b"]}, expected K14 '
             f'{SECOND_RULEBOOKS} times and no other kernel but K13')
    head_cpu = second_network(cfg_m, meta, 'cpu').module.dense_head
    head_cpu.load_state_dict({k: v.cpu() for k, v in net.module.dense_head.state_dict().items()})
    with torch.no_grad():
        ref = head_cpu({'spatial_features_2d': out['spatial_features_2d'][:1].cpu()})
    own = ref['batch_cls_preds'] > -1e8
    if not torch.equal(own, out['batch_cls_preds'][:1].cpu() > -1e8):
        fail('second (b): the heads own other classes on the card')
    errs = {'own cls logits': _rel_err(out['batch_cls_preds'][:1].cpu()[own],
                                       ref['batch_cls_preds'][own]),
            'boxes': _rel_err(out['batch_box_preds'][:1].cpu(), ref['batch_box_preds'])}
    kept = det['pred_mask'].sum(1).tolist()
    with torch.no_grad():
        head_ms = cuda_ms(lambda: net.module.dense_head(dict(out)), reps=5, warmup=1)
    print(f'second (b) AnchorHeadMulti ({len(net.module.dense_head.rpn_heads)} heads, shared '
          f'conv 64): detections kept {kept}; head {head_ms:.3f} ms; card vs CPU head on the '
          f'card\'s map of scan 0: ' + ', '.join(f'{k} {v:.3g}' for k, v in errs.items())
          + f'; on {smi}')
    if max(errs.values()) > SECOND_RTOL or not all(kept):
        fail('second (b): the multi-head outputs differ from the CPU, or nothing kept')
    del net, out, det, batch

    # (c) ATSS training: 16,000 voxels a scan
    cfg_t = second_cfg(assigner='ATSS')
    meta_t = DatasetMeta(cfg_t.DATA_CONFIG, cfg_t.CLASS_NAMES, mode='train')
    tbatch = dict(load_data_to_gpu(padded_voxels(pts, meta_t), 'cuda'),
                  gt_boxes=torch.from_numpy(gt).cuda())
    net = second_network(cfg_t, meta_t, 'cuda', train=True)
    state0 = {k: v.clone() for k, v in net.module.state_dict().items()}

    def fresh():
        net.module.load_state_dict(state0)
        net.init_training(cfg_t.OPTIMIZATION, TOTAL_STEPS)

    # the differentiable row gathers of a forward (each has one K12 backward)
    grad_gathers = [0]

    def counting(fn):
        def wrapped(features, idx):
            grad_gathers[0] += int(features.requires_grad)
            return fn(features, idx)
        return wrapped
    saved = [(m, m.gather_rows) for m in (sparse_conv, sparse_backbone)]
    for m, fn in saved:
        m.gather_rows = counting(fn)
    try:
        twice = []
        for i in range(2):
            fresh()
            grad_gathers[0] = 0
            _kernels.reset_launch_counts()
            if i == 0:
                k12 = _first_calls_by_shape(gather_rows, 'gather_rows_backward',
                                            lambda: twice.append(
                                                loss_and_grads(net.train_state, tbatch)))
            else:
                twice.append(loss_and_grads(net.train_state, tbatch))
            torch.cuda.synchronize()
            one = _kernels.launch_counts()
    finally:
        for m, fn in saved:
            m.gather_rows = fn
    (out1, g1), (_, g2) = twice
    names = [n for n, _ in net.module.named_parameters()]
    differ = [n for n, a, b in zip(names, g1, g2) if not torch.equal(a, b)]
    print(f'second (c) ATSS: loss {out1["loss"].item():.6g} ('
          + ', '.join(f'{k} {v.item():.6g}' for k, v in out1['tb_dict'].items())
          + f'); sparse_sites_dropped {out1["sparse_sites_dropped"].tolist()} at the default '
          f'cap (MAX_SITES 2 x {meta_t.max_voxels}); two backwards without deterministic '
          f'algorithms: {len(differ)} of {len(names)} gradient leaves differ')
    if differ:
        fail(f'second (c): two backwards differ in {differ[:5]}')
    if without_iou(one) != second_launches(one, gather_grad=grad_gathers[0]):
        fail(f'second (c): a step launched {one}, expected K12 {grad_gathers[0]} times and '
             f'K14 {SECOND_RULEBOOKS}')
    del twice, out1, g1, g2

    # K12 at the path's shapes against its plain version (on the CPU, where
    # its index_add_ sums in order: the same bits)
    err = ms = plain_ms = lib_ms = 0.0
    for (grad, index, n), _ in k12:
        got = gather_rows.gather_rows_backward(grad, index, n)
        want = gather_rows.gather_rows_backward_plain(grad.cpu(), index.cpu(), n)
        err = max(err, float((got.cpu() - want).abs().max()))
        ms += cuda_ms(lambda: gather_rows.gather_rows_backward(grad, index, n), reps=5)
        with _kernels.plain_versions():
            plain_ms += cuda_ms(lambda: gather_rows.gather_rows_backward(grad, index, n),
                                reps=3, warmup=1)
        acc = torch.zeros(n, grad.shape[1], device='cuda')
        lib_ms += cuda_ms(lambda: acc.zero_().index_add_(0, index, grad), reps=5)
    if err != 0.0:
        fail(f'second (c): K12 differs from its plain version by {err}')
    b_ms, b_by = _k12_bound(k12)
    k12_entry = {'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms, 'bound_ms': b_ms,
                 'bound_by': b_by, 'library_ms': lib_ms,
                 'shapes': [tuple(g.shape) for (g, _i, _n), _ in k12]}
    print(f'second (c): K12 at {len(k12)} distinct shapes of the step {k12_entry["shapes"]}: '
          f'max_abs_err {err}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, index_add_ '
          f'{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); on {smi}')
    print_k12_split([a for a, _ in k12], "the ATSS step's distinct shapes")
    del k12

    # the timed steps, the counts from zero
    fresh()
    _kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for _ in range(SECOND_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = net.train_step(tbatch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if not all(torch.isfinite(v).all() for v in metrics.values()):
            fail(f'second (c): non-finite metrics {metrics}')
    launches['c'] = _kernels.launch_counts()
    want = second_launches(launches['c'], steps=SECOND_TRAIN_STEPS,
                           gather_grad=one['gather_grad'])
    if without_iou(launches['c']) != want:
        fail(f'second (c): {SECOND_TRAIN_STEPS} steps launched {launches["c"]}, expected {want}')
    peak = torch.cuda.max_memory_allocated()
    share = k12_share(lambda: net.train_step(tbatch))
    print(f'second (c): K12 {share[2]} calls {share[1]:.3f} ms of an ATSS step of '
          f'{share[0]:.3f} ms ({share[1] / share[0]:.4f}; CUDA events around each call, median '
          f'step of 3)')
    print(f'second (c): {SECOND_TRAIN_STEPS} adam_onecycle steps, ms {step_ms}, loss '
          f'{float(metrics["loss"]):.6g}, grad_norm {float(metrics["grad_norm"]):.6g}, '
          f'K12 {one["gather_grad"]} and K14 {one["sparse_rulebook"]} launches a step, '
          f'peak {peak / 2**30:.2f} GiB; a step\'s device ms (torch.profiler): '
          + device_report(lambda: net.train_step(tbatch), statistics.median(step_ms), reps=1)
          + f'; on {smi}')
    del net, tbatch, state0
    return launches, k12_entry, k14


def second_launches(launches, steps=1, gather_grad=0):
    """The launches expected of ``steps`` SECOND forwards (or train steps
    with ``gather_grad`` K12 launches each): K14 once a sparse conv, no
    other kernel; over the keys of ``launches`` but K13 (:func:`without_iou`)."""
    want = {'sparse_rulebook': steps * SECOND_RULEBOOKS, 'gather_grad': steps * gather_grad}
    return {k: want.get(k, 0) for k in without_iou(launches)}


def rulebook_entry(net, batch, smi):
    """K14 at the level shapes of a SECOND eval forward on ``batch`` (those
    of the benchmark cell second.infer.b4): its calls of one forward
    captured, each held to the plain rulebook by torch.equal (a gate), then
    the forward's calls timed through the wrapper (CUDA events), on the
    device (torch.profiler) and through the plain versions, beside their
    byte bound. Returns the kernel's entry."""
    import numpy as np
    import torch
    from hvpr_tpu_torch.ops import _kernels, sparse_conv
    from hvpr_tpu_torch.utils import flops

    with torch.no_grad():
        calls = capture_calls([(sparse_conv, 'tap_rulebook', 'sparse_rulebook')],
                              lambda: net.module(dict(batch)))['sparse_rulebook']
    if len(calls) != SECOND_RULEBOOKS:
        fail(f'second K14: {len(calls)} rulebooks a forward, expected {SECOND_RULEBOOKS}')
    for args, _ in calls:
        got = sparse_conv.tap_rulebook(*args)
        with _kernels.plain_versions():
            want = sparse_conv.tap_rulebook(*args)
        if not all(g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(got, want)):
            fail(f'second K14: the rulebook of {[tuple(a.shape) for a in args[:3]]}, kernel '
                 f'{args[3]}, differs from the plain one')
    del got, want

    def run():
        return [sparse_conv.tap_rulebook(*a) for a, _ in calls]
    ms = cuda_ms(run, reps=10)
    device_ms = _kernel_device_ms(run, 'sparse_rulebook_kernel')
    with _kernels.plain_versions():
        plain_ms = cuda_ms(run, reps=3, warmup=1)
    work = flops.total(flops.sparse_rulebook_work(
        a[0].shape[0], a[0].shape[1], a[2].shape[1], int(np.prod(a[3])), a[1].element_size())
        for a, _ in calls)
    bound_ms, bound_by, _ = flops.work_bound(work)
    shapes = [(tuple(a[2].shape), a[0].shape[1], a[3]) for a, _ in calls]
    print(f'second K14: {len(calls)} rulebooks a forward, (B, M) queries into V sites by '
          f'kernel {shapes}: equal to plain (torch.equal) on every call; kernel {ms:.4f} ms, '
          f'device {device_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms '
          f'({bound_by}, {work.nbytes / 1e6:.1f} MB at 3.35 TB/s); on {smi}')
    return {'max_abs_err': 0.0, 'ms': ms, 'device_ms': device_ms, 'plain_ms': plain_ms,
            'bound_ms': bound_ms, 'bound_by': bound_by, 'library_ms': None,
            'calls': len(calls)}


def _timed_stages(stages, batch, net, times):
    """One eval forward stage by stage, each synchronized around it."""
    import torch
    from hvpr_tpu_torch.models.detectors.detector3d_template import post_processing
    b = dict(batch)
    for name, stage in stages:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b = stage(b)
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    post_processing(b, net.post_cfg, net.num_class)
    torch.cuda.synchronize()
    times['post_processing'].append((time.perf_counter() - t0) * 1e3)


def _first_calls_by_shape(mod, attr, run):
    """Run ``run()`` with ``mod.attr`` recorded: the first call of each
    distinct shape of its tensor arguments, cloned ([(args, kwargs)])."""
    import torch
    fn = getattr(mod, attr)
    calls = {}

    def wrapped(*args, **kwargs):
        key = tuple(tuple(a.shape) for a in args if isinstance(a, torch.Tensor))
        if key not in calls:
            calls[key] = (tuple(a.detach().clone() if isinstance(a, torch.Tensor) else a
                                for a in args), dict(kwargs))
        return fn(*args, **kwargs)
    setattr(mod, attr, wrapped)
    try:
        run()
    finally:
        setattr(mod, attr, fn)
    return list(calls.values())


def nofp_phase(smi):
    """PointNet2MSG_NOFP (the SA stack without FP) at hvpr.yaml's SA_CONFIG
    on 4 seeded ``realistic_scans`` of 16,384 points: each K4 (ball query,
    both radii of a level in one sweep) and K5 (chunked FPS) call held
    against its plain version (exactly), timed beside its bound, the forward
    equal to the one through the plain versions bit for bit, and the path
    run with the counts from zero (K4 and K5 twice each, nothing else).
    Returns (launch counts, {kernel: entry at these shapes})."""
    import numpy as np
    import torch
    from hvpr_tpu_torch.config import ConfigDict
    from hvpr_tpu_torch.models import DatasetMeta
    from hvpr_tpu_torch.models.backbones_3d.pointnet2_backbone import PointNet2MSG_NOFP
    from hvpr_tpu_torch.ops import _kernels, pn2_select, pointnet2
    from hvpr_tpu_torch.utils.scans import realistic_scans

    cfg = load_cfg()
    meta = DatasetMeta(cfg.DATA_CONFIG, cfg.CLASS_NAMES, mode='train')
    b3d = cfg.MODEL.BACKBONE_3D
    module = PointNet2MSG_NOFP(ConfigDict({'NAME': 'PointNet2MSG_NOFP',
                                           'SA_CONFIG': b3d.SA_CONFIG,
                                           'COMPUTE_DTYPE': b3d.get('COMPUTE_DTYPE', 'fp32')}),
                               meta.num_point_features)
    seed_weights(module, seed=0)
    module = module.cuda().eval()
    pts = realistic_scans(np.random.default_rng(0), TRAIN_BATCH, N_POINTS,
                          meta.point_cloud_range)
    batch = {'points': torch.from_numpy(pts).cuda(),
             'point_valid_mask': torch.ones(TRAIN_BATCH, N_POINTS, dtype=torch.bool,
                                            device='cuda')}

    def run():
        with torch.no_grad():
            return module(dict(batch))
    wrappers = {'ball_query': (pointnet2, 'ball_query_bucket2', pn2_select.ball_query_bucket2),
                'fps_chunks': (pointnet2, 'fps_chunks', pn2_select.fps_chunks)}
    out = {}
    calls = capture_calls([(m, a, k) for k, (m, a, _) in wrappers.items()],
                          lambda: out.update(run()))
    with _kernels.plain_versions():
        plain = run()
    torch.cuda.synchronize()
    feats = out['point_features']
    if tuple(feats.shape) != (TRAIN_BATCH, int(b3d.SA_CONFIG.NPOINTS[-1]),
                              module.num_point_features) or not torch.isfinite(feats).all():
        fail(f'nofp: point_features {tuple(feats.shape)}, or not finite')
    if not all(torch.equal(out[k], plain[k]) for k in
               ('point_features', 'point_coords', 'point_valid_mask')):
        fail('nofp: the forward differs from the one through the plain versions')

    entries = {}
    for name, (_, _, fn) in wrappers.items():
        err = ms = plain_ms = 0.0
        plain_outs = []
        for args, kwargs in calls[name]:
            got = fn(*args, **kwargs)
            with _kernels.plain_versions():
                want = fn(*args, **kwargs)
            torch.cuda.synchronize()
            plain_outs.append(want)
            for g, w in zip(flat(got), flat(want)):
                err = max(err, float((g.double() - w.double()).abs().max()))
            ms += cuda_ms(lambda: fn(*args, **kwargs), reps=10, warmup=2)
            with _kernels.plain_versions():
                plain_ms += cuda_ms(lambda: fn(*args, **kwargs), reps=3, warmup=1)
        if err != 0.0:
            fail(f'nofp: {name} differs from its plain version by {err}')
        b_ms, b_by, _ = _train_bounds(name, calls[name], plain_outs, None, None)
        entries[name] = {'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
                         'bound_ms': b_ms, 'bound_by': b_by, 'library_ms': None}
        shapes = [tuple(tuple(a.shape) for a in args if isinstance(a, torch.Tensor))
                  for args, _ in calls[name]]
        print(f'nofp: {name} {len(calls[name])} calls a forward at {shapes}: max_abs_err '
              f'{err}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms '
              f'({b_by}); on {smi}')
    del calls

    _kernels.reset_launch_counts()
    run()
    torch.cuda.synchronize()
    launches = _kernels.launch_counts()
    want = {k: (2 if k in wrappers else 0) for k in launches}
    if without_iou(launches) != without_iou(want):
        fail(f'the nofp path launched {launches}, expected {want}')
    for name in wrappers:
        entries[name]['launches'] = launches[name]
    fwd_ms = cuda_ms(run, reps=5, warmup=1)
    print(f'nofp: PointNet2MSG_NOFP forward {fwd_ms:.3f} ms at batch {TRAIN_BATCH} '
          f'({N_POINTS} points a scan, NPOINTS {list(b3d.SA_CONFIG.NPOINTS)}, FPS_CHUNKS '
          f'{b3d.SA_CONFIG.get("FPS_CHUNKS")}), point_features {tuple(feats.shape)}; '
          f'launches {launches}; on {smi}')
    return launches, entries


@contextlib.contextmanager
def cli_flags(conv_tf32=True):
    """torch's default backend flags, those of a CLI in its own process
    (this script turns TF32 off and cuDNN's deterministic choice on);
    ``conv_tf32=False`` keeps the convolutions in f32."""
    import torch
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = conv_tf32, False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic,
         torch.backends.cuda.matmul.allow_tf32) = saved


def _run_tool(module, args, timeout=600):
    """``python -m module args`` from the repository root; its output."""
    proc = subprocess.run([sys.executable, '-m', module, *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        fail(f'{module} exited {proc.returncode}:\n{proc.stdout[-3000:]}\n'
             f'{proc.stderr[-3000:]}')
    return proc.stdout + proc.stderr


def demo_phase(smi):
    """The demo and vis entry points on the card: the demo's ``main`` (what
    ``python -m hvpr_tpu_torch.tools.demo`` runs) here, under torch's
    default backend flags and with the counts from zero just before it
    (hvpr.yaml, a ``.pth`` of seeded weights, a directory of DEMO_SCANS
    ``.bin`` realistic scans, --save_3d): K2 once a scan and nothing else;
    the detections it returns must equal bit for bit those of the padded
    pipeline run here on the same scans and weights (its DemoDataset,
    ``Network.eval_forward``), and its PLY files must exist. Then ``python
    -m hvpr_tpu_torch.tools.vis`` in a subprocess, as a user runs it, on a
    synthetic KITTI tree (2 val scenes), whose PLY files (and PNGs, where
    matplotlib is installed) must exist. Returns the demo's launch counts."""
    import importlib.util
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch
    from hvpr_tpu_torch.models import build_network
    from hvpr_tpu_torch.ops import _kernels
    from hvpr_tpu_torch.tools import demo
    from hvpr_tpu_torch.tools.eval_utils import _forward
    from hvpr_tpu_torch.utils.checkpoint import load_params_from_file
    from hvpr_tpu_torch.utils.scans import realistic_scans

    cfg = load_cfg()
    has_mpl = importlib.util.find_spec('matplotlib') is not None
    build_dir = Path(ROOT) / 'build'
    build_dir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        tmp = Path(tmp)
        root, ckpt = write_eval_tree(tmp, cfg, n_val=2)
        scans = tmp / 'scans'
        scans.mkdir()
        pts = realistic_scans(np.random.default_rng(3), DEMO_SCANS, DEMO_POINTS,
                              np.asarray(cfg.DATA_CONFIG.POINT_CLOUD_RANGE, np.float32))
        for i, p in enumerate(pts):
            p.tofile(scans / f'{i:06d}.bin')
        with cli_flags():
            _kernels.reset_launch_counts()
            t0 = time.perf_counter()
            got = demo.main(['--cfg_file', CFG, '--ckpt', str(ckpt), '--data_path', str(scans),
                             '--save_3d', str(tmp / 'demo_3d')])
            torch.cuda.synchronize()
            demo_s = time.perf_counter() - t0
            launches = _kernels.launch_counts()
        want = {k: (DEMO_SCANS if k == 'memory_lookup' else 0) for k in launches}
        if without_iou(launches) != without_iou(want):
            fail(f'the demo path launched {launches}, expected {want}')
        plys = sorted((tmp / 'demo_3d').glob('*.ply'))
        pngs = sorted((tmp / 'demo_3d').glob('*.png'))
        if len(got) != DEMO_SCANS or len(plys) != DEMO_SCANS or \
                len(pngs) != (DEMO_SCANS if has_mpl else 0):
            fail(f'demo: {len(got)} scans, {len(plys)} PLY and {len(pngs)} PNG files written')

        # the padded pipeline here, on the same scans and weights
        with cli_flags():
            dataset = demo.DemoDataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES, root_path=scans)
            net = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), dataset, device='cuda')
            load_params_from_file(net.module, ckpt)
            hosts = [_forward(net, dataset.collate_batch([dataset[i]]), keep_gt=False)[0]
                     for i in range(len(dataset))]
        kept = []
        for i, (g, h) in enumerate(zip(got, hosts)):
            m = h['pred_mask'][0]
            ours = {'boxes': h['pred_boxes'][0][m], 'scores': h['pred_scores'][0][m],
                    'labels': h['pred_labels'][0][m]}
            if any(not np.array_equal(g[k], ours[k]) for k in ours):
                fail(f'demo: scan {i}: the CLI\'s detections differ from the padded '
                     f'pipeline\'s')
            kept.append(len(ours['boxes']))
        del net
        print(f'demo: hvpr_tpu_torch.tools.demo.main on {DEMO_SCANS} scans in '
              f'{demo_s:.1f} s (the network\'s build and the .pth load included): '
              f'detections {kept} equal bit for bit to the padded pipeline\'s; '
              f'{len(plys)} PLY, {len(pngs)} PNG files (matplotlib '
              f'{"present" if has_mpl else "absent: PNGs skipped"}); '
              f'launches {launches}; on {smi}')

        t0 = time.perf_counter()
        _run_tool('hvpr_tpu_torch.tools.vis', [
            '--cfg_file', CFG, '--ckpt', str(ckpt), '--out_dir', str(tmp / 'vis'),
            '--max_samples', '2', '--workers', '0',
            '--set', 'DATA_CONFIG.DATA_PATH', str(root)])
        files = sorted(p.name for p in (tmp / 'vis').iterdir())
        if len([f for f in files if f.endswith('.ply')]) != 2 or \
                len([f for f in files if f.endswith('.png')]) != (2 if has_mpl else 0):
            fail(f'vis: wrote {files}')
        print(f'vis: python -m hvpr_tpu_torch.tools.vis wrote {files} in '
              f'{time.perf_counter() - t0:.1f} s')
    return launches


OPTIONS_POS_FRACTION = 0.25        # the options phase's subsampling: 128 foregrounds at
OPTIONS_SAMPLE_SIZE = 512          # most, 512 labelled anchors a scan
OPTIONS_BINDING_POS_FRACTION = 0.1  # (a): a cap of 51, below the scans' 72-78 foregrounds
OPTIONS_ITERS_EACH_EPOCH = 2       # (a): DECAY_STEP_LIST [1] and WARMUP_EPOCH 1 in steps
OPTIONS_ADAM_STEPS = 4             # (a): 2 warmup steps, then 2 past the decay
OPTIONS_SGD_STEPS = 2
OPTIONS_TIMED_STEPS = 3            # (a): timed steps with and without MATCH_HEIGHT
OPTIONS_CLI_TRAIN_SCENES = 8       # (d): 2 steps an epoch at batch 4
OPTIONS_CLI_VAL_SCENES = 4
OPTIONS_CLI_WORKERS = 2
# (b): the sequential and the stacked pass run the same bf16 convs at batch
# B and 2B (cuDNN may pick other algorithms for each, and the split BN sums
# its statistics in another order): a flipped bf16 rounding moves a value
# by 2^-8 of itself and a few compound through the levels; allowed: 4 bf16
# ulps of the largest output, 2^-6 of it
DUAL_PASS_ATOL_FRAC = 2.0 ** -6
# the same comparison with the backbone in f32 (TF32 off): sums of up to
# 3 x 3 x 512 products in another order, 2^-24 a rounding, through ~16
# convolutions: ~2e-5 of the largest; allowed 1e-4
DUAL_PASS_F32_ATOL_FRAC = 1e-4


def options_cfg(optimizer='adam'):
    """hvpr.yaml at full width with every option of this phase: the
    sequential DUAL_PASS, MATCH_HEIGHT, POS_FRACTION / SAMPLE_SIZE
    subsampling, NORM_BY_NUM_EXAMPLES, the sincos box coder (code_weights
    8 wide), TOPK_MODE approx, and ``optimizer`` (adam or sgd) with a
    decay at epoch 1 and a 1-epoch cosine warmup."""
    cfg = load_cfg()
    model = cfg.MODEL
    model.BACKBONE_2D.DUAL_PASS = 'sequential'
    model.MAP_TO_BEV.TOPK_MODE = 'approx'
    target = model.DENSE_HEAD.TARGET_ASSIGNER_CONFIG
    target.MATCH_HEIGHT = True
    target.POS_FRACTION = OPTIONS_POS_FRACTION
    target.SAMPLE_SIZE = OPTIONS_SAMPLE_SIZE
    target.NORM_BY_NUM_EXAMPLES = True
    target.BOX_CODER_CONFIG = {'encode_angle_by_sincos': True}
    model.DENSE_HEAD.LOSS_CONFIG.LOSS_WEIGHTS['code_weights'] = [1.0] * 8
    opt = cfg.OPTIMIZATION
    opt.OPTIMIZER = optimizer
    opt.DECAY_STEP_LIST = [1]
    opt.LR_WARMUP = True
    opt.WARMUP_EPOCH = 1
    opt.MOMENTUM = 0.9
    return cfg


def _plain(x):
    """A config as plain dicts and lists (``yaml.safe_dump`` takes them)."""
    if isinstance(x, dict):
        return {str(k): _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def _options_steps(net, cfg, batch, n_steps, state0):
    """``n_steps`` steps of ``cfg``'s optimizer from ``state0`` under
    deterministic algorithms: (per step the metrics and the gradients the
    optimizer took, before its clip; the state after)."""
    import torch
    net.module.load_state_dict(state0)
    net.init_training(cfg.OPTIMIZATION, TOTAL_STEPS, OPTIONS_ITERS_EACH_EPOCH)
    opt = net.train_state.optimizer
    grads, opt_step = [], opt.step

    def recording_step(g):
        grads.append([x.clone() for x in g])
        return opt_step(g)

    opt.step = recording_step
    metrics = []
    torch.use_deterministic_algorithms(True)
    try:
        for _ in range(n_steps):
            metrics.append({k: float(v) for k, v in net.train_step(batch).items()})
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
        del opt.step
    return metrics, grads, {k: v.clone() for k, v in net.module.state_dict().items()}


def _steps_equal(label, kernel_run, plain_run):
    """Fail unless two runs of :func:`_options_steps` agree bit for bit."""
    import numpy as np
    import torch
    (mk, gk, sk), (mp, gp, sp) = kernel_run, plain_run
    differ = [f'step {i} {k}' for i, (a, b) in enumerate(zip(mk, mp)) for k in a if a[k] != b[k]]
    differ += [f'step {i} gradient {j}' for i, (a, b) in enumerate(zip(gk, gp))
               for j, (x, y) in enumerate(zip(a, b)) if not torch.equal(x, y)]
    differ += [k for k in sp if not torch.equal(sk[k], sp[k])]
    print(f'options ({label}): {len(mk)} kernel steps vs {len(mp)} plain steps: '
          f'{sum(len(g) for g in gk)} gradient leaves, {len(sp)} weight and statistic '
          f'tensors, {sum(len(m) for m in mk)} metrics; {len(differ)} differ')
    if differ:
        fail(f'options ({label}): the kernel steps differ from the plain steps in {differ[:5]}')
    for i, m in enumerate(mk):
        if not all(np.isfinite(v) for v in m.values()):
            fail(f'options ({label}): step {i} metrics not finite: {m}')


def _subsample_counts(head, gt, n_steps):
    """Per scan the (foregrounds, backgrounds) before subsampling; per step,
    per scan those of the subsampled labels; and whether each step's labels
    differ from the step before's."""
    import torch
    from hvpr_tpu_torch.models.dense_heads.anchor_head_single import class_anchors
    asg = head.target_assigner
    with torch.no_grad():
        full = asg.pos_fraction
        asg.pos_fraction = None
        try:
            labels = asg.assign_targets(class_anchors(head), gt)['box_cls_labels']
        finally:
            asg.pos_fraction = full
        before = [(int((lab > 0).sum()), int((lab == 0).sum())) for lab in labels]
        after, redrawn, last = [], [], None
        for step in range(n_steps):
            labels = asg.assign_targets(class_anchors(head), gt,
                                        global_step=step)['box_cls_labels']
            after.append([(int((lab > 0).sum()), int((lab == 0).sum())) for lab in labels])
            if last is not None:
                redrawn.append(not torch.equal(labels, last))
            last = labels
    return before, after, redrawn


def options_phase(smi):
    """The options the JAX package accepts and the shipped configs do not
    set, on hvpr.yaml at full width (:func:`options_cfg`):

    (a) the fused train step at batch 4 on ``realistic_scans_with_boxes``
        (seed 0) from seeded weights: OPTIONS_ADAM_STEPS ``adam`` steps
        (2 iterations an epoch: the warmup, then the decay) through the
        kernels, counts from zero (the main path), must equal as many
        through the plain versions bit for bit under deterministic
        algorithms (each step's metrics and gradients, the weights after);
        then OPTIONS_SGD_STEPS ``sgd`` steps (MOMENTUM 0.9) likewise. Each
        scan's foregrounds must stay at most the cap and foregrounds plus
        backgrounds fill SAMPLE_SIZE. Timed steps with MATCH_HEIGHT and
        without (the assigner's rotated 3D IoU against the nearest-BEV
        IoU), their peaks, and the assigner alone either way.
    (b) the BEV backbone's train forward on the step's maps in the
        sequential and the stacked DUAL_PASS from the same weights: the
        outputs within DUAL_PASS_ATOL_FRAC of the largest (bf16, as
        hvpr.yaml runs it), and within DUAL_PASS_F32_ATOL_FRAC with the
        same weights in f32; both timed. Also the subsample at
        OPTIONS_BINDING_POS_FRACTION, whose cap binds on these scans.
    (c) the flat pipeline at batch 8 with TOPK_MODE approx and the sincos
        head (:func:`flat_phase`: K1 and K3 against their plain versions,
        no K2, the detections against the plain pipeline's bit for bit),
        whose detections must equal TOPK_MODE exact's bit for bit.
    (d) the train CLI in this process with a config file of these options
        (``adam``) written to a temporary directory, on a synthetic KITTI
        tree (OPTIONS_CLI_TRAIN_SCENES train, OPTIONS_CLI_VAL_SCENES val),
        --fix_random_seed, 2 epochs of 2 steps; then a run of another tag
        given the first run's checkpoint_epoch_1.pth, which resumes from it:
        its checkpoint_epoch_2.pth must equal the first run's bit for bit
        (weights, statistics, the Adam moments and steps, count).

    Returns {kernel: launches of (a)'s adam steps and (c)'s forward}."""
    import shutil
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch
    import yaml
    from hvpr_tpu_torch import config
    from hvpr_tpu_torch.datasets.kitti.kitti_dataset import create_kitti_infos
    from hvpr_tpu_torch.models import DatasetMeta, build_network
    from hvpr_tpu_torch.models.backbones_2d.base_bev_backbone import BaseBEVBackboneScale
    from hvpr_tpu_torch.models.dense_heads.anchor_head_single import class_anchors
    from hvpr_tpu_torch.ops import _kernels
    from hvpr_tpu_torch.tools import train
    from hvpr_tpu_torch.utils.scans import build_kitti_root, realistic_scans, \
        realistic_scans_with_boxes

    # (a) the train steps
    cfg = options_cfg('adam')
    meta = DatasetMeta(cfg.DATA_CONFIG, cfg.CLASS_NAMES, mode='train')
    net = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), meta, device='cuda', train=True)
    head = net.module.dense_head
    if head.box_coder.code_size != 8 or head.anchors.shape[-1] != 8 \
            or head.conv_box.out_channels != 2 * 8:
        fail('options: the head is not the 8-wide sincos head')
    seed_weights(net.module, seed=0)
    pts, gt = realistic_scans_with_boxes(np.random.default_rng(0), TRAIN_BATCH, N_POINTS,
                                         meta.point_cloud_range)
    points = torch.from_numpy(pts).cuda()
    mask = torch.ones(TRAIN_BATCH, N_POINTS, dtype=torch.bool, device='cuda')
    gt = torch.from_numpy(gt).cuda()
    batch = dict(net.voxelize(points, mask), gt_boxes=gt)
    state0 = {k: v.clone() for k, v in net.module.state_dict().items()}

    # the backbone's inputs of the first step, for (b)
    maps = {}

    def keep_maps(mod, args):
        if not maps:
            maps.update({k: args[0][k].detach().clone() for k in
                         ('spatial_features', 'spatial_features_point',
                          'spatial_scale_features')})

    hook = net.module.backbone_2d.register_forward_pre_hook(keep_maps)
    _kernels.reset_launch_counts()
    kernel_run = _options_steps(net, cfg, batch, OPTIONS_ADAM_STEPS, state0)
    launches = _kernels.launch_counts()
    hook.remove()
    print(f'options path (adam, {OPTIONS_ADAM_STEPS} steps) launches: {launches}')
    for name in without_iou(launches):
        want = STEP_LAUNCHES.get(name, 0) * OPTIONS_ADAM_STEPS
        if launches[name] != want:
            fail(f'options: {OPTIONS_ADAM_STEPS} steps launched {name} {launches[name]} '
                 f'times, expected {want}')
    lr = [net.train_state.optimizer.lr_fn(s) for s in range(OPTIONS_ADAM_STEPS)]
    with _kernels.plain_versions():
        plain_run = _options_steps(net, cfg, batch, OPTIONS_ADAM_STEPS, state0)
    print('options (adam): step metrics, kernels: ' + '; '.join(
        f'lr {x:.6g} loss {m["loss"]:.7g} grad_norm {m["grad_norm"]:.7g}'
        for x, m in zip(lr, kernel_run[0])))
    _steps_equal('adam', kernel_run, plain_run)
    if not (lr[0] < lr[1] and lr[2] < lr[1]):
        fail(f'options: the adam lr {lr} crosses no warmup and decay')
    del kernel_run, plain_run

    cfg_sgd = options_cfg('sgd')
    kernel_run = _options_steps(net, cfg_sgd, batch, OPTIONS_SGD_STEPS, state0)
    with _kernels.plain_versions():
        plain_run = _options_steps(net, cfg_sgd, batch, OPTIONS_SGD_STEPS, state0)
    print('options (sgd): step metrics, kernels: ' + '; '.join(
        f'loss {m["loss"]:.7g} grad_norm {m["grad_norm"]:.7g}' for m in kernel_run[0]))
    _steps_equal('sgd', kernel_run, plain_run)
    del kernel_run, plain_run

    cap = int(OPTIONS_POS_FRACTION * OPTIONS_SAMPLE_SIZE)
    before, after, redrawn = _subsample_counts(head, gt, OPTIONS_ADAM_STEPS)
    print(f'options: class Car (fg, bg) per scan before subsampling {before}; after, '
          f'per step: {after} (cap {cap}, SAMPLE_SIZE {OPTIONS_SAMPLE_SIZE}); labels '
          f'redrawn at each next step: {redrawn}')
    if not all(redrawn):
        fail('options: a step repeated the step before\'s subsample')
    # a cap below these scans' foregrounds, so that the cap binds on the card
    asg = head.target_assigner
    asg.pos_fraction = OPTIONS_BINDING_POS_FRACTION
    try:
        _, capped, _ = _subsample_counts(head, gt, 1)
    finally:
        asg.pos_fraction = OPTIONS_POS_FRACTION
    tight = int(OPTIONS_BINDING_POS_FRACTION * OPTIONS_SAMPLE_SIZE)
    print(f'options: at POS_FRACTION {OPTIONS_BINDING_POS_FRACTION} (cap {tight}) the '
          f'subsampled (fg, bg) per scan {capped[0]}')
    for (fg, bg), (fg0, bg0) in zip(capped[0], before):
        if fg != min(tight, fg0) or fg + bg != OPTIONS_SAMPLE_SIZE:
            fail(f'options: at cap {tight} the subsampled (fg, bg) {(fg, bg)} from {(fg0, bg0)}')
    for per_step in after:
        for (fg, bg), (fg0, bg0) in zip(per_step, before):
            if fg != min(cap, fg0) or (bg0 >= OPTIONS_SAMPLE_SIZE
                                       and fg + bg != OPTIONS_SAMPLE_SIZE):
                fail(f'options: subsampled (fg, bg) {(fg, bg)} from {(fg0, bg0)}')

    # timed steps with MATCH_HEIGHT and without, and the assigner alone
    timed = {}
    for match_height in (True, False):
        asg.match_height = match_height
        net.module.load_state_dict(state0)
        net.init_training(cfg.OPTIMIZATION, TOTAL_STEPS, OPTIONS_ITERS_EACH_EPOCH)
        net.train_step(batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(OPTIONS_TIMED_STEPS):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            net.train_step(batch)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        with torch.no_grad():
            assign_ms = cuda_ms(lambda: asg.assign_targets(class_anchors(head), gt,
                                                           global_step=0), reps=5, warmup=1)
        timed[match_height] = (statistics.median(times), torch.cuda.max_memory_allocated(),
                               assign_ms)
    asg.match_height = True
    (on_ms, on_peak, on_assign), (off_ms, off_peak, off_assign) = timed[True], timed[False]
    print(f'options train step (adam, batch {TRAIN_BATCH}): median of {OPTIONS_TIMED_STEPS} '
          f'{on_ms:.3f} ms with MATCH_HEIGHT, peak {on_peak / 2**30:.3f} GiB; without '
          f'{off_ms:.3f} ms, peak {off_peak / 2**30:.3f} GiB; the target assigner alone '
          f'{on_assign:.3f} ms with (rotated 3D IoU, {TRAIN_BATCH} scans x '
          f'{head.anchors.shape[0]} anchors x {gt.shape[1]} gt slots), {off_assign:.3f} ms '
          f'without (CUDA events); on {smi}')

    # (b) sequential against stacked: hvpr.yaml's bf16 backbone, then the
    # same weights in f32
    bb = net.module.backbone_2d
    bb_cfg = dict(bb.model_cfg, COMPUTE_DTYPE='fp32')
    bb_f32 = BaseBEVBackboneScale(bb_cfg, bb.blocks[0][1].in_channels,
                                  bb.scale_layers[0][1].in_channels).cuda()
    for label, mod, tol in (('bf16', bb, DUAL_PASS_ATOL_FRAC),
                            ('f32', bb_f32, DUAL_PASS_F32_ATOL_FRAC)):
        outs = {}
        for mode in ('sequential', 'stacked'):
            mod.model_cfg['DUAL_PASS'] = mode
            net.module.load_state_dict(state0)
            mod.load_state_dict(bb.state_dict())
            mod.train()
            with torch.no_grad():
                out = mod(dict(maps))
                ms = cuda_ms(lambda: mod(dict(maps)), reps=3, warmup=1)
            outs[mode] = ({k: out[k].float() for k in
                           ('spatial_features_2d', 'spatial_features_point_2d')}, ms)
        mod.model_cfg['DUAL_PASS'] = 'sequential'
        for k, want in outs['sequential'][0].items():
            got = outs['stacked'][0][k]
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            share = float(((got - want).abs() > 0).float().mean())
            print(f'options DUAL_PASS ({label}) {k}: stacked vs sequential max abs diff '
                  f'{err:.6g} ({err / scale:.3g} of the largest {scale:.6g}), {share:.4f} of '
                  f'the values differ; tolerance {tol:.6g} of the largest')
            if not (torch.isfinite(got).all() and err <= tol * scale):
                fail(f'options: the {label} stacked pass differs from the sequential pass '
                     f'in {k} by {err}')
        print(f'options BEV backbone train forward ({label}, no grad, batch {TRAIN_BATCH} + '
              f'{TRAIN_BATCH}): sequential {outs["sequential"][1]:.3f} ms, stacked '
              f'{outs["stacked"][1]:.3f} ms (CUDA events, median of 3); on {smi}')
    net.module.load_state_dict(state0)
    del net, outs, maps, state0, batch, bb_f32

    # (c) inference at batch 8: approx = exact = plain
    points = torch.from_numpy(realistic_scans(np.random.default_rng(0), BATCH, N_POINTS,
                                              cfg.DATA_CONFIG.POINT_CLOUD_RANGE)).cuda()
    mask = torch.ones(BATCH, N_POINTS, dtype=torch.bool, device='cuda')
    eval_net, _, _, infer_launches, res = flat_phase(smi, 'options', cfg, points, mask,
                                                     ('segment_sweep', 'bev_canvas'))
    scatter = eval_net.module.map_to_bev_module
    if scatter.topk_mode != 'approx':
        fail(f'options: the eval network runs TOPK_MODE {scatter.topk_mode}')
    scatter.topk_mode = 'exact'
    exact = eval_net.pipeline(points, mask)
    torch.cuda.synchronize()
    differ = [k for k in res if not torch.equal(res[k], exact[k])]
    print(f'options: the approx detections vs TOPK_MODE exact: keys that differ {differ}')
    if differ:
        fail(f'options: TOPK_MODE approx differs from exact in {differ}')
    del eval_net, res, exact

    # (d) the train CLI: resume from epoch 1 gives epoch 2's checkpoint
    build_dir = Path(ROOT) / 'build'
    build_dir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        root, _ = build_kitti_root(tmp / 'kitti',
                                   n_scenes=OPTIONS_CLI_TRAIN_SCENES + OPTIONS_CLI_VAL_SCENES,
                                   n_train=OPTIONS_CLI_TRAIN_SCENES)
        create_kitti_infos(root, root)
        cfg_file = tmp / 'options' / 'hvpr_options.yaml'
        cfg_file.parent.mkdir()
        cfg_file.write_text(yaml.safe_dump(_plain(options_cfg('adam'))))
        config.cfg.ROOT_DIR = tmp
        common = ['--cfg_file', os.path.relpath(cfg_file, ROOT), '--batch_size',
                  str(TRAIN_BATCH), '--workers', str(OPTIONS_CLI_WORKERS), '--epochs', '2',
                  '--fix_random_seed', '--num_epochs_to_eval', '1',
                  '--set', 'DATA_CONFIG.DATA_PATH', str(root)]
        group = os.path.relpath(cfg_file.parent, ROOT).split(os.sep)[1:]
        out = tmp.joinpath('output', *group, 'hvpr_options')
        walls = {}
        for tag in ('whole', 'resumed'):
            if tag == 'resumed':
                (out / tag / 'ckpt').mkdir(parents=True)
                shutil.copy(out / 'whole' / 'ckpt' / 'checkpoint_epoch_1.pth',
                            out / tag / 'ckpt' / 'checkpoint_epoch_1.pth')
            t1 = time.perf_counter()
            ret = train.main(['--extra_tag', tag] + common)
            walls[tag] = (time.perf_counter() - t1, ret)
        torch.cuda.synchronize()
        blobs = [torch.load(out / tag / 'ckpt' / 'checkpoint_epoch_2.pth',
                            map_location='cpu', weights_only=True)
                 for tag in ('whole', 'resumed')]
        resumed = walls['resumed'][1]
        if (resumed['start_epoch'], resumed['start_it']) != (1, OPTIONS_ITERS_EACH_EPOCH):
            fail(f'options CLI: the second run started at epoch {resumed["start_epoch"]}, '
                 f'it {resumed["start_it"]}')
        for blob in blobs:
            state = blob['optimizer_state']
            if state is None or 'optim' not in state \
                    or state['count'] != 2 * OPTIONS_ITERS_EACH_EPOCH:
                fail('options CLI: checkpoint_epoch_2.pth holds no adam state of 4 steps')
        differ = _differ(blobs[0], blobs[1])
        if differ:
            fail(f'options CLI: the resumed checkpoint_epoch_2.pth differs from the '
                 f'uninterrupted run\'s in {differ[:5]}')
        n_opt = len(blobs[0]['optimizer_state']['optim']['state'])
        phase_s = time.perf_counter() - t0
    print(f'options CLI: checkpoint_epoch_2.pth of the run resumed from epoch 1 equals the '
          f'uninterrupted run\'s bit for bit (weights, BN statistics, the Adam state of '
          f'{n_opt} parameters, count 4); main() {walls["whole"][0]:.2f} s (2 epochs and the '
          f'evaluation), resumed {walls["resumed"][0]:.2f} s; first lr '
          f'{walls["whole"][1]["first_lr"]!r}, resumed {resumed["first_lr"]!r}; the CLI '
          f'part {phase_s:.1f} s; on {smi}')
    return {k: launches[k] + infer_launches[k] for k in launches}


PROFILE_ITERS = 3                  # timed runs of each profiled region, after a warm-up
PROFILE_BATCH = 16                 # the JAX profilers' batches: inference, training
PROFILE_TRAIN_BATCH = 4
PROFILE_TOOLS = ('profile_stages', 'profile_train_stages', 'profile_post', 'profile_head',
                 'profile_pn2', 'profile_lookup', 'profile_train')
PROFILE_FORWARD_LAUNCHES = {'segment_sweep': 3, 'memory_lookup': 1, 'bev_canvas': 2,
                            'rotated_iou': PROFILE_BATCH}       # an NMS a scan


def _jax_record_keys(name):
    """The keys of a row of the JAX package's record ``name``."""
    with open(os.path.join(ROOT, name)) as f:
        return set(json.load(f)['stages'][0])


def _dense_formula(name, args):
    """The dense formula (``utils.flops``, the JAX package's) of one
    captured call of kernel ``name``, or None where it has none: a backward
    call's is the value with its forward."""
    from hvpr_tpu_torch.utils import flops
    if name == 'memory_lookup':
        return flops.memory_lookup_fused_flops(args[0].shape[0], *args[1].shape)
    if name.startswith('memory_recon'):
        x, w = args[0], args[1]
        return flops.memory_recon_flops(x.shape[0], w.shape[0], x.shape[1],
                                        name == 'memory_recon_bwd')
    if name in ('bucket_threshold', 'masked_attend_fwd', 'masked_attend_pairs',
                'masked_attend_bwd'):
        b, v, c = args[0].shape
        n = args[1].shape[1]
        if name == 'bucket_threshold':
            return flops.bucket_threshold_flops(b, v, n, c)
        shared = args[8] if name == 'masked_attend_bwd' else args[5]
        return flops.masked_attend_flops(b, v, n, c, shared, name == 'masked_attend_bwd')
    return None


def _check_counted_work(label, counter, works, calls):
    """Each kernel's counted work (what its wrapper reported to
    ``counter``) against ``works``, its work function over the captured
    ``calls`` (the bound column's), and under its dense formula."""
    from hvpr_tpu_torch.utils import flops
    for name, want in works.items():
        got = counter.kernels.get(name)
        if got is None or got['calls'] != len(calls[name]):
            fail(f'profile ({label}): {name} reported {got}, captured {len(calls[name])} calls')
        for key, value in (('ops', want.ops), ('bytes', want.nbytes)):
            if abs(got[key] - value) > 1e-9 * max(abs(value), 1.0):
                fail(f'profile ({label}): {name} counted {key} {got[key]}, its work function '
                     f'over the captured calls {value}')
        dense = [_dense_formula(name, a) for a, _ in calls[name]]
        ceiling = None if dense[0] is None else sum(dense)
        if ceiling is not None and got['ops'] > ceiling:
            fail(f'profile ({label}): {name} counted {got["ops"]} operations, above its dense '
                 f'formula {ceiling}')
        b_ms, b_by, _ = flops.work_bound(want)
        print(f'profile ({label}) {name}: {got["calls"]} call(s), counted {got["ops"] / 1e9:.6g} '
              f'GFLOP and {got["bytes"] / 1e9:.6g} GB = its work function over the captured '
              f'calls; bound {b_ms:.4f} ms ({b_by}); dense formula '
              + ('none' if ceiling is None else f'{ceiling / 1e9:.6g} GFLOP'))


def profile_phase(smi):
    """The port's profilers (``hvpr_tpu_torch/tools/profile_*.py``) on the
    card at hvpr.yaml's full width and the JAX tools' batches (16 for
    inference, 4 for training), PROFILE_ITERS timed runs a region, under
    torch's default backend flags: each record printed beside the card's
    power limit and written to ``chiprun_out/profile/``. It fails if a row
    lacks a key of the JAX record (``STAGE_PROFILE.json``,
    ``TRAIN_PROFILE.json``), a record names no card or power limit, an
    ``mfu`` is above 1 (a counting error), or backbone_2d or dense_head
    counts no flop; an ``hbm_frac`` above 1 is printed as a finding (the
    counter takes L2 hits as device-memory traffic). Then the profiled
    forward (batch 16) and one profiled step (batch 4) are counted again
    with every kernel wrapper call captured: each kernel's counted work
    must equal its work function over those calls and stay under its dense
    formula, and the forward must launch K1 x3, K2, K3 x2 and K13 once a
    scan (its NMS), the step STEP_LAUNCHES, nothing else but K13. Returns
    those two passes' launches."""
    import importlib
    import torch
    from hvpr_tpu_torch.models.backbones_2d.map_to_bev import (
        memory_module, pointpillar_scatter)
    from hvpr_tpu_torch.models.backbones_3d.vfe import pillar_vfe
    from hvpr_tpu_torch.ops import _kernels, nms as nms_module
    from hvpr_tpu_torch.tools import profile_stages, profile_train_stages
    from hvpr_tpu_torch.utils import flops

    keys = {'profile_stages': _jax_record_keys('STAGE_PROFILE.json'),
            'profile_train_stages': _jax_record_keys('TRAIN_PROFILE.json')}
    out_dir = os.path.join(ROOT, 'chiprun_out', 'profile')
    os.makedirs(out_dir, exist_ok=True)
    kind = torch.cuda.get_device_name(0)
    records = {}
    with cli_flags():
        for name in PROFILE_TOOLS:
            t0 = time.perf_counter()
            rec = importlib.import_module(f'hvpr_tpu_torch.tools.{name}').run(
                device='cuda', iters=PROFILE_ITERS)
            records[name] = rec
            with open(os.path.join(out_dir, f'{name}.json'), 'w') as f:
                json.dump(rec, f, indent=1)
            rows = rec.get('stages', [rec])
            print(f'profile {name} ({time.perf_counter() - t0:.1f} s; {rec["power_limit"]}): '
                  + '; '.join(
                      ', '.join(f'{k} {v}' for k, v in r.items()
                                if not isinstance(v, (dict, list)) and k != 'note')
                      for r in rows))
            if rec['device'] != kind or not rec['power_limit']:
                fail(f'profile {name}: device {rec["device"]!r}, power limit '
                     f'{rec["power_limit"]!r}')
            for row in rows:
                missing = keys.get(name, {'mfu', 'hbm_frac', 'bound'}) - set(row)
                if missing:
                    fail(f'profile {name}: row {row.get("stage")} lacks {sorted(missing)}')
                for k in ('mfu', 'cum_mfu'):
                    if row.get(k) is not None and row[k] > 1.0:
                        fail(f'profile {name}: {row.get("stage")} {k} {row[k]} above 1: a '
                             f'counting error')
                if (row.get('hbm_frac') or 0.0) > 1.0:
                    print(f'profile {name}: {row.get("stage")} hbm_frac {row["hbm_frac"]} '
                          f'above 1 (eager per-op bytes; L2 hits counted as device memory)')
            for k in ('pipeline_mfu', 'train_step_mfu'):
                if rec.get(k) is not None and rec[k] > 1.0:
                    fail(f'profile {name}: {k} {rec[k]} above 1: a counting error')
    gflop = {r['stage']: r['stage_gflop'] for r in records['profile_stages']['stages']}
    if not gflop['+backbone_2d'] > 0 or not gflop['+dense_head'] > 0:
        fail(f'profile: backbone_2d or dense_head counts no flop: {gflop}')

    device = torch.device('cuda')
    cfg = profile_stages.load_config()
    launches = {}
    # the profiled forward
    net = profile_stages.build(cfg, device)
    points, mask, _ = profile_stages.scans(net, PROFILE_BATCH, N_POINTS, 0, device)
    net.pipeline(points, mask)
    counters = []
    _kernels.reset_launch_counts()
    calls = capture_calls(
        [(pillar_vfe, 'segment_sweep', 'segment_sweep'),
         (memory_module, 'memory_lookup_fused', 'memory_lookup'),
         (pointpillar_scatter, 'canvas_from_sorted', 'bev_canvas'),
         (nms_module, 'boxes_iou_bev', 'rotated_iou')],
        lambda: counters.append(profile_stages.counted(lambda: net.pipeline(points, mask))[1]))
    torch.cuda.synchronize()
    fwd_launches = _kernels.launch_counts()
    if fwd_launches != {k: PROFILE_FORWARD_LAUNCHES.get(k, 0) for k in fwd_launches}:
        fail(f'profile: the counted forward launched {fwd_launches}, expected '
             f'{PROFILE_FORWARD_LAUNCHES}')
    works = {'segment_sweep': _sweep_work(calls['segment_sweep']),
             'memory_lookup': flops.total(
                 _lookup_work(a, memory_module.memory_lookup_fused(*a, return_stats=True)[2])
                 for a, _ in calls['memory_lookup']),
             'bev_canvas': _canvas_work(calls['bev_canvas']),
             'rotated_iou': flops.total(flops.rotated_iou_work(a[0].shape[0], a[1].shape[0], True)
                                        for a, _ in calls['rotated_iou'])}
    _check_counted_work(f'forward, batch {PROFILE_BATCH}', counters[0], works, calls)
    del net, points, mask, calls, counters

    # one profiled step
    net, data = profile_train_stages.train_setup(cfg, PROFILE_TRAIN_BATCH, device)
    net.train_step(data)
    wrappers = _train_wrappers()
    counters = []
    _kernels.reset_launch_counts()
    calls = capture_calls(
        [(mod, attr, name) for name, (mod, attr, _) in wrappers.items() if mod is not None],
        lambda: counters.append(profile_stages.counted(lambda: net.train_step(data))[1]))
    torch.cuda.synchronize()
    step_launches = _kernels.launch_counts()
    if without_iou(step_launches) != {k: STEP_LAUNCHES.get(k, 0)
                                      for k in without_iou(step_launches)}:
        fail(f'profile: the counted step launched {step_launches}, expected {STEP_LAUNCHES}')
    _split_attend_calls(calls)
    outs = {name: [wrappers[name][2](*a, **kw) for a, kw in calls[name]]
            for name in ('ball_query', 'masked_attend_fwd', 'masked_attend_pairs')}
    selected = {a[5]: float(out[3][a[6]].sum())
                for (a, _), out in zip(calls['masked_attend_fwd'] + calls['masked_attend_pairs'],
                                       outs['masked_attend_fwd'] + outs['masked_attend_pairs'])}
    recon_nonzero = _recon_nonzero(calls['memory_recon_fwd'])
    works = {name: _train_work(name, calls[name], outs.get(name, [None] * len(calls[name])),
                               selected, recon_nonzero) for name in STEP_LAUNCHES}
    _check_counted_work(f'step, batch {PROFILE_TRAIN_BATCH}', counters[0], works, calls)
    print(f'profile: the counted forward launched {fwd_launches}, the counted step '
          f'{step_launches}, on {smi}')
    return {k: fwd_launches[k] + step_launches[k] for k in fwd_launches}


def _descendants(pid):
    """{pid: parent pid} of every process below ``pid``."""
    parents = {}
    for stat in glob.glob('/proc/[0-9]*/stat'):
        try:
            with open(stat) as f:
                parents[int(stat.split('/')[2])] = int(f.read().rsplit(')', 1)[1].split()[1])
        except (OSError, IndexError, ValueError):
            continue
    below, frontier = {}, {pid}
    while frontier:
        frontier = {p: pp for p, pp in parents.items() if pp in frontier and p not in below}
        below.update(frontier)
    return below


def stop_descendants():
    """Kill and reap every process below this one that still runs. After a
    failed check a build's nvcc, a DataLoader's workers, their fork server
    and its resource tracker may be left: the workers go first, then the
    server and the tracker are stopped as they would be after a run that
    passed (the train_cli phase stops them), then the rest. After a run
    that passed this finds nothing."""
    # the DataLoader's SIGCHLD handler raises when one of its workers dies
    signal.signal(signal.SIGCHLD, signal.SIG_DFL)
    me = os.getpid()
    stopped = set()

    def kill(children_too):
        for _ in range(100):
            below = {p: pp for p, pp in _descendants(me).items()
                     if children_too or pp != me}
            if not below:
                return
            for pid in below:
                with contextlib.suppress(ProcessLookupError):
                    os.kill(pid, signal.SIGKILL)
            for pid, parent in below.items():
                if parent == me:
                    with contextlib.suppress(ChildProcessError):
                        os.waitpid(pid, 0)
            stopped.update(below)
            time.sleep(0.1)

    kill(children_too=False)
    datasets = sys.modules.get('hvpr_tpu_torch.datasets')
    if datasets is not None:
        datasets.stop_worker_server()
    kill(children_too=True)
    if stopped:
        print(f'chip_smoke: stopped {len(stopped)} processes left running',
              file=sys.stderr)


PHASES = ('inference', 'multiclass', 'pointpillar', 'nuscenes', 'eval_cli', 'train',
          'train_cli', 'ddp', 'second', 'nofp', 'demo', 'options', 'profile')


def main(argv=None):
    """Every phase, or with ``--only a,b`` those phases alone (a partial run
    for development: it prints no kernels line and no last line)."""
    import torch

    argv = sys.argv[1:] if argv is None else argv
    only = None
    if argv:
        if len(argv) != 2 or argv[0] != '--only' or not set(argv[1].split(',')) <= set(PHASES):
            print(f'usage: chip_smoke.py [--only {",".join(PHASES)}]', file=sys.stderr)
            return 2
        only = set(argv[1].split(','))
    if not torch.cuda.is_available():
        print('chip_smoke: torch sees no CUDA device', file=sys.stderr)
        return 2
    try:
        return run_phases(only)
    finally:
        stop_descendants()


def run_phases(only=None):
    import torch

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

    if only is not None:
        for name, phase in (('second', second_phase), ('nofp', nofp_phase),
                            ('demo', demo_phase), ('inference', inference_phase),
                            ('multiclass', multiclass_phase),
                            ('pointpillar', pointpillar_phase),
                            ('nuscenes', nuscenes_phase), ('eval_cli', eval_cli_phase),
                            ('train_cli', train_cli_phase), ('ddp', ddp_phase),
                            ('options', options_phase), ('profile', profile_phase)):
            if name in only:
                t0 = time.perf_counter()
                phase(smi)
                print(f'{name} phase: {time.perf_counter() - t0:.1f} s')
        if 'train' in only:
            three_nn_phase(train_phase(smi, 'fused')[3])
        print(f'partial run of {sorted(only)}: passed')
        return 0

    t0 = time.perf_counter()
    entries, launches = inference_phase(smi)
    print(f'inference phase: {time.perf_counter() - t0:.1f} s')
    t0 = time.perf_counter()
    multiclass_launches, multiclass_train_launches = multiclass_phase(smi)
    print(f'multiclass phase: {time.perf_counter() - t0:.1f} s')
    t0 = time.perf_counter()
    pointpillar_launches, pointpillar_train_launches = pointpillar_phase(smi)
    print(f'pointpillar phase: {time.perf_counter() - t0:.1f} s')
    t0 = time.perf_counter()
    nusc_entries, nusc_launches, nusc_cli_launches = nuscenes_phase(smi)
    print(f'nuscenes phase: {time.perf_counter() - t0:.1f} s')
    t0 = time.perf_counter()
    eval_launches = eval_cli_phase(smi)
    print(f'eval_cli phase: {time.perf_counter() - t0:.1f} s')
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
    t0 = time.perf_counter()
    train_cli_launches = train_cli_phase(smi)
    print(f'train_cli phase: {time.perf_counter() - t0:.1f} s')
    t0 = time.perf_counter()
    ddp_launches = ddp_phase(smi)
    print(f'ddp phase: {time.perf_counter() - t0:.1f} s')
    t0 = time.perf_counter()
    second_counts, k12_second, k14_second = second_phase(smi)
    print(f'second phase: {time.perf_counter() - t0:.1f} s')
    t0 = time.perf_counter()
    nofp_launches, nofp_entries = nofp_phase(smi)
    print(f'nofp phase: {time.perf_counter() - t0:.1f} s')
    t0 = time.perf_counter()
    demo_launches = demo_phase(smi)
    print(f'demo phase: {time.perf_counter() - t0:.1f} s')
    t0 = time.perf_counter()
    options_launches = options_phase(smi)
    print(f'options phase: {time.perf_counter() - t0:.1f} s')
    t0 = time.perf_counter()
    profile_launches = profile_phase(smi)
    print(f'profile phase: {time.perf_counter() - t0:.1f} s')
    from hvpr_tpu_torch.datasets import stop_worker_server
    stop_worker_server()    # no loader runs from here on
    print('step 1 from the same state, fused - gather: ' + ', '.join(
        f'{k} {fused_metrics[k] - gather_metrics[k]:.6g}' for k in sorted(fused_metrics)))
    entries.update(train_entries)
    entries.update(nn_entries)
    launches.update({k: train_launches[k] for k in STEP_LAUNCHES})
    launches['three_nn_bucket'] = nn_launches['three_nn_bucket']
    entries['sparse_rulebook'] = k14_second
    launches['sparse_rulebook'] = second_counts['a']['sparse_rulebook']

    kernels = []
    for name in _kernels.KERNELS:
        e = entries[name]
        kernels.append({'name': name, 'route': 'cuda',
                        'source': f'hvpr_tpu_torch/csrc/{_kernels.ENTRIES[name].source}.cu',
                        'replaces': META[name], 'launches': launches[name],
                        'max_abs_err': e['max_abs_err'], 'ms': e['ms'],
                        'plain_ms': e['plain_ms'], 'bound_ms': e['bound_ms'],
                        'bound_by': e['bound_by'], 'library_ms': e['library_ms']})
        for extra in ('dmma_bound_ms', 'device_ms', 'calls', 'clipped_share'):
            if extra in e:
                kernels[-1][extra] = e[extra]
        if name == 'fps_chunks':
            kernels[-1]['exact_fps'] = exact_fps
        if name == 'memory_lookup':
            kernels[-1]['eval_cli_launches'] = eval_launches[name]
        kernels[-1]['train_cli_launches'] = train_cli_launches[name]
        kernels[-1]['ddp_launches'] = ddp_launches[name]
        kernels[-1]['multiclass_launches'] = multiclass_launches[name]
        kernels[-1]['multiclass_train_launches'] = multiclass_train_launches[name]
        kernels[-1]['pointpillar_launches'] = pointpillar_launches[name]
        kernels[-1]['pointpillar_train_launches'] = pointpillar_train_launches[name]
        kernels[-1]['nuscenes_launches'] = nusc_launches[name]
        kernels[-1]['nuscenes_cli_launches'] = nusc_cli_launches[name]
        if name in nusc_entries:
            kernels[-1]['nuscenes'] = {k: nusc_entries[name][k] for k in (
                'max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms')}
        kernels[-1]['second_launches'] = second_counts['a'][name]
        kernels[-1]['second_multihead_launches'] = second_counts['b'][name]
        kernels[-1]['second_train_launches'] = second_counts['c'][name]
        kernels[-1]['nofp_launches'] = nofp_launches[name]
        kernels[-1]['demo_launches'] = demo_launches[name]
        kernels[-1]['options_launches'] = options_launches[name]
        kernels[-1]['profile_launches'] = profile_launches[name]
        if name in nofp_entries:
            kernels[-1]['nofp'] = nofp_entries[name]
        if name == 'gather_grad':
            kernels[-1]['second'] = k12_second
    print(json.dumps({'kernels': kernels}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
