#!/usr/bin/env python3
"""Time K1 (the segment sweep) and K5 (FPS) against older versions of their
sources, on one NVIDIA GPU, with outputs checked equal.

Run from the repository root:

    python3 tools/torch_port/k1_k5_versions.py [--old-segment-sweep PATH] \\
        [--old-fps-chunks PATH]

It builds the libraries of ``hvpr_tpu_torch/csrc`` as they are and, where
given, older copies of ``segment_sweep.cu`` and ``fps_chunks.cu`` (with the
C entry points ``hvpr_segment_sweep``, ``hvpr_fps_chunks`` and
``hvpr_fps_long``) into ``build/``, and calls each kernel through ctypes,
without its Python wrapper:

- K1 on the three calls of one hvpr.yaml inference forward at batch 8
  (captured from ``Network.pipeline`` on ``realistic_scans(seed 0)`` with
  seeded random weights): the older source and this one, both equal to the
  plain version, the three calls together and each alone; beside them the
  nearest PyTorch composition of the same
  function, ``torch.segment_reduce`` over the runs of equal slot and
  ``index_select`` back to the rows (two calls a sweep; the runs are
  counted outside the timing).
- K5 on the fused train step's two chunked calls (SA1 (64, 1024, 256) and
  SA2 (64, 256, 64), captured from ``furthest_point_sample`` with
  ``FPS_CHUNKS`` 16 on ``realistic_scans_with_boxes(seed 0)``, batch 4) and
  on exact FPS over the batch's 4 whole scans, (4, 16384) to 4096 (the long
  path): the older source's entry point and each design that takes the
  shape (``hvpr_fps_design`` of ``tools/torch_port/fps_designs.cu``, built
  with this ``fps_chunks.cu``: blocks of 256 and 1024 threads, a warp, the
  long block, and clusters of blocks: 8 sending every warp's winner to each
  block across a cluster barrier, 4, 8 and 16 sending it by st.async, 8
  sending each block's winner by st.async), every one equal to the plain
  version; and each design's chain floor: the same number of dependent
  argmax steps with no distance work, on the device. The lowest chain
  floor of a shape is the latency bound of the function there; the kept
  design's floor beside it is what its exchange adds.

Each time is the CUDA-event median of 20 calls (the long path: 5), measured
in the order older, this, this, older (every variant once forward, then
once backward); the older source and this one are also timed through the
Python wrappers (the wrapper loading the older build), and their device
time is read with torch.profiler. It prints the card's name and power
limit beside the times.
"""

import argparse
import ctypes
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# the designs of tools/torch_port/fps_designs.cu (hvpr_fps_design)
DESIGNS = {0: 'block of 256', 1: 'warp', 2: 'block of 1024', 3: 'long block',
           4: 'cluster of 8, barrier', 5: 'cluster of 4, st.async', 6: 'cluster of 8, st.async',
           7: 'cluster of 16, st.async', 8: 'cluster of 8, block winners, st.async'}


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


def device_ms(fn, kernels=None, reps=5):
    """(device milliseconds a call of ``fn()``, kernel records found) from
    torch.profiler: the summed durations of the kernel records over the
    calls they make up, ``kernels`` records a call (else ``reps`` calls),
    so that a record the profiler drops does not bias the time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = [e.device_time_total for e in prof.events() if e.device_type == DeviceType.CUDA]
    calls = len(times) / kernels if kernels else reps
    return (sum(times) / 1e3 / calls if times else None), f'{len(times)} records of {reps} calls'


def with_library(source, lib, fn):
    """``fn`` run with the wrappers loading ``lib`` for kernel source
    ``source`` (an older build in place of this one)."""
    from hvpr_tpu_torch.ops import _kernels

    def run():
        saved = _kernels.library(source)
        _kernels._libs[source] = lib
        try:
            return fn()
        finally:
            _kernels._libs[source] = saved
    return run


def in_turns(runs, reps):
    """{name: [ms, ms]}: every run timed forward, then backward."""
    names = list(runs)
    times = {name: [] for name in names}
    for name in names + names[::-1]:
        times[name].append(cuda_ms(runs[name], reps=reps, warmup=2))
    return times


def sweep_calls():
    """[(x, slot, max_seg, op)] of K1's three calls in one batch-8 forward."""
    import numpy as np
    import torch
    import chip_smoke
    from hvpr_tpu_torch.models import DatasetMeta, build_network
    from hvpr_tpu_torch.models.backbones_3d.vfe import pillar_vfe
    from hvpr_tpu_torch.utils.scans import realistic_scans
    cfg = chip_smoke.load_cfg()
    meta = DatasetMeta(cfg.DATA_CONFIG, cfg.CLASS_NAMES)
    net = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), meta, device='cuda')
    chip_smoke.seed_weights(net.module, seed=0)
    points = torch.from_numpy(realistic_scans(np.random.default_rng(0), chip_smoke.BATCH,
                                              chip_smoke.N_POINTS,
                                              meta.point_cloud_range)).cuda()
    mask = torch.ones(points.shape[:2], dtype=torch.bool, device='cuda')
    with torch.no_grad():
        calls = chip_smoke.capture_calls([(pillar_vfe, 'segment_sweep', 'segment_sweep')],
                                         lambda: net.pipeline(points, mask))
    del net
    return [(a[0], a[1], a[2], a[3]) for a, _ in calls['segment_sweep']]


def k1_versions(old_lib):
    import torch
    from hvpr_tpu_torch.ops import _kernels
    from hvpr_tpu_torch.ops.segment_sweep import _OPS, segment_sweep, segment_sweep_plain
    calls = sweep_calls()
    outs = [torch.empty_like(x) for x, *_ in calls]
    libs = {'this source': _kernels.library('segment_sweep')}
    if old_lib:
        libs = {'older source': old_lib, **libs}
    p = _kernels.ptr

    def of(lib, which=(0, 1, 2)):
        fn = lib.hvpr_segment_sweep
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def run():
            for (x, slot, max_seg, op), out in [(calls[i], outs[i]) for i in which]:
                if fn(p(x), p(slot), p(out), x.shape[0], x.shape[1], max_seg, _OPS[op],
                      _kernels.stream_handle(x)):
                    raise RuntimeError('segment sweep launch failed')
        return run
    runs = {name: of(lib) for name, lib in libs.items()}
    for name, run in runs.items():
        for out in outs:
            out.fill_(7.0)
        run()
        torch.cuda.synchronize()
        for (x, slot, max_seg, op), out in zip(calls, outs):
            if not torch.equal(out, segment_sweep_plain(x, slot, max_seg, op)):
                raise RuntimeError(f'K1 ({name}) differs from plain at {tuple(x.shape)} {op}')

    # the nearest PyTorch composition: segment_reduce over the runs of equal
    # slot, then index_select back to the rows (runs counted outside the timing)
    comp = []
    for x, slot, _, op in calls:
        _, counts = torch.unique_consecutive(slot, return_counts=True)
        seg_of_row = torch.repeat_interleave(torch.arange(counts.numel(), device='cuda'),
                                             counts)
        comp.append((x, 'amax' if op == 'max' else 'sum',
                     counts.expand(x.shape[0], -1).contiguous(), seg_of_row))

    def composition():
        for x, red, lengths, seg_of_row in comp:
            torch.index_select(torch.segment_reduce(x, red, lengths=lengths, axis=1), 1,
                               seg_of_row)
    device = {name: device_ms(run, kernels=3) for name, run in runs.items()}
    runs['segment_reduce + index_select'] = composition
    device['segment_reduce + index_select'] = device_ms(composition)
    for name in ('older source', 'this source'):
        if name in libs:
            runs[f'{name}, through the wrapper'] = with_library(
                'segment_sweep', libs[name], lambda: [segment_sweep(x, slot, max_seg, op)
                                                      for x, slot, max_seg, op in calls])
    for i, (x, _, _, op) in enumerate(calls):
        runs.update({f'{name}, the {tuple(x.shape)} {op} call alone': of(lib, (i,))
                     for name, lib in libs.items()})
    shapes = [(tuple(x.shape), max_seg, op) for x, _, max_seg, op in calls]
    nbytes = sum(2 * x.numel() * 4 + slot.numel() * 4 for x, slot, *_ in calls)
    return in_turns(runs, reps=20), device, shapes, nbytes


def fps_inputs():
    """{label: (pts, valid, nsamp)} of the step's two chunked FPS calls and of
    exact FPS over the batch's whole scans."""
    import numpy as np
    import torch
    import chip_smoke
    from hvpr_tpu_torch.models import DatasetMeta
    from hvpr_tpu_torch.ops import pointnet2
    from hvpr_tpu_torch.utils.scans import realistic_scans_with_boxes
    cfg = chip_smoke.load_cfg()
    meta = DatasetMeta(cfg.DATA_CONFIG, cfg.CLASS_NAMES, mode='train')
    sa = cfg.MODEL.BACKBONE_3D.SA_CONFIG
    pts, _ = realistic_scans_with_boxes(np.random.default_rng(0), chip_smoke.TRAIN_BATCH,
                                        chip_smoke.N_POINTS, meta.point_cloud_range)
    xyz = torch.from_numpy(np.ascontiguousarray(pts[..., :3])).cuda()
    mask = torch.ones(xyz.shape[:2], dtype=torch.bool, device='cuda')
    out = {}

    def levels():
        x, m = xyz, mask
        for npoint in sa.NPOINTS:
            idx = pointnet2.furthest_point_sample(x, m, int(npoint),
                                                  num_chunks=int(sa.FPS_CHUNKS))
            x, m = pointnet2.group_points(x, idx).contiguous(), torch.gather(m, 1, idx)
    calls = chip_smoke.capture_calls([(pointnet2, 'fps_chunks', 'fps_chunks')], levels)
    for name, (args, _) in zip(('SA1', 'SA2'), calls['fps_chunks']):
        out[f'{name} {tuple(args[0].shape)} -> {args[2]}'] = args
    calls = chip_smoke.capture_calls(
        [(pointnet2, 'fps_chunks', 'fps_chunks')],
        lambda: pointnet2.furthest_point_sample(xyz, mask, chip_smoke.EXACT_FPS_NPOINT))
    args = calls['fps_chunks'][0][0]
    out[f'exact {tuple(args[0].shape)} -> {args[2]}'] = args
    return out


def k5_versions(old_lib):
    import torch
    from hvpr_tpu_torch.ops import _kernels
    from hvpr_tpu_torch.ops.pn2_select import _FPS_MAX_ROWS, fps_chunks, fps_chunks_plain
    design = build(os.path.join('tools', 'torch_port', 'fps_designs.cu'),
                   'fps_designs').hvpr_fps_design
    design.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    design.restype = ctypes.c_int
    p = _kernels.ptr
    results = {}
    for label, (pts, valid, nsamp) in fps_inputs().items():
        r, l, _ = pts.shape
        want = fps_chunks_plain(pts, valid, nsamp)
        out = torch.empty_like(want)
        tail = torch.empty(r, l, device='cuda')
        s = _kernels.stream_handle(pts)
        runs, chains = {}, {}
        if old_lib:
            if l <= _FPS_MAX_ROWS:
                fn = old_lib.hvpr_fps_chunks
                fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
                args = (p(pts), p(valid), p(out), r, l, nsamp, s)
            else:
                fn = old_lib.hvpr_fps_long
                fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
                args = (p(pts), p(valid), p(tail), p(out), r, l, nsamp, s)
            fn.restype = ctypes.c_int
            runs['older source'] = lambda fn=fn, args=args: fn(*args)
        for d, name in DESIGNS.items():
            if (d in (0, 2) and l > _FPS_MAX_ROWS) or (d == 1 and l > 256) or (
                    d == 3 and l <= _FPS_MAX_ROWS):
                continue
            for chain, table in ((0, runs), (1, chains)):
                table[f'this source, {name}'] = (
                    lambda d=d, chain=chain: design(d, chain, p(pts), p(valid), p(tail),
                                                   p(out), r, l, nsamp, s))
        for name, run in runs.items():
            out.fill_(-1)
            if run():
                raise RuntimeError(f'K5 {name} failed to launch at {label}')
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise RuntimeError(f'K5 {name} differs from plain at {label} in '
                                   f'{int((out != want).sum())} indices')
        device = {name: device_ms(run, kernels=1) for name, run in runs.items()}
        wrapped = {'this source': _kernels.library('fps_chunks')}
        if old_lib:
            wrapped = {'older source': old_lib, **wrapped}
        for name, lib in wrapped.items():
            runs[f'{name}, through the wrapper'] = with_library(
                'fps_chunks', lib, lambda: fps_chunks(pts, valid, nsamp))
        reps = 20 if l <= _FPS_MAX_ROWS else 5
        times = in_turns(runs, reps)
        floors = {name: device_ms(run, kernels=1) for name, run in chains.items()}
        results[label] = (times, floors, device, 10.0 * r * l * nsamp)
    return results


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--old-segment-sweep', help='an older csrc/segment_sweep.cu')
    ap.add_argument('--old-fps-chunks', help='an older csrc/fps_chunks.cu')
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    import torch
    if not torch.cuda.is_available():
        print('k1_k5_versions: torch sees no CUDA device', file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from hvpr_tpu_torch.ops import _kernels
    _kernels.build_all()
    old_k1 = build(args.old_segment_sweep, 'segment_sweep_older') \
        if args.old_segment_sweep else None
    old_k5 = build(args.old_fps_chunks, 'fps_chunks_older') if args.old_fps_chunks else None
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    k1, k1_device, shapes, nbytes = k1_versions(old_k1)
    print(f'K1 calls of one forward (shape, max_seg, op): {shapes}; bound '
          f'{nbytes / 3.35e12 * 1e3:.4f} ms ({nbytes} bytes at 3.35 TB/s)')
    for name, ms in k1.items():
        what = '' if 'alone' in name else ' for the forward\'s 3 calls'
        print(f'K1 {name}: {ms} ms{what} (kernels equal to plain) on {smi}')
    for name, (ms, found) in k1_device.items():
        print(f'K1 {name}: device {ms} ms for the forward\'s 3 calls (torch.profiler, '
              f'{found})')
    for label, (times, floors, device, ops) in k5_versions(old_k5).items():
        print(f'K5 {label}: operation bound {ops / 67e12 * 1e3:.5f} ms ({ops:.3g} f32 '
              f'operations at 67 TFLOP/s)')
        for name, ms in times.items():
            print(f'K5 {label} {name}: {ms} ms (equal to plain) on {smi}')
        for name, (ms, found) in floors.items():
            print(f'K5 {label} {name}, chain floor: device {ms} ms (torch.profiler, {found}) '
                  f'on {smi}')
        name, (ms, _) = min(((name, floor) for name, floor in floors.items()
                             if floor[0] is not None), key=lambda item: item[1][0])
        print(f'K5 {label}: latency bound {ms} ms, the lowest chain floor ({name})')
        for name, (ms, found) in device.items():
            print(f'K5 {label} {name}: device {ms} ms (torch.profiler, {found})')
    return 0


if __name__ == '__main__':
    sys.exit(main())
