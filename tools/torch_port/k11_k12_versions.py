#!/usr/bin/env python3
"""Time K12 (the row gathers' deterministic backward) and K11 (the bucketed
3-NN) against their first designs, on one NVIDIA GPU, with equal outputs.

Run from the repository root:

    python3 tools/torch_port/k11_k12_versions.py [--variants "SOURCE:NAME=VALUE,...;..."]

It builds the libraries of ``hvpr_tpu_torch/csrc`` as they are and the
first designs of both kernels (``chip_smoke.FIRST_DESIGNS``: their sources
before their Hopper redesigns, K12 with the wrapper it had, a stable
``torch.sort`` of the targets and ``searchsorted``) into ``build/``. Then:

- K12 at the calls of one fused hvpr.yaml train step at batch 4 (SA2's two
  groupings, the two FP interpolations: ``chip_smoke.py``'s train batch
  and seeded weights) and at the 5 distinct shapes of one ATSS step of
  ``chip_smoke.second_cfg`` at batch 4 (SECOND's widths): each version
  equal to the plain version on the CPU bit for bit, timed in turns
  (first design, this, this, first design), each split into set-up and
  summing kernel (``chip_smoke.k12_split``), beside ``index_add_`` into a
  zeroed buffer; each call's hub sizes and device ms by kernel; the host
  time of one call and of its parts (``host_parts``); then K12's share of
  each step (``chip_smoke.k12_share``: the sum of its calls' spans on the
  stream, the step's median of 3).
- K11 on the inputs of the fused step's two ``pointnet2.three_nn`` calls:
  each version equal to the plain version (indices and distances), timed
  in turns.

``--variants`` adds builds of this ``three_nn.cu`` or ``gather_grad.cu``
with other values of their constants, timed beside this source.

It prints the card's name and power limit beside the times.
"""

import argparse
import ctypes
import os
import re
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


def fused_step():
    """(the step's K12 calls, its pointnet2.three_nn calls, a function that
    runs one train step): hvpr.yaml fused at batch 4, as chip_smoke.py's
    train phase builds it."""
    import numpy as np
    import torch
    import chip_smoke
    from hvpr_tpu_torch.models import DatasetMeta, build_network
    from hvpr_tpu_torch.ops import gather_rows, pointnet2
    from hvpr_tpu_torch.utils.scans import realistic_scans_with_boxes
    cfg = chip_smoke.load_cfg()
    meta = DatasetMeta(cfg.DATA_CONFIG, cfg.CLASS_NAMES, mode='train')
    net = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), meta, device='cuda', train=True)
    chip_smoke.seed_weights(net.module, seed=0)
    pts, gt = realistic_scans_with_boxes(np.random.default_rng(0), chip_smoke.TRAIN_BATCH,
                                         chip_smoke.N_POINTS, meta.point_cloud_range)
    points = torch.from_numpy(pts).cuda()
    mask = torch.ones(points.shape[:2], dtype=torch.bool, device='cuda')
    batch = dict(net.voxelize(points, mask), gt_boxes=torch.from_numpy(gt).cuda())
    net.init_training(cfg.OPTIMIZATION, chip_smoke.TOTAL_STEPS)
    calls = chip_smoke.capture_calls(
        [(gather_rows, 'gather_rows_backward', 'gather_grad'),
         (pointnet2, 'three_nn', 'three_nn')], lambda: net.train_step(batch))
    return ([a for a, _ in calls['gather_grad']], [a for a, _ in calls['three_nn']],
            lambda: net.train_step(batch))


def second_step():
    """(the first K12 call of each distinct shape of one ATSS step at
    SECOND's widths, a function that runs one train step), as
    chip_smoke.py's second phase builds them."""
    import numpy as np
    import torch
    import chip_smoke
    from hvpr_tpu_torch.models import DatasetMeta, load_data_to_gpu
    from hvpr_tpu_torch.ops import gather_rows
    from hvpr_tpu_torch.parallel import loss_and_grads
    from hvpr_tpu_torch.utils.scans import realistic_scans_with_boxes
    cfg = chip_smoke.second_cfg(assigner='ATSS')
    meta = DatasetMeta(cfg.DATA_CONFIG, cfg.CLASS_NAMES, mode='train')
    pts, gt = realistic_scans_with_boxes(np.random.default_rng(0), chip_smoke.SECOND_BATCH,
                                         chip_smoke.SECOND_POINTS, meta.point_cloud_range)
    batch = dict(load_data_to_gpu(chip_smoke.padded_voxels(pts, meta), 'cuda'),
                 gt_boxes=torch.from_numpy(gt).cuda())
    net = chip_smoke.second_network(cfg, meta, 'cuda', train=True)
    net.init_training(cfg.OPTIMIZATION, chip_smoke.TOTAL_STEPS)
    calls = chip_smoke._first_calls_by_shape(
        gather_rows, 'gather_rows_backward', lambda: loss_and_grads(net.train_state, batch))
    return [a for a, _ in calls], lambda: net.train_step(batch)


def k12_versions(label, calls, step, variants, smi):
    import torch
    import chip_smoke
    from hvpr_tpu_torch.ops import gather_rows
    versions = {'first design': chip_smoke._first['gather_grad'],
                'this': gather_rows.gather_rows_backward,
                **{name: with_library('gather_grad', lib, gather_rows.gather_rows_backward)
                   for name, lib in variants.items()}}
    for grad, index, n in calls:
        counts = torch.bincount(index, minlength=n)
        per_call = {name: chip_smoke.device_times(lambda: fn(grad, index, n))
                    for name, fn in versions.items()}
        print(f'K12 {label} call {tuple(grad.shape)} {str(grad.dtype).split(".")[-1]} into '
              f'{n}: rows a target max {int(counts.max())}, targets above 32 rows '
              f'{int((counts > 32).sum())}, above 256 {int((counts > 256).sum())}; device ms '
              + '; '.join(f'{name}: ' + ', '.join(f'{k} {v:.4f}' for k, v in d.items())
                          for name, d in per_call.items()))
    for name, fn in versions.items():
        for grad, index, n in calls:
            want = gather_rows.gather_rows_backward_plain(grad.cpu(), index.cpu(), n)
            if not torch.equal(fn(grad, index, n).cpu(), want):
                raise SystemExit(f'K12 {name} differs from its plain version at '
                                 f'{tuple(grad.shape)} {grad.dtype} n {n}')
    runs = {name: (lambda fn=fn: [fn(*a) for a in calls]) for name, fn in versions.items()}
    turns = {name: [] for name in runs}
    for name in list(runs) + list(runs)[::-1]:
        turns[name].append(chip_smoke.cuda_ms(runs[name], reps=20, warmup=3))
    lib_ms = 0.0
    for grad, index, n in calls:
        buf = torch.zeros(n, grad.shape[1], dtype=grad.dtype, device=grad.device)
        lib_ms += chip_smoke.cuda_ms(lambda: buf.index_add_(0, index, grad), reps=20)
    b_ms, b_by = chip_smoke._k12_bound([(a, {}) for a in calls])
    print(f'K12 {label}: {len(calls)} calls at '
          f'{[(tuple(g.shape), str(g.dtype).split(".")[-1], n) for g, _, n in calls]}; '
          f'bound {b_ms:.4f} ms ({b_by}), index_add_ {lib_ms:.4f} ms; on {smi}')
    for name in runs:
        print(f'K12 {label} {name}: in turns {turns[name]} ms (equal to plain); '
              + chip_smoke.k12_split_text(chip_smoke.k12_split(runs[name])))
    print(f'K12 {label}: host microseconds a call (median of 100, no synchronize): '
          + ', '.join(f'{k} {v:.1f}' for k, v in host_parts(calls[0]).items()))
    step_ms, k12_ms, n_calls = chip_smoke.k12_share(step)
    print(f'K12 {label}: one step {step_ms:.3f} ms (median of 3), K12 {n_calls} calls '
          f'{k12_ms:.3f} ms of it ({k12_ms / step_ms:.4f}); on {smi}')


def host_parts(call):
    """{part: median host microseconds} of K12's wrapper on ``call`` and of
    its parts, each issued 100 times without a synchronize (the card runs
    behind): the whole wrapper, its two allocations, the current stream's
    handle, the ctypes call alone, and index_add_ into a zeroed buffer."""
    import statistics
    import time
    import torch
    from hvpr_tpu_torch.ops import _kernels, gather_rows
    grad, index, n = call
    scratch = gather_rows._scratch(grad.shape[0], n, grad.device)
    out = torch.empty(n, grad.shape[1], dtype=grad.dtype, device=grad.device)
    fn = _kernels.entry('gather_grad', 'hvpr_gather_grad', gather_rows._SUM)
    stream = torch.cuda.current_stream(grad.device).cuda_stream
    bf16 = int(grad.dtype == torch.bfloat16)
    parts = {
        'wrapper': lambda: gather_rows.gather_rows_backward(grad, index, n),
        'allocations': lambda: (torch.empty(n, grad.shape[1], dtype=grad.dtype,
                                            device=grad.device),
                                gather_rows._scratch(grad.shape[0], n, grad.device)),
        'stream handle': lambda: torch.cuda.current_stream(grad.device).cuda_stream,
        'the C call (its launches)': lambda: fn(
            grad.data_ptr(), index.data_ptr(), scratch.data_ptr(), out.data_ptr(),
            grad.shape[0], n, grad.shape[1], bf16, 1, stream),
        'zeros + index_add_': lambda: torch.zeros(n, grad.shape[1], dtype=grad.dtype,
                                                  device=grad.device).index_add_(0, index, grad),
    }
    got = {}
    for name, part in parts.items():
        times = []
        for _ in range(100):
            t0 = time.perf_counter()
            part()
            times.append((time.perf_counter() - t0) * 1e6)
        torch.cuda.synchronize()
        got[name] = statistics.median(times)
    return got


def variant_builds(spec):
    """{source: {label: library}}: builds of this csrc/<source>.cu with the
    constants of each ';'-separated group of ``spec`` set
    ("three_nn:kPerWarp=4,kTile=1024;gather_grad:kRows=4")."""
    libs = {'three_nn': {}, 'gather_grad': {}}
    for group in filter(None, spec.split(';')):
        source, sets = group.split(':')
        text = open(os.path.join('hvpr_tpu_torch', 'csrc', f'{source}.cu')).read()
        tag = sets.replace('=', '').replace(',', '_')
        for item in sets.split(','):
            name, value = item.split('=')
            text, hits = re.subn(rf'constexpr int {name} = \w+;',
                                 f'constexpr int {name} = {value};', text)
            if hits != 1:
                raise ValueError(f'{name}: no single constant in {source}.cu')
        cu = os.path.join('build', f'{source}_{tag}.cu')
        with open(cu, 'w') as f:
            f.write(text)
        libs[source][f'({sets})'] = build(cu, f'{source}_{tag}')
    return libs


def with_library(source, lib, fn):
    """``fn`` run with the wrappers loading ``lib`` for csrc/<source>.cu
    (a build with other constants)."""
    from hvpr_tpu_torch.ops import _kernels

    def run(*args):
        saved = _kernels.library(source)
        _kernels._libs[source] = lib
        try:
            return fn(*args)
        finally:
            _kernels._libs[source] = saved
    return run


def k11_versions(calls, variants, smi):
    import torch
    import chip_smoke
    from hvpr_tpu_torch.ops import _kernels, pn2_select
    versions = {'first design': chip_smoke._first['three_nn_bucket'],
                'this': pn2_select.three_nn_bucket,
                **{label: with_library('three_nn', lib, pn2_select.three_nn_bucket)
                   for label, lib in variants.items()}}
    for unknown, known, mask in calls:
        with _kernels.plain_versions():
            wd, wi = pn2_select.three_nn_bucket(unknown, known, mask)
        for name, fn in versions.items():
            gd, gi = fn(unknown, known, mask)
            if not (torch.equal(gi, wi) and torch.equal(gd, wd)):
                raise SystemExit(f'K11 {name} differs from its plain version at '
                                 f'{tuple(unknown.shape)} x {tuple(known.shape)}')
    runs = {name: (lambda fn=fn: [fn(*a) for a in calls]) for name, fn in versions.items()}
    turns = {name: [] for name in runs}
    for name in list(runs) + list(runs)[::-1]:
        turns[name].append(chip_smoke.cuda_ms(runs[name], reps=20, warmup=3))
    for name, ms in turns.items():
        print(f'K11 {name}: {ms} ms for the fused step\'s two calls at '
              f'{[(tuple(u.shape), tuple(k.shape)) for u, k, _ in calls]} (equal to plain); '
              f'device: ' + chip_smoke.device_breakdown(runs[name]) + f'; on {smi}')


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--variants', default='',
                    help='builds of this source with other constants, '
                         '"SOURCE:NAME=VALUE,NAME=VALUE;...": e.g. three_nn:kTile=1024, '
                         'gather_grad:kRows=4')
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    import torch
    if not torch.cuda.is_available():
        print('k11_k12_versions: torch sees no CUDA device', file=sys.stderr)
        return 2
    import chip_smoke
    from hvpr_tpu_torch.ops import _kernels
    first = chip_smoke.start_first_designs()
    _kernels.build_all()
    chip_smoke.load_first_designs(first)
    variants = variant_builds(args.variants)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    k12_calls, nn_calls, step = fused_step()
    k12_versions('fused step', k12_calls, step, variants['gather_grad'], smi)
    k11_versions(nn_calls, variants['three_nn'], smi)
    del k12_calls, nn_calls, step
    torch.cuda.empty_cache()
    k12_calls, step = second_step()
    k12_versions('ATSS step', k12_calls, step, variants['gather_grad'], smi)
    return 0


if __name__ == '__main__':
    sys.exit(main())
