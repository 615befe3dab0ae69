#!/usr/bin/env python3
"""Time K9's dense sweep (``hvpr_masked_attend_fwd``) at three tile sizes on
the same inputs, on one NVIDIA GPU.

Run from the repository root:

    python3 tools/torch_port/k9_tile_sizes.py

The source ``hvpr_tpu_torch/csrc/topk_attend.cu`` sets the tile's rows in
one constant, ``kARows``; this script builds the library as it is and two
copies with the other sizes of 16, 32 and 64 rows into ``build/``, checks
that all three give the same outputs (out, mx, den, count, pairs) on
hvpr.yaml's shapes at batch 4 (seeded random pillars and points, ~9,500
valid rows a scan as in the fused train step, thresholds from K8 with
k = 20), and prints each size's CUDA-event median over 20 calls, measured
twice in the order 16/32/64, 64/32/16 relative to the source's size.
"""

import ctypes
import os
import re
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SIZES = (16, 32, 64)


def main():
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    import numpy as np
    import torch
    from hvpr_tpu_torch.ops import _kernels
    from hvpr_tpu_torch.ops import topk_attend as ta

    if not torch.cuda.is_available():
        print('k9_tile_sizes: torch sees no CUDA device', file=sys.stderr)
        return 2
    src_path = os.path.join('hvpr_tpu_torch', 'csrc', 'topk_attend.cu')
    src = open(src_path).read()
    own = int(re.search(r'constexpr int kARows = (\d+);', src).group(1))
    libs = {own: _kernels.library('topk_attend')}
    os.makedirs('build', exist_ok=True)
    for rows in SIZES:
        if rows == own:
            continue
        cu = os.path.join('build', f'topk_attend_rows{rows}.cu')
        with open(cu, 'w') as f:
            f.write(src.replace(f'constexpr int kARows = {own};',
                                f'constexpr int kARows = {rows};'))
        so = os.path.join('build', f'libtopk_attend_rows{rows}.so')
        res = subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, '-I',
                              str(_kernels.CSRC), '-o', so, cu],
                             capture_output=True, text=True)
        if res.returncode:
            print(res.stdout, res.stderr, file=sys.stderr)
            return 1
        libs[rows] = ctypes.CDLL(os.path.abspath(so))

    rng = np.random.default_rng(0)
    b, v, n, c, k = 4, 16000, 16384, 64, 20
    pill = torch.from_numpy(rng.normal(size=(b, v, c)).astype(np.float32)).cuda()
    pts = torch.from_numpy(rng.normal(size=(b, n, c)).astype(np.float32)).cuda()
    neg = torch.zeros(b, n, device='cuda')
    mask = torch.zeros(b, v, dtype=torch.bool, device='cuda')
    for i, valid in enumerate((9300, 9600, 9500, 9647)):
        mask[i, :valid] = True
    th = ta.bucket_threshold(pill, pts, neg, k, mask)
    pb, sb = pill.to(torch.bfloat16).contiguous(), pts.to(torch.bfloat16).contiguous()

    def run(lib):
        outs = [torch.empty(b, v, c, device='cuda'), torch.empty(b, v, device='cuda'),
                torch.empty(b, v, device='cuda'),
                torch.empty(b, v, dtype=torch.int32, device='cuda'),
                torch.empty(b, v, ta.PAIR_CAP, dtype=torch.int32, device='cuda'),
                torch.empty(b, v, ta.PAIR_CAP, dtype=torch.bfloat16, device='cuda')]
        fn = lib.hvpr_masked_attend_fwd
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = fn(*[_kernels.ptr(t) for t in (pb, sb, sb, neg, th, mask)],
                 *[_kernels.ptr(t) for t in outs], b, v, n, c, 1,
                 _kernels.stream_handle(pb))
        if err:
            raise RuntimeError(f'launch failed: cudaError {err}')
        return outs

    def ms(lib, reps=20):
        for _ in range(3):
            run(lib)
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run(lib)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    ref = run(libs[own])
    torch.cuda.synchronize()
    print(f'selected points per valid row: {float(ref[3][mask].float().mean()):.3f}')
    for rows, lib in libs.items():
        got = run(lib)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, ref)):
            print(f'{rows}-row tiles differ from {own}-row tiles', file=sys.stderr)
            return 1
    order = sorted(libs) + sorted(libs, reverse=True)
    times = {rows: [] for rows in libs}
    for rows in order:
        times[rows].append(ms(libs[rows]))
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    for rows in sorted(times):
        print(f'K9 dense sweep, {rows}-row tiles: {times[rows]} ms (equal outputs) on {smi}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
