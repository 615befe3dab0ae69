#!/usr/bin/env python3
"""What torch's deterministic algorithms cost the fused hvpr.yaml batch-4
train step, and which operation makes two steps differ without them, on
one NVIDIA GPU.

Run from the repository root:

    python3 tools/torch_port/deterministic_cost.py

It builds the train network as ``chip_smoke.py`` does (seeded weights,
``realistic_scans_with_boxes(seed 0)``, cuBLAS with a fixed workspace,
cuDNN deterministic and without TF32) and then:

1. Times ``Network.train_step`` with ``torch.use_deterministic_algorithms``
   off and on, one warm-up step each, then 5 steps each in turns (off, on,
   off, on, ...): host clock around synchronized steps and CUDA events
   around each step; it prints both medians.
2. Finds the operations whose backward is not reproducible: one forward of
   the step (under ``torch.autograd.detect_anomaly``, which records where
   each autograd node was made), then two backward passes over the same
   graph (``retain_graph``), each node's incoming and outgoing gradients
   digested (an exact integer hash of their bits). A node whose incoming
   gradients are the same bits in both passes and whose outgoing ones are
   not is a source of the difference; it prints each such node with the
   line of the port that made it. Done with the kernels (the step as
   shipped) and through the plain versions, each with the switch off and
   on. Two forwards are compared too (the loss and its terms).
"""

import collections
import contextlib
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
STEPS = 5


def digest(t):
    """An exact hash of a tensor's bits (int64 arithmetic, which wraps)."""
    import torch
    x = t.detach().contiguous().reshape(-1)
    width = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[x.element_size()]
    v = x.view(width).to(torch.int64)
    w = torch.arange(v.numel(), device=v.device, dtype=torch.int64) % 65521 + 1
    return (tuple(t.shape), int((v * w).sum()), int(v.sum()))


def graph_nodes(root):
    """The autograd nodes reachable from ``root``, in a fixed order."""
    seen, order, todo = set(), [], collections.deque([root])
    while todo:
        node = todo.popleft()
        if node is None or node in seen:
            continue
        seen.add(node)
        order.append(node)
        todo.extend(fn for fn, _ in node.next_functions)
    return order


def where_made(node):
    """The two innermost frames of the port in the node's forward traceback
    (recorded by anomaly mode), innermost first."""
    tb = node.metadata.get('traceback_')
    if not tb:
        return 'no traceback'
    lines = [ln.strip() for ln in ''.join(tb).splitlines() if 'hvpr_tpu_torch' in ln]
    return ' <- '.join(ln.split('hvpr_tpu_torch/')[-1] for ln in lines[::-1][:2])


def backward_sources(net, batch, params):
    """(forward equal, [(node name, where made, count)]) of one forward and
    two backwards over its graph."""
    import torch
    outs = []
    for _ in range(2):
        net.module.train()
        with torch.autograd.detect_anomaly(check_nan=False):
            out = net.module(dict(batch, global_step=0))
        outs.append(out)
    fwd_equal = all(digest(outs[0]['tb_dict'][k]) == digest(outs[1]['tb_dict'][k])
                    for k in outs[0]['tb_dict']) and \
        digest(outs[0]['loss']) == digest(outs[1]['loss'])
    out = outs[1]
    del outs
    loss = out['loss']
    nodes = graph_nodes(loss.grad_fn)
    record = {}

    def hook_of(i):
        def hook(grad_inputs, grad_outputs):
            record.setdefault(i, []).append((
                [digest(g) if g is not None else None for g in grad_outputs],
                [digest(g) if g is not None else None for g in grad_inputs]))
        return hook
    handles = [node.register_hook(hook_of(i)) for i, node in enumerate(nodes)]
    try:
        for _ in range(2):
            torch.autograd.grad(loss, params, retain_graph=True, allow_unused=True)
            torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    sources = collections.Counter()
    for i, runs in record.items():
        if len(runs) == 2 and runs[0][0] == runs[1][0] and runs[0][1] != runs[1][1]:
            sources[(nodes[i].name(), where_made(nodes[i]))] += 1
    differ = sum(1 for runs in record.values() if len(runs) == 2 and runs[0] != runs[1])
    return fwd_equal, sources, differ, len(record)


def main():
    # cuBLAS is deterministic only with a fixed workspace, set before its use
    os.environ.setdefault('CUBLAS_WORKSPACE_CONFIG', ':4096:8')
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    import numpy as np
    import torch
    import chip_smoke
    from hvpr_tpu_torch.models import DatasetMeta, build_network
    from hvpr_tpu_torch.ops import _kernels
    from hvpr_tpu_torch.utils.scans import realistic_scans_with_boxes

    if not torch.cuda.is_available():
        print('deterministic_cost: torch sees no CUDA device', file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    cfg = chip_smoke.load_cfg()
    meta = DatasetMeta(cfg.DATA_CONFIG, cfg.CLASS_NAMES, mode='train')
    net = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), meta, device='cuda', train=True)
    chip_smoke.seed_weights(net.module, seed=0)
    pts, gt = realistic_scans_with_boxes(np.random.default_rng(0), chip_smoke.TRAIN_BATCH,
                                         chip_smoke.N_POINTS, meta.point_cloud_range)
    mask = torch.ones(pts.shape[:2], dtype=torch.bool, device='cuda')
    batch = dict(net.voxelize(torch.from_numpy(pts).cuda(), mask),
                 gt_boxes=torch.from_numpy(gt).cuda())
    net.init_training(cfg.OPTIMIZATION, chip_smoke.TOTAL_STEPS)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         timeout=60).stdout.strip()

    # 1. the cost
    host = {False: [], True: []}
    dev = {False: [], True: []}
    try:
        for det in (False, True):
            torch.use_deterministic_algorithms(det)
            net.train_step(batch)
        for _ in range(STEPS):
            for det in (False, True):
                torch.use_deterministic_algorithms(det)
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                start.record()
                net.train_step(batch)
                end.record()
                torch.cuda.synchronize()
                host[det].append((time.perf_counter() - t0) * 1e3)
                dev[det].append(start.elapsed_time(end))
    finally:
        torch.use_deterministic_algorithms(False)
    for det in (False, True):
        print(f'fused step, deterministic algorithms {"on" if det else "off"}: median of '
              f'{STEPS} {statistics.median(host[det]):.3f} ms host clock, '
              f'{statistics.median(dev[det]):.3f} ms CUDA events; all host {host[det]} '
              f'on {smi}')
    print(f'deterministic algorithms cost the step '
          f'{statistics.median(host[True]) - statistics.median(host[False]):.3f} ms host, '
          f'{statistics.median(dev[True]) - statistics.median(dev[False]):.3f} ms device')

    # 2. the sources of the difference
    params = net.train_state.optimizer.params
    for path in ('kernels', 'plain'):
        for det in (False, True):
            torch.use_deterministic_algorithms(det)
            try:
                ctx = _kernels.plain_versions() if path == 'plain' else \
                    contextlib.nullcontext()
                with ctx:
                    fwd_equal, sources, differ, total = backward_sources(net, batch, params)
            finally:
                torch.use_deterministic_algorithms(False)
            print(f'{path} step, deterministic algorithms {"on" if det else "off"}: two '
                  f'forwards {"equal" if fwd_equal else "DIFFER"}; two backwards over one '
                  f'graph: {differ} of {total} nodes differ, '
                  f'{sum(sources.values())} of them with equal incoming gradients:')
            for (name, where), count in sources.most_common():
                print(f'  {name} x{count}, made at {where}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
