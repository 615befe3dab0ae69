#!/usr/bin/env python3
"""Times of the port's evaluation entry point on one NVIDIA GPU: the eval
loop past its start-up, and the padded (host-voxelized) and flat (device
voxelizer) layouts of hvpr.yaml at batch 8 on one batch, stage by stage.

Run from the repository root:

    python3 tools/torch_port/eval_times.py [--val-scenes 64] [--workers 4]

It writes a synthetic KITTI tree of ``--val-scenes`` val scenes, its infos
and a ``.pth`` of seeded random weights as ``chip_smoke.py``'s eval_cli
phase does, then:

1. runs ``hvpr_tpu_torch.tools.test.main`` on the card (batch 8,
   ``--save_to_file``) and prints its ``eval_time/`` keys: scans/s and the
   share of the loop waiting on the DataLoader, over the whole loop and
   past its first batch (whose wait holds the workers' start-up),
   the forward's median and the evaluator's seconds;
2. the data layer in this process: the items of one batch (read, masks,
   ``sample_points``, host voxelization), their collation and a pickle
   round trip of the batch (what a worker's batch costs to reach the loop),
   medians of 5 on the host clock;
3. on the first batch, medians of 5 synchronized calls (host clock):
   the padded ``Network.eval_forward`` without and with the recall records
   of the batch's ``gt_boxes`` (the loop runs the latter) and the flat
   ``Network.pipeline`` on the same points; then each layout's stages
   (the copy to the card or the device voxelizer, the four model stages,
   post-processing), and the NMS candidates clearing ``SCORE_THRESH`` a
   scan (random weights put the NMS at its ``NMS_PRE_MAXSIZE`` cap).

It prints the card's name and power limit beside the numbers. ~1.5 min.
"""

import argparse
import os
import pickle
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
REPS = 5


def synced_ms(fn, reps=REPS):
    """Median host milliseconds of ``fn``, the device synchronized around it."""
    import torch
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def padded_stage_ms(net, host_batch, reps=REPS):
    """Median milliseconds of each part of the padded eval path on a host
    batch: the copy to the card, the four model stages, post-processing
    (with the recall records where the batch has ``gt_boxes``)."""
    import torch
    from hvpr_tpu_torch.models import load_data_to_gpu
    from hvpr_tpu_torch.models.detectors.detector3d_template import post_processing
    mod = net.module
    stages = [('to_device', None), ('vfe', mod.vfe), ('map_to_bev', mod.map_to_bev_module),
              ('backbone_2d', mod.backbone_2d), ('dense_head', mod.dense_head),
              ('post_processing', None)]
    times = {name: [] for name, _ in stages}
    with torch.no_grad():
        for _ in range(reps):
            batch = None
            for name, stage in stages:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if name == 'to_device':
                    batch = load_data_to_gpu(host_batch, net.device)
                elif name == 'post_processing':
                    post_processing(batch, net.post_cfg, net.num_class)
                else:
                    batch = stage(batch)
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) * 1e3)
    return {name: statistics.median(v) for name, v in times.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--val-scenes', type=int, default=64)
    ap.add_argument('--workers', type=int, default=4)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print('eval_times: torch sees no CUDA device', file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    import chip_smoke
    from hvpr_tpu_torch.datasets import build_dataloader, stop_worker_server
    from hvpr_tpu_torch.models import build_network, load_data_to_gpu
    from hvpr_tpu_torch.utils.checkpoint import load_params_from_file

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()[0]
    print(f'card: {smi}')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    cfg = chip_smoke.load_cfg()
    build_dir = Path(ROOT) / 'build'
    build_dir.mkdir(exist_ok=True)
    bs = chip_smoke.BATCH
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        root, ckpt = chip_smoke.write_eval_tree(Path(tmp), cfg, args.val_scenes)
        t0 = time.perf_counter()
        ret = chip_smoke.run_test_cli(Path(tmp), root, ckpt, 'times', args.workers)
        wall_s = time.perf_counter() - t0
        n_batches = -(-args.val_scenes // bs)
        print(f'eval loop, {args.val_scenes} scans in {n_batches} batches of {bs}, '
              f'{args.workers} workers: '
              f'{ret["eval_time/scans_per_s"]} scans/s, DataLoader wait share '
              f'{ret["eval_time/loader_wait_share"]}; past the first batch '
              f'{ret.get("eval_time/steady_scans_per_s")} scans/s, wait share '
              f'{ret.get("eval_time/steady_loader_wait_share")}; eval_forward median '
              f'{ret["eval_time/forward_median_ms"]} ms a batch, evaluator '
              f'{ret["eval_time/evaluator_s"]} s, main() {wall_s} s; on {smi}')

        np.random.seed(0)
        test_set, _, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, bs,
                                          root_path=root, workers=0)
        host = {'items': [], 'collate': [], 'pickle round trip': []}
        for _ in range(REPS):
            t0 = time.perf_counter()
            items = [test_set[i] for i in range(bs)]
            t1 = time.perf_counter()
            batch = test_set.collate_batch(items)
            t2 = time.perf_counter()
            blob = pickle.dumps(batch, protocol=pickle.HIGHEST_PROTOCOL)
            pickle.loads(blob)
            t3 = time.perf_counter()
            for k, v in zip(host, (t1 - t0, t2 - t1, t3 - t2)):
                host[k].append(v * 1e3)
        print(f'data layer in one process, ms a batch of {bs} (medians of {REPS}, host '
              f'clock): ' + ', '.join(f'{k} {statistics.median(v)}' for k, v in host.items())
              + f'; the batch pickles to {len(blob)} bytes; {os.cpu_count()} host cores')
        np.random.seed(0)
        batch = test_set.collate_batch([test_set[i] for i in range(bs)])
        net = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), test_set, device='cuda')
        load_params_from_file(net.module, ckpt)
        dev_batch = load_data_to_gpu(batch, net.device)
        no_gt = {k: v for k, v in dev_batch.items() if k != 'gt_boxes'}
        pts, mask = dev_batch['points'], dev_batch['point_valid_mask']
        with torch.no_grad():
            net.eval_forward(dev_batch)                   # warm-up
            net.pipeline(pts, mask)
            layouts = {
                'padded eval_forward': synced_ms(lambda: net.eval_forward(no_gt)),
                'flat pipeline': synced_ms(lambda: net.pipeline(pts, mask)),
                'padded eval_forward with the recall of gt_boxes (as the loop)':
                    synced_ms(lambda: net.eval_forward(dev_batch)),
            }
            print(f'warm ms a batch of {bs} (medians of {REPS}, synchronized): '
                  + ', '.join(f'{k} {v}' for k, v in layouts.items()) + f'; on {smi}')
            for name, parts in (('padded', padded_stage_ms(net, batch)),
                                ('flat', chip_smoke.stage_ms(net, pts, mask))):
                print(f'{name} stage ms (medians of {REPS}, synchronized): '
                      + ', '.join(f'{k} {v}' for k, v in parts.items()) + f'; on {smi}')
            post = cfg.MODEL.POST_PROCESSING
            cls = net.module(dev_batch)['batch_cls_preds']
            live = (torch.sigmoid(cls).amax(dim=-1) >= post.SCORE_THRESH).sum(dim=1)
        print(f'NMS candidates clearing SCORE_THRESH a scan: {live.tolist()} '
              f'(NMS_PRE_MAXSIZE {post.NMS_CONFIG.NMS_PRE_MAXSIZE}); '
              f'{int(dev_batch["voxel_mask"].sum())} pillars, {int(mask.sum())} points')
    stop_worker_server()
    return 0


if __name__ == '__main__':
    sys.exit(main())
