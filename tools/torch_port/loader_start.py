#!/usr/bin/env python3
"""Start-up of the train DataLoader's workers: ``spawn`` against the port's
preloaded ``forkserver``, in turns, on the host.

Run from the repository root (a file, not stdin: the workers re-import the
main module):

    python3 tools/torch_port/loader_start.py [--epochs 2] [--workers 4]

It writes a synthetic KITTI tree of 16 train scenes (the train_cli phase's
of ``chip_smoke.py``) with its infos and gt database, builds the train
loader of ``tools/cfgs/kitti_models/hvpr.yaml`` at batch 4, and for each
start method in the order spawn, forkserver, forkserver, spawn iterates
``--epochs`` epochs, printing for each the seconds of ``iter(loader)``, of
its first batch and of the rest of the epoch. The device plays no part;
the numbers are the host's, printed beside the card of the machine when
``nvidia-smi`` finds one.
"""

import argparse
import multiprocessing
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent


def card():
    try:
        return subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                               '--format=csv,noheader'], capture_output=True, text=True,
                              timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return 'no card'


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--epochs', type=int, default=2)
    parser.add_argument('--workers', type=int, default=4)
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    os.chdir(ROOT)

    import torch.utils.data as torch_data
    from hvpr_tpu_torch.config import ConfigDict, cfg_from_yaml_file
    from hvpr_tpu_torch.datasets import _worker_context, build_dataloader, stop_worker_server
    from hvpr_tpu_torch.datasets.kitti.kitti_dataset import create_kitti_infos
    from hvpr_tpu_torch.utils.scans import build_kitti_root

    (ROOT / 'build').mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / 'build') as tmp:
        root, _ = build_kitti_root(Path(tmp) / 'kitti', n_scenes=24, n_train=16)
        create_kitti_infos(root, root)
        cfg = cfg_from_yaml_file('tools/cfgs/kitti_models/hvpr.yaml', ConfigDict())
        dataset, _, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 4, root_path=root,
                                         workers=0, training=True)
        contexts = {'spawn': multiprocessing.get_context('spawn'),
                    'forkserver': _worker_context()}
        seconds = {name: [] for name in contexts}
        for name in ('spawn', 'forkserver', 'forkserver', 'spawn'):
            loader = torch_data.DataLoader(
                dataset, batch_size=4, num_workers=args.workers, shuffle=True,
                collate_fn=dataset.collate_batch, drop_last=True,
                multiprocessing_context=contexts[name])
            for epoch in range(args.epochs):
                t0 = time.perf_counter()
                batches = iter(loader)
                t1 = time.perf_counter()
                next(batches)
                t2 = time.perf_counter()
                for _ in batches:
                    pass
                t3 = time.perf_counter()
                seconds[name].append(t1 - t0)
                print(f'{name} epoch {epoch}: iter {t1 - t0:.3f} s, first batch '
                      f'{t2 - t1:.3f} s, the other {len(loader) - 1} batches {t3 - t2:.3f} s')
    smi = card()
    print(f'median iter(loader), {args.workers} workers: ' + ', '.join(
        f'{name} {statistics.median(v):.3f} s' for name, v in seconds.items())
        + f'; host of {smi}')
    stop_worker_server()


if __name__ == '__main__':
    main()
