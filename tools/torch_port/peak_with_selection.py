#!/usr/bin/env python3
"""Peak device memory of the fused hvpr.yaml batch-4 train step with the
memory call handed the point call's selection (as shipped) and without it,
on one NVIDIA GPU.

Run from the repository root:

    python3 tools/torch_port/peak_with_selection.py

It builds the train network as ``chip_smoke.py`` does (seeded weights,
``realistic_scans_with_boxes(seed 0)``), takes one warm-up step, then two
steps each way, twice, alternating, and prints
``torch.cuda.max_memory_allocated`` over each pair of steps.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    import numpy as np
    import torch
    import chip_smoke
    from hvpr_tpu_torch.models import DatasetMeta, build_network
    from hvpr_tpu_torch.models.backbones_2d.map_to_bev import memory_module
    from hvpr_tpu_torch.utils.scans import realistic_scans_with_boxes

    if not torch.cuda.is_available():
        print('peak_with_selection: torch sees no CUDA device', file=sys.stderr)
        return 2
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
    shipped = memory_module.masked_attend

    def without_selection(*args, selection=None, **kwargs):
        return shipped(*args, **kwargs)

    net.train_step(batch)
    try:
        for variant in ('selection', 'none', 'selection', 'none'):
            memory_module.masked_attend = shipped if variant == 'selection' \
                else without_selection
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for _ in range(2):
                net.train_step(batch)
            torch.cuda.synchronize()
            print(f'peak, {variant}: {torch.cuda.max_memory_allocated() / 2**30:.4f} GiB')
    finally:
        memory_module.masked_attend = shipped
    return 0


if __name__ == '__main__':
    sys.exit(main())
