"""BEV pictures of predictions against the ground truth over a dataset.

The counterpart of the JAX package's ``tools/vis.py``, run from the
repository root:

    python -m hvpr_tpu_torch.tools.vis --cfg_file tools/cfgs/kitti_models/hvpr.yaml \\
        --ckpt checkpoint_epoch_80.pth [--out_dir vis_output] [--max_samples 20] \\
        [--device cpu] [--set DATA_CONFIG.DATA_PATH /path/to/kitti]

The test split of the config's dataset (its info pickles, as for
``hvpr_tpu_torch.tools.test``) runs a scene at a time through
``Network.eval_forward`` on ``--device`` (``cuda`` unless the caller passes
``cpu``) with the ``.pth`` weights of ``--ckpt``. For each of the first
``--max_samples`` scenes it writes ``<frame_id>.png`` (the BEV points,
predicted boxes in green, gt boxes in red; skipped with a message without
matplotlib) and ``<frame_id>.ply`` (the points and the predicted boxes'
wireframes, numpy only).
"""

import argparse
from pathlib import Path

import numpy as np

from ..config import ConfigDict, cfg_from_list, cfg_from_yaml_file
from ..datasets import build_dataloader, stop_worker_server
from ..models import build_network
from ..utils import common_utils
from ..utils.checkpoint import load_params_from_file
from . import visual_utils
from .eval_utils import _forward


def main(argv=None):
    """Run ``argv`` (``sys.argv[1:]`` by default); returns the paths written."""
    parser = argparse.ArgumentParser(description='hvpr_tpu_torch BEV pictures')
    parser.add_argument('--cfg_file', type=str, required=True)
    parser.add_argument('--ckpt', type=str, default=None, help='.pth checkpoint')
    parser.add_argument('--out_dir', type=str, default='vis_output')
    parser.add_argument('--max_samples', type=int, default=20)
    parser.add_argument('--workers', type=int, default=2)
    parser.add_argument('--device', type=str, default='cuda',
                        help="device of the network: 'cuda' (default) or 'cpu'")
    parser.add_argument('--set', dest='set_cfgs', default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    cfg = ConfigDict()
    cfg_from_yaml_file(args.cfg_file, cfg)
    if args.set_cfgs is not None:
        cfg_from_list(args.set_cfgs, cfg)

    logger = common_utils.create_logger()
    test_set, test_loader, _ = build_dataloader(
        dataset_cfg=cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES, batch_size=1,
        root_path=Path(cfg.DATA_CONFIG.DATA_PATH), workers=args.workers, logger=logger,
        training=False, item_seed=0)
    net = build_network(cfg.MODEL, num_class=len(cfg.CLASS_NAMES), dataset=test_set,
                        device=args.device)
    if args.ckpt:
        load_params_from_file(net.module, args.ckpt, logger=logger)

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if not visual_utils.matplotlib_available():
        logger.info('matplotlib is not installed: the PNGs are skipped, the .ply files '
                    'are written')
    written = []
    for i, batch in enumerate(test_loader):
        if i >= args.max_samples:
            break
        host, _ = _forward(net, batch, keep_gt=False)
        boxes = host['pred_boxes'][0][host['pred_mask'][0]]
        gt = batch.get('gt_boxes')
        if gt is not None:
            gt = gt[0][np.abs(gt[0]).sum(axis=-1) > 0]
        pts = batch['points'][0][batch['point_valid_mask'][0]]
        name = out_dir / str(batch['frame_id'][0])
        if visual_utils.matplotlib_available():
            written.append(visual_utils.draw_bev_scene(
                pts, pred_boxes=boxes, gt_boxes=gt, save_path=name.with_suffix('.png'),
                point_cloud_range=cfg.DATA_CONFIG.POINT_CLOUD_RANGE))
        written.append(Path(visual_utils.export_scene_ply(
            pts, boxes, save_path=str(name.with_suffix('.ply')))))
        logger.info('saved %s (%d dets)', name, len(boxes))
    return written


if __name__ == '__main__':
    main()
    stop_worker_server()
