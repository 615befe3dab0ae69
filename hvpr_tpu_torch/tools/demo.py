"""Single-scan inference demo of the port: raw point-cloud files in,
detections out.

The counterpart of the JAX package's ``tools/demo.py``, run from the
repository root:

    python -m hvpr_tpu_torch.tools.demo --cfg_file tools/cfgs/kitti_models/hvpr.yaml \\
        --ckpt checkpoint_epoch_80.pth --data_path scans/ [--ext .bin] \\
        [--save_bev DIR] [--save_3d DIR] [--device cpu]

``DemoDataset`` reads every ``*.bin`` (float32 x, y, z, intensity) or
``*.npy`` file of ``--data_path`` in sorted order, or the one file it names,
through the config's data processors (scene i's host draws, the point
sampling, seeded with i); each scene runs alone through
``Network.eval_forward`` on ``--device`` (``cuda`` unless the caller
passes ``cpu``) with the ``.pth`` weights of ``--ckpt``. The detections are
logged (the first ten a scene) and ``main`` returns them; ``--save_bev``
writes a BEV PNG a scene, ``--save_3d`` a 3D render PNG and an ASCII
``.ply`` (points and box wireframes) a scene. A PNG needs matplotlib:
without it the PNG is skipped with a message, and the ``.ply`` is written
all the same.
"""

import argparse
import glob
from pathlib import Path

import numpy as np

from ..config import ConfigDict, cfg_from_list, cfg_from_yaml_file
from ..datasets.dataset import DatasetTemplate
from ..models import build_network
from ..utils import common_utils
from ..utils.checkpoint import load_params_from_file
from . import visual_utils
from .eval_utils import _forward


class DemoDataset(DatasetTemplate):
    """Raw scans of a directory (or one file) through the test-mode data
    processors."""

    item_seed = 0

    def __init__(self, dataset_cfg, class_names, training=False, root_path=None,
                 logger=None, ext='.bin'):
        super().__init__(dataset_cfg=dataset_cfg, class_names=class_names,
                         training=training, root_path=root_path, logger=logger)
        self.ext = ext
        files = (glob.glob(str(self.root_path / f'*{ext}')) if self.root_path.is_dir()
                 else [str(self.root_path)])
        self.sample_file_list = sorted(files)

    def __len__(self):
        return len(self.sample_file_list)

    def __getitem__(self, index):
        if self.ext == '.bin':
            points = np.fromfile(self.sample_file_list[index], dtype=np.float32).reshape(-1, 4)
        elif self.ext == '.npy':
            points = np.load(self.sample_file_list[index])
        else:
            raise NotImplementedError(self.ext)
        if self.item_seed is not None:
            np.random.seed(self.item_seed + index)
        return self.prepare_data(data_dict={'points': points, 'frame_id': index})


def parse_config(argv=None):
    parser = argparse.ArgumentParser(description='hvpr_tpu_torch demo')
    parser.add_argument('--cfg_file', type=str, default='tools/cfgs/kitti_models/hvpr.yaml')
    parser.add_argument('--data_path', type=str, default='demo_data',
                        help='point cloud file or directory')
    parser.add_argument('--ckpt', type=str, default=None, help='.pth checkpoint')
    parser.add_argument('--ext', type=str, default='.bin')
    parser.add_argument('--save_bev', type=str, default=None,
                        help='directory for a BEV PNG a scene')
    parser.add_argument('--save_3d', type=str, default=None,
                        help='directory for a 3D render PNG and a .ply a scene')
    parser.add_argument('--device', type=str, default='cuda',
                        help="device of the network: 'cuda' (default) or 'cpu'")
    parser.add_argument('--set', dest='set_cfgs', default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    cfg = ConfigDict()
    cfg_from_yaml_file(args.cfg_file, cfg)
    if args.set_cfgs is not None:
        cfg_from_list(args.set_cfgs, cfg)
    return args, cfg


def _png(logger, what, draw, *a, **kw):
    if not visual_utils.matplotlib_available():
        logger.info('matplotlib is not installed: %s skipped', what)
        return
    draw(*a, **kw)


def main(argv=None):
    """Run the demo of ``argv`` (``sys.argv[1:]`` by default); returns a list
    of {'boxes', 'scores', 'labels'} numpy arrays, one a scene."""
    args, cfg = parse_config(argv)
    logger = common_utils.create_logger()
    logger.info('-----------------Demo of hvpr_tpu_torch-------------------------')
    dataset = DemoDataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES, training=False,
                          root_path=Path(args.data_path), ext=args.ext, logger=logger)
    logger.info('Total number of samples: \t%d', len(dataset))
    net = build_network(cfg.MODEL, num_class=len(cfg.CLASS_NAMES), dataset=dataset,
                        device=args.device)
    if args.ckpt is not None:
        load_params_from_file(net.module, args.ckpt, logger=logger)
        logger.info('Loaded checkpoint %s', args.ckpt)

    outs = {d: Path(d) for d in (args.save_bev, args.save_3d) if d}
    for d in outs.values():
        d.mkdir(parents=True, exist_ok=True)
    results = []
    for idx in range(len(dataset)):
        data_dict = dataset.collate_batch([dataset[idx]])
        host, _ = _forward(net, data_dict, keep_gt=False)
        mask = host['pred_mask'][0]
        det = {'boxes': host['pred_boxes'][0][mask], 'scores': host['pred_scores'][0][mask],
               'labels': host['pred_labels'][0][mask]}
        results.append(det)
        logger.info('sample %d: %d detections', idx, len(det['boxes']))
        for b, s, lbl in zip(det['boxes'][:10], det['scores'][:10], det['labels'][:10]):
            logger.info('  cls=%d score=%.3f box=[% .2f % .2f % .2f %.2f %.2f %.2f % .2f]',
                        int(lbl), float(s), *b[:7])
        pts = data_dict['points'][0][data_dict['point_valid_mask'][0]]
        if args.save_bev:
            _png(logger, 'BEV PNG', visual_utils.draw_bev_scene, pts, det['boxes'],
                 save_path=outs[args.save_bev] / f'demo_{idx:04d}.png',
                 point_cloud_range=cfg.DATA_CONFIG.POINT_CLOUD_RANGE)
        if args.save_3d:
            _png(logger, '3D render PNG', visual_utils.draw_scenes, pts,
                 ref_boxes=det['boxes'], save_path=outs[args.save_3d] / f'demo_{idx:04d}_3d.png')
            visual_utils.export_scene_ply(pts, det['boxes'],
                                          save_path=str(outs[args.save_3d] / f'demo_{idx:04d}.ply'))
    logger.info('Demo done.')
    return results


if __name__ == '__main__':
    main()
