"""Evaluation CLI of the port: a KITTI or nuScenes tree and a ``.pth``
checkpoint in, detections, ``result.pkl`` and the config's EVAL_METRIC out
(KITTI's official AP; nuScenes' devkit evaluation, or without the devkit
the centre-distance AP).

The counterpart of the JAX package's ``tools/test.py``, for one process,
run from the repository root:

    python -m hvpr_tpu_torch.tools.test --cfg_file tools/cfgs/kitti_models/hvpr.yaml \\
        --ckpt checkpoint_epoch_80.pth --batch_size 8 \\
        --set DATA_CONFIG.DATA_PATH /path/to/kitti

The KITTI tree needs its info pickles
(``python -m hvpr_tpu_torch.datasets.kitti.kitti_dataset create_kitti_infos
DATA_PATH``); a nuScenes tree (``tools/cfgs/nuscenes_models/``) its
``nuscenes_infos_*sweeps_*.pkl``, which the devkit's info builder writes
(``create_nuscenes_infos``, not ported past its devkit check) or
``hvpr_tpu_torch.utils.scans.build_nuscenes_root`` with a synthetic tree.
``--save_to_file`` writes KITTI label files or one ``<token>.json`` of
nuScenes submission rows a frame. Results go to ``output/<cfg group>/<cfg name>/<extra_tag>/eval/``
under ``cfg.ROOT_DIR`` (``HVPR_ROOT_DIR``, else the repository root), as in
the JAX package. The network runs on ``--device`` (``cuda`` unless the
caller passes ``cpu``), voxelized on the host into padded pillars by the
data layer. ``--eval_all`` evaluates every ``checkpoint_epoch_*.pth`` of
``--ckpt_dir`` not evaluated yet, waiting up to ``--max_waiting_mins`` for
new ones, and appends each epoch's result dict to ``eval_all.jsonl`` beside
the logs. Scene i's host draws (``sample_points``' choice of points) are
seeded with i, so an evaluation gives the same detections whatever the
number of workers or processes.

``--launcher pytorch`` evaluates over the process group of a ``torchrun``
launch, one process a card (``--local_rank``, ``LOCAL_RANK``), or over a
group the caller made already: ``--batch_size`` is the global batch, split
evenly; each rank reads every world-size-th scene and rank 0 gathers the
detections in dataset order (``eval_utils.eval_one_epoch(dist_test=True)``),
writes the results and runs the evaluator; with ``--eval_all`` rank 0
picks each checkpoint and keeps the record of the evaluated ones.
"""

import argparse
import datetime
import glob
import json
import os
import re
import time
from pathlib import Path

import torch
import torch.distributed as dist

from .. import config as config_module
from ..config import ConfigDict, cfg_from_list, cfg_from_yaml_file, log_config_to_file
from ..datasets import build_dataloader, stop_worker_server
from ..models import build_network
from ..utils import common_utils
from ..utils.checkpoint import load_params_from_file
from ..utils.common_utils import get_dist_info
from . import eval_utils


def parse_config(argv=None):
    parser = argparse.ArgumentParser(description='hvpr_tpu_torch evaluation')
    parser.add_argument('--cfg_file', type=str, default=None)
    parser.add_argument('--batch_size', type=int, default=None)
    parser.add_argument('--workers', type=int, default=4)
    parser.add_argument('--extra_tag', type=str, default='default')
    parser.add_argument('--ckpt', type=str, default=None)
    parser.add_argument('--eval_tag', type=str, default='default')
    parser.add_argument('--eval_all', action='store_true', default=False,
                        help='evaluate all checkpoints in ckpt_dir')
    parser.add_argument('--ckpt_dir', type=str, default=None)
    parser.add_argument('--save_to_file', action='store_true', default=False)
    parser.add_argument('--max_waiting_mins', type=int, default=30)
    parser.add_argument('--start_epoch', type=int, default=0)
    parser.add_argument('--launcher', choices=['none', 'pytorch'], default='none')
    parser.add_argument('--tcp_port', type=int, default=18888,
                        help='--launcher pytorch: port of rank 0 where torchrun set none')
    parser.add_argument('--local_rank', type=int,
                        default=int(os.environ.get('LOCAL_RANK', 0)),
                        help='--launcher pytorch: this process\'s card')
    parser.add_argument('--device', type=str, default='cuda',
                        help="device of the network: 'cuda' (default) or 'cpu'")
    parser.add_argument('--set', dest='set_cfgs', default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    cfg = ConfigDict(ROOT_DIR=config_module.cfg.ROOT_DIR, LOCAL_RANK=args.local_rank)
    cfg_from_yaml_file(args.cfg_file, cfg)
    cfg.TAG = Path(args.cfg_file).stem
    cfg.EXP_GROUP_PATH = '/'.join(args.cfg_file.split('/')[1:-1])
    if args.set_cfgs is not None:
        cfg_from_list(args.set_cfgs, cfg)
    return args, cfg


def join_launcher(args, cfg):
    """``--launcher pytorch``: join the process group (NCCL for a card,
    gloo for the CPU) and run on card ``--local_rank``. Then the global
    ``--batch_size`` (``BATCH_SIZE_PER_GPU`` a rank by default), which the
    ranks split evenly. Returns (rank, world size)."""
    rank, world = 0, 1
    if args.launcher == 'pytorch':
        backend = 'nccl' if torch.device(args.device).type == 'cuda' else 'gloo'
        rank, world = common_utils.init_dist_pytorch(args.tcp_port, args.local_rank,
                                                     backend)
        if args.device == 'cuda':
            args.device = f'cuda:{args.local_rank}'
    if args.batch_size is None:
        args.batch_size = cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU * world
    if args.batch_size % world:
        raise ValueError(f'global batch size {args.batch_size} is not divisible by '
                         f'{world} processes')
    return rank, world


def load_params_into_network(net, ckpt_path, logger):
    """Load a ``.pth`` into ``net``; returns its epoch id ('no_number' if
    it has none)."""
    epoch, _ = load_params_from_file(net.module, ckpt_path, logger=logger)
    return 'no_number' if epoch is None else epoch


def get_no_evaluated_ckpt(ckpt_dir, ckpt_record_file, args):
    ckpt_list = glob.glob(os.path.join(ckpt_dir, 'checkpoint_epoch_*.pth'))
    ckpt_list.sort(key=os.path.getmtime)
    with open(ckpt_record_file, 'r') as f:
        evaluated_ckpt_list = [float(x.strip()) for x in f if x.strip()]

    for cur_ckpt in ckpt_list:
        num_list = re.findall(r'checkpoint_epoch_(.*)\.pth', cur_ckpt)
        if not num_list:
            continue
        epoch_id = num_list[-1]
        if float(epoch_id) not in evaluated_ckpt_list and int(float(epoch_id)) >= args.start_epoch:
            return epoch_id, cur_ckpt
    return -1, None


def repeat_eval_ckpt(cfg, net, test_loader, args, eval_output_dir, logger, ckpt_dir,
                     dist_test=False):
    """Evaluate each checkpoint of ``ckpt_dir`` from epoch
    ``args.start_epoch`` on that is not evaluated yet, waiting up to
    ``args.max_waiting_mins`` for new ones; returns the result dict of the
    last one evaluated (None if none was). Under ``dist_test`` rank 0 picks
    each checkpoint for every rank and alone writes the records."""
    rank = get_dist_info()[0] if dist_test else 0
    ckpt_record_file = eval_output_dir / ('eval_list_%s.txt' % cfg.DATA_CONFIG.DATA_SPLIT['test'])
    results_file = eval_output_dir / 'eval_all.jsonl'
    if rank == 0:
        with open(ckpt_record_file, 'a'):
            pass

    total_time = 0
    first_eval = True
    ret_dict = None
    while True:
        found = [get_no_evaluated_ckpt(ckpt_dir, ckpt_record_file, args) if rank == 0
                 else None]
        if dist_test:
            dist.broadcast_object_list(found, src=0)
        cur_epoch_id, cur_ckpt = found[0]
        if cur_epoch_id == -1 or int(float(cur_epoch_id)) < args.start_epoch:
            if args.max_waiting_mins <= 0:
                break
            wait_second = 30
            logger.info('Wait %s seconds for next check (progress: %.1f / %d minutes): %s',
                        wait_second, total_time / 60, args.max_waiting_mins, ckpt_dir)
            time.sleep(wait_second)
            total_time += wait_second
            if total_time > args.max_waiting_mins * 60 and not first_eval:
                break
            continue
        total_time = 0
        first_eval = False

        load_params_into_network(net, cur_ckpt, logger)
        cur_result_dir = eval_output_dir / f'epoch_{cur_epoch_id}' / \
            cfg.DATA_CONFIG.DATA_SPLIT['test']
        ret_dict = eval_utils.eval_one_epoch(
            cfg, net, test_loader, cur_epoch_id, logger, dist_test=dist_test,
            result_dir=cur_result_dir, save_to_file=args.save_to_file)
        if rank == 0:
            with open(results_file, 'a') as f:
                f.write(json.dumps({'epoch': cur_epoch_id, **ret_dict}) + '\n')
            with open(ckpt_record_file, 'a') as f:
                print(f'{cur_epoch_id}', file=f)
        logger.info('Epoch %s has been evaluated', cur_epoch_id)
    return ret_dict


def main(argv=None):
    """Run the evaluation of ``argv`` (``sys.argv[1:]`` by default); returns
    the result dict of a single checkpoint ({} on ranks other than 0), None
    with ``--eval_all``."""
    args, cfg = parse_config(argv)
    rank, world = join_launcher(args, cfg)

    output_dir = Path(cfg.ROOT_DIR) / 'output' / cfg.EXP_GROUP_PATH / cfg.TAG / args.extra_tag
    output_dir.mkdir(parents=True, exist_ok=True)
    eval_output_dir = output_dir / 'eval'

    if not args.eval_all:
        num_list = re.findall(r'\d+', args.ckpt) if args.ckpt is not None else []
        epoch_id = num_list[-1] if num_list else 'no_number'
        eval_output_dir = eval_output_dir / f'epoch_{epoch_id}' / \
            cfg.DATA_CONFIG.DATA_SPLIT['test']
    else:
        eval_output_dir = eval_output_dir / 'eval_all_default'
    if args.eval_tag is not None:
        eval_output_dir = eval_output_dir / args.eval_tag
    eval_output_dir.mkdir(parents=True, exist_ok=True)

    log_file = eval_output_dir / f'log_eval_{datetime.datetime.now():%Y%m%d-%H%M%S}.txt'
    logger = common_utils.create_logger(log_file if rank == 0 else None, rank=rank)
    logger.info('**********************Start logging**********************')
    for key, val in vars(args).items():
        logger.info('%s: %s', key, val)
    log_config_to_file(cfg, logger=logger)

    common_utils.set_random_seed(0)
    test_set, test_loader, _ = build_dataloader(
        dataset_cfg=cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES,
        batch_size=args.batch_size // world, dist=world > 1,
        root_path=Path(cfg.DATA_CONFIG.DATA_PATH),
        workers=args.workers, logger=logger, training=False, item_seed=0)
    net = build_network(cfg.MODEL, num_class=len(cfg.CLASS_NAMES), dataset=test_set,
                        device=args.device)

    if args.eval_all:
        ckpt_dir = args.ckpt_dir if args.ckpt_dir is not None else output_dir / 'ckpt'
        repeat_eval_ckpt(cfg, net, test_loader, args, eval_output_dir, logger, ckpt_dir,
                         dist_test=world > 1)
        return None
    epoch_id = 'no_number'
    if args.ckpt is not None:
        epoch_id = load_params_into_network(net, args.ckpt, logger)
    return eval_utils.eval_one_epoch(
        cfg, net, test_loader, epoch_id, logger, dist_test=world > 1,
        result_dir=eval_output_dir, save_to_file=args.save_to_file)


if __name__ == '__main__':
    main()
    stop_worker_server()
