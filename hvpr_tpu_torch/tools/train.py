"""Training CLI of the port: a KITTI or nuScenes tree in, ``.pth``
checkpoints and the post-train evaluation of the last ones out.

The counterpart of the JAX package's ``tools/train.py``, run from the
repository root, in one process:

    python -m hvpr_tpu_torch.tools.train --cfg_file tools/cfgs/kitti_models/hvpr.yaml \\
        --batch_size 4 --epochs 80 [--fix_random_seed] \\
        --set DATA_CONFIG.DATA_PATH /path/to/kitti

or data-parallel, one process a card (the reference's ``dist_train.sh``):

    torchrun --nproc_per_node N -m hvpr_tpu_torch.tools.train --launcher pytorch \\
        --cfg_file tools/cfgs/kitti_models/hvpr.yaml --batch_size 4N ...

The KITTI tree needs its info pickles and gt database
(``python -m hvpr_tpu_torch.datasets.kitti.kitti_dataset create_kitti_infos
DATA_PATH``), a nuScenes tree its info pickles (``tools/test.py``). Batches are augmented and voxelized on the host into padded
pillars by the data layer's worker processes, and trained on ``--device``
(``cuda`` unless the caller passes ``cpu``). Output goes to
``output/<cfg group>/<cfg name>/<extra_tag>/{ckpt,eval}`` under
``cfg.ROOT_DIR`` (``HVPR_ROOT_DIR``, else the repository root), with the
log and ``train_log.jsonl`` beside them.

``--launcher pytorch`` joins the process group of a ``torchrun`` launch
(NCCL on the card, gloo with ``--device cpu``; a group the caller made
already is used as it is) and trains on card ``--local_rank``
(``LOCAL_RANK``). ``--batch_size`` is the global batch, split evenly over
the ranks (``BATCH_SIZE_PER_GPU`` a rank by default). A step of W ranks
equals the one-process step on their W batches to rounding
(``hvpr_tpu_torch.parallel``): BatchNorm statistics are the global
batch's whatever ``--sync_bn`` says. Every rank starts from rank 0's
weights, reads its share of the scenes and loads the same checkpoint to
resume; rank 0 alone logs at INFO, writes checkpoints and
``train_log.jsonl``, and keeps the evaluation's records (the evaluation
runs on every rank, each on its share, ``tools/test.py``).

Without ``--ckpt`` a run resumes from the newest ``ckpt/checkpoint_epoch_*.pth``
(by modification time): weights, BN statistics, optimizer state, epoch and
iteration. ``--pretrained_model X.pth`` loads the shape-matching weights
of X first. After training, the last ``--num_epochs_to_eval`` checkpoints
are evaluated into ``eval/eval_with_train`` with the port's test CLI.

``--fix_random_seed`` seeds Python, numpy and torch with 666 (666 + r on
rank r, so that the ranks draw other augmentations) and makes cuDNN
deterministic: two such runs give the same checkpoints bit for bit. The
train step needs no ``torch.use_deterministic_algorithms`` for that (the
point stream's gathers sum their gradients without atomics); this CLI
leaves the switch as it finds it.
"""

import argparse
import datetime
import glob
import os
from pathlib import Path

import torch

from .. import config as config_module
from ..config import ConfigDict, cfg_from_list, cfg_from_yaml_file, log_config_to_file
from ..datasets import build_dataloader, stop_worker_server
from ..models import build_network
from ..parallel import broadcast_state, in_process_group
from ..utils import common_utils
from ..utils.checkpoint import load_checkpoint, load_params_from_file
from . import test as test_cli
from .train_utils import train_model


def parse_config(argv=None):
    parser = argparse.ArgumentParser(description='hvpr_tpu_torch training')
    parser.add_argument('--cfg_file', type=str, default=None, help='config for training')
    parser.add_argument('--batch_size', type=int, default=None)
    parser.add_argument('--epochs', type=int, default=None)
    parser.add_argument('--workers', type=int, default=4)
    parser.add_argument('--extra_tag', type=str, default='default')
    parser.add_argument('--ckpt', type=str, default=None, help='checkpoint to start from')
    parser.add_argument('--pretrained_model', type=str, default=None)
    parser.add_argument('--launcher', choices=['none', 'pytorch'], default='none')
    parser.add_argument('--tcp_port', type=int, default=18888,
                        help='--launcher pytorch: port of rank 0 where torchrun set none')
    parser.add_argument('--local_rank', type=int,
                        default=int(os.environ.get('LOCAL_RANK', 0)),
                        help='--launcher pytorch: this process\'s card')
    parser.add_argument('--sync_bn', action='store_true', default=False,
                        help='implied: over several processes BatchNorm statistics '
                             'are the global batch\'s')
    parser.add_argument('--fix_random_seed', action='store_true', default=False,
                        help='seed everything (666 + rank) and make cuDNN deterministic')
    parser.add_argument('--ckpt_save_interval', type=int, default=1)
    parser.add_argument('--max_ckpt_save_num', type=int, default=30)
    parser.add_argument('--merge_all_iters_to_one_epoch', action='store_true', default=False)
    parser.add_argument('--num_epochs_to_eval', type=int, default=10,
                        help='after training, evaluate the last N checkpoints')
    parser.add_argument('--max_waiting_mins', type=int, default=0,
                        help='post-train evaluation: minutes to wait for new checkpoints')
    parser.add_argument('--save_to_file', action='store_true', default=False)
    parser.add_argument('--device', type=str, default='cuda',
                        help="device of the network: 'cuda' (default) or 'cpu'")
    parser.add_argument('--set', dest='set_cfgs', default=None, nargs=argparse.REMAINDER,
                        help='set extra config keys')
    args = parser.parse_args(argv)

    cfg = ConfigDict(ROOT_DIR=config_module.cfg.ROOT_DIR, LOCAL_RANK=args.local_rank)
    cfg_from_yaml_file(args.cfg_file, cfg)
    cfg.TAG = Path(args.cfg_file).stem
    cfg.EXP_GROUP_PATH = '/'.join(args.cfg_file.split('/')[1:-1])
    if args.set_cfgs is not None:
        cfg_from_list(args.set_cfgs, cfg)
    return args, cfg


def schedule_steps(n_batches, epochs, merge_all_iters_to_one_epoch):
    """(OneCycle total steps, iterations an epoch) for a loader of
    ``n_batches``: under ``merge_all_iters_to_one_epoch`` the loader
    already spans every epoch."""
    if merge_all_iters_to_one_epoch:
        return n_batches, n_batches // max(epochs, 1)
    return n_batches * epochs, n_batches


def latest_checkpoint(ckpt_dir):
    """The newest ``checkpoint_epoch_*.pth`` of ``ckpt_dir`` by modification
    time, or None."""
    ckpt_list = glob.glob(str(Path(ckpt_dir) / 'checkpoint_epoch_*.pth'))
    return max(ckpt_list, key=os.path.getmtime) if ckpt_list else None


def main(argv=None):
    """Train as ``argv`` (``sys.argv[1:]`` by default) says, then evaluate
    the last checkpoints. Returns a dict: the epoch and iteration the run
    started from, the lr of its first step, the iteration it ended at, the
    loop's timing (``train_time/``) and the result dict of the last
    checkpoint evaluated (``eval``; over several ranks rank 0's, None on
    the others)."""
    args, cfg = parse_config(argv)
    rank, world = test_cli.join_launcher(args, cfg)
    args.epochs = cfg.OPTIMIZATION.NUM_EPOCHS if args.epochs is None else args.epochs

    cudnn_before = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    if args.fix_random_seed:
        common_utils.set_random_seed(666 + rank)
    elif world > 1:
        # torch's RNG starts from one seed in every process: without this
        # the ranks' loaders would seed their workers alike
        torch.manual_seed(torch.initial_seed() + rank)
    try:
        return _train_and_evaluate(args, cfg, rank, world)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn_before


def _train_and_evaluate(args, cfg, rank, world):
    output_dir = Path(cfg.ROOT_DIR) / 'output' / cfg.EXP_GROUP_PATH / cfg.TAG / args.extra_tag
    ckpt_dir = output_dir / 'ckpt'
    ckpt_dir.mkdir(parents=True, exist_ok=True)

    log_file = output_dir / f'log_train_{datetime.datetime.now():%Y%m%d-%H%M%S}.txt'
    logger = common_utils.create_logger(log_file if rank == 0 else None, rank=rank)
    logger.info('**********************Start logging**********************')
    logger.info('device: %s; %d process(es), %d scans a step a process', args.device,
                world, args.batch_size // world)
    for key, val in vars(args).items():
        logger.info('%s: %s', key, val)
    log_config_to_file(cfg, logger=logger)
    logger.info('seeds: %s', 'fixed (--fix_random_seed: 666 + rank, cuDNN deterministic)'
                if args.fix_random_seed else 'not fixed (no --fix_random_seed)')
    if args.sync_bn or world > 1:
        logger.info('BatchNorm statistics: the global batch\'s (%d process(es); '
                    '--sync_bn is implied)', world)

    train_set, train_loader, train_sampler = build_dataloader(
        dataset_cfg=cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES,
        batch_size=args.batch_size // world, dist=world > 1,
        root_path=Path(cfg.DATA_CONFIG.DATA_PATH),
        workers=args.workers, logger=logger, training=True,
        merge_all_iters_to_one_epoch=args.merge_all_iters_to_one_epoch,
        total_epochs=args.epochs)
    net = build_network(cfg.MODEL, num_class=len(cfg.CLASS_NAMES), dataset=train_set,
                        device=args.device, train=True)
    total_steps, iters_each_epoch = schedule_steps(
        len(train_loader), args.epochs, args.merge_all_iters_to_one_epoch)
    net.init_training(cfg.OPTIMIZATION, total_steps)
    optimizer = net.train_state.optimizer
    logger.info('OneCycle over %d steps, %d an epoch', total_steps, iters_each_epoch)

    if args.pretrained_model is not None:
        load_params_from_file(net.module, args.pretrained_model, logger=logger)

    start_epoch = it = 0
    ckpt_to_resume = args.ckpt if args.ckpt is not None else latest_checkpoint(ckpt_dir)
    if ckpt_to_resume is not None:
        start_epoch, it = load_checkpoint(net.module, ckpt_to_resume, optimizer=optimizer)
        start_epoch, it = int(start_epoch), int(it)
        net.train_state.step = it
        logger.info('Resumed from %s (epoch %d, it %d)', ckpt_to_resume, start_epoch, it)
    if in_process_group():
        broadcast_state(net.module)
    first_lr = float(optimizer.lr_fn(optimizer.count))
    logger.info('OneCycle lr of the first step (it %d): %r', optimizer.count, first_lr)

    logger.info('**********************Start training %s/%s(%s)**********************',
                cfg.EXP_GROUP_PATH, cfg.TAG, args.extra_tag)
    end_it, timing = train_model(
        net, train_loader, start_epoch=start_epoch, total_epochs=args.epochs,
        start_iter=it, ckpt_save_dir=ckpt_dir, log_file=output_dir / 'train_log.jsonl',
        logger=logger, train_sampler=train_sampler,
        ckpt_save_interval=args.ckpt_save_interval,
        max_ckpt_save_num=args.max_ckpt_save_num,
        merge_all_iters_to_one_epoch=args.merge_all_iters_to_one_epoch)
    logger.info('**********************End training**********************')
    del net, optimizer, train_loader

    # after training, evaluate the last checkpoints as the test CLI's
    # --eval_all does, on a network without the point stream
    logger.info('**********************Start evaluation %s/%s(%s)**********************',
                cfg.EXP_GROUP_PATH, cfg.TAG, args.extra_tag)
    test_set, test_loader, _ = build_dataloader(
        dataset_cfg=cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES,
        batch_size=args.batch_size // world, dist=world > 1,
        root_path=Path(cfg.DATA_CONFIG.DATA_PATH),
        workers=args.workers, logger=logger, training=False, item_seed=0)
    eval_net = build_network(cfg.MODEL, num_class=len(cfg.CLASS_NAMES), dataset=test_set,
                             device=args.device)
    eval_output_dir = output_dir / 'eval' / 'eval_with_train'
    eval_output_dir.mkdir(parents=True, exist_ok=True)
    args.start_epoch = max(args.epochs - args.num_epochs_to_eval, 0)
    last_eval = test_cli.repeat_eval_ckpt(cfg, eval_net, test_loader, args, eval_output_dir,
                                          logger, ckpt_dir, dist_test=world > 1)
    logger.info('**********************End evaluation**********************')
    return {'start_epoch': start_epoch, 'start_it': it, 'first_lr': first_lr,
            'end_it': end_it, **timing, 'eval': last_eval}


if __name__ == '__main__':
    main()
    stop_worker_server()
