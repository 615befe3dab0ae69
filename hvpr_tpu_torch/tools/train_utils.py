"""Training loop and rolling checkpoints.

The port's ``tools/train_utils/train_utils.py``: each host batch of the
data layer goes to the network's device (``load_data_to_gpu``) and through
``Network.train_step`` (forward with the losses, backward, the clip and the
``adam_onecycle`` update). Progress goes to the logger (no progress bar and
no tensorboard): at the first iteration and every 10th the loss terms,
``loss``, ``lr`` (that of the step just taken) and ``grad_norm`` are read
(each read synchronizes the device, so no other iteration reads) and
appended as one JSON line to ``train_log.jsonl``. After each epoch the
first rows of the memory are logged, and every ``ckpt_save_interval``
epochs ``checkpoint_epoch_N.pth`` is written (weights, BN statistics,
optimizer state, epoch, iteration), keeping at most ``max_ckpt_save_num``
(the oldest by modification time are removed).

``train_model`` returns the loop's timing: scans per second, the share of
the loop spent waiting on the DataLoader, both again past the run's first
batch (``steady_*``), and the median of ``Network.train_step`` (CUDA events
on the card, the host clock on the CPU).

Over several processes every rank runs the loop on its share of the
scenes (the sampler's ``set_epoch`` each epoch) and logs the metrics that
``train_step`` averaged over the ranks; rank 0 alone writes
``train_log.jsonl`` and the checkpoints. The timing is each rank's own.
"""

import glob
import json
import os
import statistics
import time

import numpy as np
import torch

from ..models import load_data_to_gpu
from ..utils.checkpoint import save_checkpoint
from ..utils.common_utils import get_dist_info

LOG_EVERY = 10


class _StepTimer:
    """Times ``Network.train_step`` calls: CUDA events on the card (read
    once, at the end), the host clock otherwise."""

    def __init__(self, device):
        self.cuda = device.type == 'cuda'
        self.events, self.host_ms = [], []

    def __call__(self, fn):
        if self.cuda:
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            out = fn()
            end.record()
            self.events.append((start, end))
            return out
        t0 = time.perf_counter()
        out = fn()
        self.host_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def times_ms(self):
        if self.cuda:
            torch.cuda.synchronize()
            return [s.elapsed_time(e) for s, e in self.events]
        return self.host_ms


def train_one_epoch(net, train_loader, accumulated_iter, epoch, log_file, logger,
                    timer, clock, total_it_each_epoch=None, dataloader_iter=None):
    """One epoch of ``total_it_each_epoch`` steps (``len(train_loader)`` by
    default, from a fresh iterator; otherwise from ``dataloader_iter``,
    restarted when it runs out). ``clock`` collects the host seconds spent
    waiting on the loader (the workers' start included) and the loop's
    start. Returns the iteration count and the last metrics read."""
    t0 = time.perf_counter()
    if total_it_each_epoch is None:
        total_it_each_epoch = len(train_loader)
    if total_it_each_epoch == len(train_loader):
        dataloader_iter = iter(train_loader)        # starts the workers
    clock['wait_s'] += time.perf_counter() - t0

    optimizer = net.train_state.optimizer
    rank = get_dist_info()[0]
    last_metrics = {}
    for i in range(total_it_each_epoch):
        t0 = time.perf_counter()
        try:
            batch = next(dataloader_iter)
        except StopIteration:
            dataloader_iter = iter(train_loader)
            batch = next(dataloader_iter)
        clock['wait_s'] += time.perf_counter() - t0

        device_batch = load_data_to_gpu(
            {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}, net.device)
        metrics = timer(lambda: net.train_step(device_batch))
        accumulated_iter += 1
        clock['scans'] += int(batch['batch_size'])
        if clock['first_s'] is None:
            if net.device.type == 'cuda':
                torch.cuda.synchronize(net.device)
            clock['first_s'] = time.perf_counter() - clock['start']
            clock['first_wait_s'] = clock['wait_s']
            clock['first_scans'] = clock['scans']

        if accumulated_iter % LOG_EVERY == 0 or accumulated_iter == 1:
            last_metrics = {k: float(v) for k, v in metrics.items()}
            last_metrics['lr'] = float(optimizer.lr_fn(optimizer.count - 1))
            if rank == 0:
                with open(log_file, 'a') as f:
                    f.write(json.dumps({'epoch': epoch, 'it': accumulated_iter,
                                        **last_metrics}) + '\n')
            logger.info('epoch %d iter %d/%d (it %d): loss %.4f, lr %.3e, grad_norm %.3f',
                        epoch, i + 1, total_it_each_epoch, accumulated_iter,
                        last_metrics['loss'], last_metrics['lr'],
                        last_metrics['grad_norm'])
    return accumulated_iter, last_metrics


def train_model(net, train_loader, start_epoch, total_epochs, start_iter, ckpt_save_dir,
                log_file, logger, train_sampler=None, ckpt_save_interval=1,
                max_ckpt_save_num=30, merge_all_iters_to_one_epoch=False):
    """Train ``net`` (``init_training`` done) from ``start_epoch`` to
    ``total_epochs``; returns (the iteration count, the loop's timing
    dict)."""
    accumulated_iter = start_iter
    timer = _StepTimer(net.device)
    clock = {'start': time.perf_counter(), 'wait_s': 0.0, 'scans': 0,
             'first_s': None, 'first_wait_s': 0.0, 'first_scans': 0}
    total_it_each_epoch = len(train_loader)
    dataloader_iter = None
    if merge_all_iters_to_one_epoch:
        assert hasattr(train_loader.dataset, 'merge_all_iters_to_one_epoch')
        train_loader.dataset.merge_all_iters_to_one_epoch(merge=True, epochs=total_epochs)
        total_it_each_epoch = len(train_loader) // max(total_epochs, 1)
        dataloader_iter = iter(train_loader)
        clock['wait_s'] += time.perf_counter() - clock['start']
    for cur_epoch in range(start_epoch, total_epochs):
        if train_sampler is not None and hasattr(train_sampler, 'set_epoch'):
            train_sampler.set_epoch(cur_epoch)

        accumulated_iter, _ = train_one_epoch(
            net, train_loader, accumulated_iter, cur_epoch, log_file, logger, timer,
            clock, total_it_each_epoch=total_it_each_epoch,
            dataloader_iter=dataloader_iter)

        # the reference logs the memory's first rows each epoch
        memory = getattr(net.module.map_to_bev_module, 'memory', None)
        if memory is not None:
            logger.info('memory items[:2]: %s', memory.weight[:2, :4].detach().cpu().numpy())

        trained_epoch = cur_epoch + 1
        if trained_epoch % ckpt_save_interval == 0 and get_dist_info()[0] == 0:
            ckpt_list = glob.glob(str(ckpt_save_dir / 'checkpoint_epoch_*.pth'))
            ckpt_list.sort(key=os.path.getmtime)
            if len(ckpt_list) >= max_ckpt_save_num:
                for cur_file_idx in range(len(ckpt_list) - max_ckpt_save_num + 1):
                    os.remove(ckpt_list[cur_file_idx])
            save_checkpoint(net.module, ckpt_save_dir / f'checkpoint_epoch_{trained_epoch}.pth',
                            epoch=trained_epoch, it=accumulated_iter,
                            optimizer=net.train_state.optimizer)

    if net.device.type == 'cuda':
        torch.cuda.synchronize(net.device)
    loop_s = time.perf_counter() - clock['start']
    steps_ms = timer.times_ms()
    timing = {}
    if steps_ms:
        timing = {'train_time/scans_per_s': clock['scans'] / loop_s,
                  'train_time/loader_wait_share': clock['wait_s'] / loop_s,
                  'train_time/step_median_ms': statistics.median(steps_ms),
                  'train_time/steps': len(steps_ms),
                  'train_time/loop_s': loop_s}
        if len(steps_ms) > 1:
            steady_s = loop_s - clock['first_s']
            timing['train_time/steady_scans_per_s'] = \
                (clock['scans'] - clock['first_scans']) / steady_s
            timing['train_time/steady_loader_wait_share'] = \
                (clock['wait_s'] - clock['first_wait_s']) / steady_s
        logger.info('train loop on %s: %d steps in %.3f s (%.3f scans/s), %.4f of it '
                    'waiting on the DataLoader, train_step median %.3f ms',
                    net.device, len(steps_ms), loop_s, timing['train_time/scans_per_s'],
                    timing['train_time/loader_wait_share'],
                    timing['train_time/step_median_ms'])
    return accumulated_iter, timing
