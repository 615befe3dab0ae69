"""Dataset registry and dataloader factory (port of
``hvpr_tpu/datasets/__init__.py``, one process).

``build_dataloader`` wraps a dataset in ``torch.utils.data.DataLoader`` as
a host input pipeline of fixed-shape numpy batches (``collate_batch``);
``load_data_to_gpu`` in :mod:`hvpr_tpu_torch.models` moves them to the
card. ``dist=True`` (a sampler over processes) is not ported yet, and
raises.
"""

import multiprocessing
import os
from multiprocessing import forkserver, resource_tracker

import numpy as np
import torch.utils.data as torch_data

from .dataset import DatasetTemplate
from .kitti.kitti_dataset import KittiDataset

__all__ = {
    'DatasetTemplate': DatasetTemplate,
    'KittiDataset': KittiDataset,
}


def _seed_worker(worker_id):
    np.random.seed(worker_id)


def _worker_context():
    """The workers' start method: a fork of a server process that imported
    this package once (``forkserver``). The server never touches the card,
    so its forks hold no CUDA state, as spawned workers do not; but a
    spawned worker is a new interpreter that imports torch and the package,
    and the DataLoader starts its workers one after the other, every
    epoch."""
    ctx = multiprocessing.get_context('forkserver')
    ctx.set_forkserver_preload([__name__])
    return ctx


def stop_worker_server():
    """Stop the server that forks the workers (:func:`_worker_context`)
    and the resource tracker that it started, and reap both. Each would
    otherwise outlive this process for the moment it takes to see that it
    ended. Call it when no loader's workers run; a later loader starts
    them anew."""
    forkserver._forkserver._stop()
    tracker = resource_tracker._resource_tracker
    with tracker._lock:
        if tracker._fd is not None:
            os.close(tracker._fd)       # the tracker ends at this end of file
            if tracker._pid is not None:
                os.waitpid(tracker._pid, 0)
            tracker._fd = tracker._pid = None


def build_dataloader(dataset_cfg, class_names, batch_size, dist=False,
                     root_path=None, workers=4, logger=None, training=False,
                     merge_all_iters_to_one_epoch=False, total_epochs=0):
    """(dataset, DataLoader, sampler) of ``dataset_cfg['DATASET']``; the
    sampler is None in one process. ``workers`` processes are forked from
    a server process that holds no CUDA state (:func:`_worker_context`).

    In test mode the scenes come in order and worker i seeds numpy's global
    RNG with i, so two runs read the same batches. In training the loader
    shuffles, drops the last incomplete batch and leaves each worker's
    numpy seed to the DataLoader, which derives it from torch's RNG anew
    for each epoch: every epoch draws other augmentations, and a run is
    reproducible from ``torch.manual_seed``. ``merge_all_iters_to_one_epoch``
    makes one epoch of ``total_epochs`` passes over the scenes."""
    if dist:
        raise NotImplementedError('loading over several processes (DDP, '
                                  'ROADMAP A14) is not ported yet; run one process')
    name = dataset_cfg['DATASET']
    if name not in __all__:
        raise NotImplementedError(f'dataset {name!r} is not ported yet')
    dataset = __all__[name](dataset_cfg=dataset_cfg, class_names=class_names,
                            root_path=root_path, training=training,
                            logger=logger)
    if merge_all_iters_to_one_epoch:
        dataset.merge_all_iters_to_one_epoch(merge=True, epochs=total_epochs)

    dataloader = torch_data.DataLoader(
        dataset, batch_size=batch_size, pin_memory=False, num_workers=workers,
        shuffle=training, collate_fn=dataset.collate_batch, drop_last=training,
        timeout=0, worker_init_fn=None if training else _seed_worker,
        multiprocessing_context=_worker_context() if workers > 0 else None)
    return dataset, dataloader, None
