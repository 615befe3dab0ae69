"""Dataset registry and dataloader factory (port of
``hvpr_tpu/datasets/__init__.py``).

``build_dataloader`` wraps a dataset in ``torch.utils.data.DataLoader`` as
a host input pipeline of fixed-shape numpy batches (``collate_batch``);
``load_data_to_gpu`` in :mod:`hvpr_tpu_torch.models` moves them to the
card. With ``dist=True`` each rank of the process group reads its own
share: a ``DistributedSampler`` in training, :class:`StridedEvalSampler`
in evaluation.
"""

import multiprocessing
import os
from multiprocessing import forkserver, resource_tracker

import numpy as np
import torch.utils.data as torch_data

from ..utils.common_utils import get_dist_info
from .dataset import DatasetTemplate
from .kitti.kitti_dataset import KittiDataset
from .nuscenes.nuscenes_dataset import NuScenesDataset

__all__ = {
    'DatasetTemplate': DatasetTemplate,
    'KittiDataset': KittiDataset,
    'NuScenesDataset': NuScenesDataset,
}


def _seed_worker(worker_id):
    np.random.seed(worker_id)


class StridedEvalSampler(torch_data.Sampler):
    """Rank ``rank``'s share of an evaluation: the indices padded with the
    first ones to a multiple of ``world_size``, then every
    ``world_size``-th from ``rank`` (the JAX package's
    ``_StridedEvalSampler``, the reference's eval ``DistributedSampler``).
    Every scene is read once, a few twice; ``merge_results_dist`` restores
    dataset order and drops the repeats."""

    def __init__(self, dataset, world_size, rank):
        self.total = len(dataset)
        self.world_size = world_size
        self.rank = rank
        self.num_samples = -(-self.total // world_size)

    def __iter__(self):
        indices = list(range(self.total))
        indices += indices[:self.num_samples * self.world_size - self.total]
        return iter(indices[self.rank::self.world_size])

    def __len__(self):
        return self.num_samples


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
                     merge_all_iters_to_one_epoch=False, total_epochs=0, item_seed=None):
    """(dataset, DataLoader, sampler) of ``dataset_cfg['DATASET']``; the
    sampler is None without ``dist``. ``workers`` processes are forked from
    a server process that holds no CUDA state (:func:`_worker_context`),
    each rank's from its own.

    In test mode the scenes come in order and worker i seeds numpy's global
    RNG with i, so two runs read the same batches. In training the loader
    shuffles, drops the last incomplete batch and leaves each worker's
    numpy seed to the DataLoader, which derives it from torch's RNG anew
    for each epoch: every epoch draws other augmentations, and a run is
    reproducible from ``torch.manual_seed``. ``merge_all_iters_to_one_epoch``
    makes one epoch of ``total_epochs`` passes over the scenes.

    ``item_seed``: seed scene i's host draws with ``item_seed + i``
    (``DatasetTemplate.item_seed``), whoever reads it: the CLIs' evaluations
    give the same points, and so the same detections, in one process and
    over several.

    ``dist``: this rank's share under the process group
    (``get_dist_info``). In training a ``DistributedSampler`` (shuffled by
    its seed and the epoch of ``set_epoch``, the last incomplete batch of
    each rank dropped). A rank's workers draw its augmentations from
    seeds the DataLoader takes from that rank's torch RNG, so ranks seeded
    alike draw alike: the train CLI seeds rank r with its seed + r (the
    JAX package's CLI seeds every process alike). In evaluation
    :class:`StridedEvalSampler`."""
    name = dataset_cfg['DATASET']
    if name not in __all__:
        raise NotImplementedError(f'dataset {name!r} is not ported yet')
    dataset = __all__[name](dataset_cfg=dataset_cfg, class_names=class_names,
                            root_path=root_path, training=training,
                            logger=logger)
    if merge_all_iters_to_one_epoch:
        dataset.merge_all_iters_to_one_epoch(merge=True, epochs=total_epochs)
    dataset.item_seed = item_seed

    sampler = None
    if dist:
        rank, world_size = get_dist_info()
        sampler = (torch_data.distributed.DistributedSampler(
            dataset, num_replicas=world_size, rank=rank) if training
            else StridedEvalSampler(dataset, world_size, rank))
    dataloader = torch_data.DataLoader(
        dataset, batch_size=batch_size, pin_memory=False, num_workers=workers,
        shuffle=training and sampler is None, sampler=sampler,
        collate_fn=dataset.collate_batch, drop_last=training, timeout=0,
        worker_init_fn=None if training else _seed_worker,
        multiprocessing_context=_worker_context() if workers > 0 else None)
    return dataset, dataloader, sampler
