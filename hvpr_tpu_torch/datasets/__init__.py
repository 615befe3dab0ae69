"""Dataset registry and dataloader factory (port of
``hvpr_tpu/datasets/__init__.py``, one process).

``build_dataloader`` wraps a dataset in ``torch.utils.data.DataLoader`` as
a host input pipeline of fixed-shape numpy batches (``collate_batch``);
``load_data_to_gpu`` in :mod:`hvpr_tpu_torch.models` moves them to the
card. The test mode is ported; the train mode and ``dist=True`` (a strided
eval sampler over processes) are not yet, and raise.
"""

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


def build_dataloader(dataset_cfg, class_names, batch_size, dist=False,
                     root_path=None, workers=4, logger=None, training=False):
    """(dataset, DataLoader, sampler) of ``dataset_cfg['DATASET']`` in
    scan order; the sampler is None in one process. ``workers`` processes
    are spawned (not forked) and worker i seeds numpy's global RNG with i,
    so two runs read the same batches."""
    if dist:
        raise NotImplementedError('distributed evaluation is not ported yet; '
                                  'run one process')
    name = dataset_cfg['DATASET']
    if name not in __all__:
        raise NotImplementedError(f'dataset {name!r} is not ported yet')
    dataset = __all__[name](dataset_cfg=dataset_cfg, class_names=class_names,
                            root_path=root_path, training=training,
                            logger=logger)

    dataloader = torch_data.DataLoader(
        dataset, batch_size=batch_size, pin_memory=False, num_workers=workers,
        shuffle=False, collate_fn=dataset.collate_batch, drop_last=False,
        timeout=0, worker_init_fn=_seed_worker,
        multiprocessing_context='spawn' if workers > 0 else None)
    return dataset, dataloader, None
