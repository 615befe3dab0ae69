"""Common numeric and host utilities (port of ``hvpr_tpu/utils/common_utils.py``).

``limit_period`` takes a tensor or a numpy array; the host side of the
data pipeline is on numpy. The process-group helpers (``get_dist_info``,
``init_dist_pytorch``, ``all_reduce_sum``, ``merge_results_dist``) take the
place of the JAX package's ``init_dist_jax`` and its mesh: one process a
card, joined by ``torch.distributed`` (NCCL on the card, gloo on the CPU).
"""

import logging
import os
import random

import numpy as np
import torch
import torch.distributed as dist


def limit_period(val, offset=0.5, period=np.pi):
    """Limit ``val`` to ``[-offset*period, (1-offset)*period)``."""
    floor = torch.floor if isinstance(val, torch.Tensor) else np.floor
    return val - floor(val / period + offset) * period


def rotate_points_along_z(points, angle):
    """Rotate (B, N, 3 + C) points by (B,) angles (rad, counter-clockwise
    around +z); numpy."""
    cosa, sina = np.cos(angle), np.sin(angle)
    zeros, ones = np.zeros_like(angle), np.ones_like(angle)
    rot_matrix = np.stack([
        cosa, sina, zeros,
        -sina, cosa, zeros,
        zeros, zeros, ones,
    ], axis=1).reshape(-1, 3, 3).astype(points.dtype)
    points_rot = np.matmul(points[:, :, 0:3], rot_matrix)
    return np.concatenate([points_rot, points[:, :, 3:]], axis=-1)


def mask_points_by_range(points, limit_range):
    """Boolean mask of points inside the x/y extent of ``limit_range``."""
    return (
        (points[:, 0] >= limit_range[0]) & (points[:, 0] <= limit_range[3])
        & (points[:, 1] >= limit_range[1]) & (points[:, 1] <= limit_range[4])
    )


def create_logger(log_file=None, rank=0, log_level=logging.INFO):
    """A logger to the console and, given ``log_file``, to that file; ranks
    other than 0 log errors only."""
    logger = logging.getLogger(f'hvpr_tpu_torch_rank{rank}' if log_file is None
                               else str(log_file))
    level = log_level if rank == 0 else logging.ERROR
    logger.setLevel(level)
    logger.propagate = False
    formatter = logging.Formatter('%(asctime)s  %(levelname)5s  %(message)s')
    if not logger.handlers:
        console = logging.StreamHandler()
        console.setLevel(level)
        console.setFormatter(formatter)
        logger.addHandler(console)
        if log_file is not None:
            file_handler = logging.FileHandler(log_file)
            file_handler.setLevel(level)
            file_handler.setFormatter(formatter)
            logger.addHandler(file_handler)
    return logger


def get_dist_info():
    """(rank, world size) of the default process group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def init_dist_pytorch(tcp_port, local_rank, backend='nccl'):
    """Join the process group of a ``torchrun`` launch (the reference
    OpenPCDet's ``init_dist_pytorch``): ``env://`` with torchrun's
    ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT`` (``tcp_port`` on
    this host where none is set), and, for NCCL, card ``local_rank`` as this
    process's device. With a group already initialized (by a caller that
    made it itself), its rank and world size. Returns (rank, world size)."""
    if dist.is_initialized():
        return get_dist_info()
    if backend == 'nccl':
        torch.cuda.set_device(local_rank)
    os.environ.setdefault('MASTER_ADDR', '127.0.0.1')
    os.environ.setdefault('MASTER_PORT', str(tcp_port))
    dist.init_process_group(backend=backend, init_method='env://')
    return get_dist_info()


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; its gradient is the sum over the ranks of the
    output's gradients (each rank's output feeds that rank's loss)."""

    @staticmethod
    def forward(ctx, tensor):
        out = tensor.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(tensor):
    """``tensor`` summed over the ranks of the default process group (the
    same bits on every rank), under autograd."""
    return _AllReduceSum.apply(tensor)


def merge_results_dist(result_part, size):
    """Each rank's list of results -> on rank 0 the lists interleaved (item
    i of rank 0, of rank 1, ..., then item i + 1: dataset order under the
    strided eval sampler), truncated to ``size`` (the sampler's padding
    dropped); None on the other ranks. In one process
    ``result_part[:size]``. The parts travel through the process group
    (``all_gather_object``), so every call stands alone: the JAX package's
    exchange directory (its ``tmpdir``) has no counterpart."""
    rank, world_size = get_dist_info()
    if world_size == 1:
        return result_part[:size]
    parts = [None] * world_size
    dist.all_gather_object(parts, result_part)
    if rank != 0:
        return None
    return [item for items in zip(*parts) for item in items][:size]


def set_random_seed(seed):
    """Seed Python, numpy and torch (every device), and make cuDNN pick
    deterministic algorithms, as the reference does. The port's train step
    then gives the same bits on every run without
    ``torch.use_deterministic_algorithms`` (its gathers' backward sums
    without atomics, ``ops/gather_rows.py``). cuBLAS gets a fixed workspace
    (``CUBLAS_WORKSPACE_CONFIG``, if unset; it must be set before the
    process's first cuBLAS call), which keeps its sums in one order across
    streams."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    os.environ['PYTHONHASHSEED'] = str(seed)
    os.environ.setdefault('CUBLAS_WORKSPACE_CONFIG', ':4096:8')
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def keep_arrays_by_name(gt_names, used_classes):
    inds = [i for i, name in enumerate(gt_names) if name in used_classes]
    return np.array(inds, dtype=np.int64)


def drop_info_with_name(info, name):
    keep_indices = [i for i, x in enumerate(info['name']) if x != name]
    return {key: val[keep_indices] for key, val in info.items()}
