"""Common numeric and host utilities (port of ``hvpr_tpu/utils/common_utils.py``).

``limit_period`` takes a tensor or a numpy array; the rest is the host
side of the data pipeline, on numpy.
"""

import logging
import os
import random

import numpy as np
import torch


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


def set_random_seed(seed, deterministic=False):
    """Seed Python, numpy and torch (every device), and make cuDNN pick
    deterministic algorithms, as the reference does. ``deterministic`` also
    turns on ``torch.use_deterministic_algorithms``, so that two runs of
    the train step give the same bits (it costs the fused hvpr.yaml step
    about a fifth of its time); cuBLAS then needs
    ``CUBLAS_WORKSPACE_CONFIG`` set before the process's first cuBLAS call,
    which this sets if it is unset (too late if cuBLAS has run already)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    os.environ['PYTHONHASHSEED'] = str(seed)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    if deterministic:
        os.environ.setdefault('CUBLAS_WORKSPACE_CONFIG', ':4096:8')
        torch.use_deterministic_algorithms(True)


def keep_arrays_by_name(gt_names, used_classes):
    inds = [i for i, name in enumerate(gt_names) if name in used_classes]
    return np.array(inds, dtype=np.int64)


def drop_info_with_name(info, name):
    keep_indices = [i for i, x in enumerate(info['name']) if x != name]
    return {key: val[keep_indices] for key, val in info.items()}
