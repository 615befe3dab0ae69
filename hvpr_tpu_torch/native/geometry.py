"""ctypes bindings for the native host geometry library.

The port's copy of ``hvpr_tpu/native/geometry.py``. ``csrc/geometry.cpp``
and ``csrc/kitti_match.cpp`` compile with g++ at first use into
``build/`` at the repository root (gitignored), named by a hash of the
sources and flags. Where no compiler is present (or the build fails),
:func:`available` is False and every caller takes its numpy path.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_LOCK = threading.Lock()
_LIB = None
_TRIED = False

_CSRC = Path(__file__).resolve().parent / 'csrc'
_SRCS = (_CSRC / 'geometry.cpp', _CSRC / 'kitti_match.cpp')
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / 'build'
_FLAGS = ('-O3', '-shared', '-fPIC')


def _so_path():
    digest = hashlib.sha256(b''.join(s.read_bytes() for s in _SRCS)
                            + ' '.join(_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f'libhvpr_geometry_{digest}.so'


def _load():
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        so = _so_path()
        try:
            if not so.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                # a name of this process's own, then an atomic rename: two
                # processes building at once each write their own file
                tmp = so.with_suffix(f'.{os.getpid()}.tmp')
                try:
                    subprocess.run(['g++', *_FLAGS, '-o', str(tmp), *map(str, _SRCS)],
                                   check=True, capture_output=True)
                    tmp.replace(so)
                finally:
                    tmp.unlink(missing_ok=True)
            lib = ctypes.CDLL(str(so))
        except (OSError, subprocess.CalledProcessError):
            return None
        f32p = ctypes.POINTER(ctypes.c_float)
        f64p = ctypes.POINTER(ctypes.c_double)
        i32p = ctypes.POINTER(ctypes.c_int32)
        for fn in (lib.boxes_iou_bev_cpu, lib.boxes_overlap_bev_cpu):
            fn.argtypes = [f32p, ctypes.c_int64, f32p, ctypes.c_int64, f32p]
            fn.restype = None
        lib.points_in_boxes_cpu_kernel.argtypes = [f32p, ctypes.c_int64, f32p,
                                                   ctypes.c_int64, i32p]
        lib.points_in_boxes_cpu_kernel.restype = None
        lib.kitti_compute_statistics.argtypes = [
            f64p, ctypes.c_int64, ctypes.c_int64, f64p, f64p, f64p,
            i32p, i32p, ctypes.c_double, ctypes.c_double,
            ctypes.c_int32, ctypes.c_int32, f64p, f64p, i32p]
        lib.kitti_compute_statistics.restype = None
        _LIB = lib
        return _LIB


def available():
    return _load() is not None


def _f32(x):
    return np.ascontiguousarray(x, dtype=np.float32)


def boxes_iou_bev(boxes_a, boxes_b):
    lib = _load()
    a, b = _f32(boxes_a), _f32(boxes_b)
    out = np.zeros((a.shape[0], b.shape[0]), dtype=np.float32)
    lib.boxes_iou_bev_cpu(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), a.shape[0],
        b.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), b.shape[0],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def boxes_overlap_bev(boxes_a, boxes_b):
    """Raw rotated-BEV intersection areas, (n, m)."""
    lib = _load()
    a, b = _f32(boxes_a), _f32(boxes_b)
    out = np.zeros((a.shape[0], b.shape[0]), dtype=np.float32)
    lib.boxes_overlap_bev_cpu(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), a.shape[0],
        b.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), b.shape[0],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def points_in_boxes(points, boxes):
    lib = _load()
    p, b = _f32(points), _f32(boxes)
    out = np.zeros((b.shape[0], p.shape[0]), dtype=np.int32)
    lib.points_in_boxes_cpu_kernel(
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), p.shape[0],
        b.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), b.shape[0],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out


def kitti_compute_statistics(overlaps, gt_alphas, dt_alphas, dt_scores,
                             ignored_gt, ignored_det, min_overlap, thresh,
                             compute_fp, compute_aos):
    """Greedy matching kernel; returns (tp, fp, fn, similarity, thresholds, assigned)."""
    lib = _load()
    overlaps = np.ascontiguousarray(overlaps, dtype=np.float64)
    num_dt, num_gt = overlaps.shape
    gt_alphas = np.ascontiguousarray(gt_alphas, dtype=np.float64)
    dt_alphas = np.ascontiguousarray(dt_alphas, dtype=np.float64)
    dt_scores = np.ascontiguousarray(dt_scores, dtype=np.float64)
    ignored_gt = np.ascontiguousarray(ignored_gt, dtype=np.int32)
    ignored_det = np.ascontiguousarray(ignored_det, dtype=np.int32)
    out = np.zeros(5, dtype=np.float64)
    out_th = np.zeros(max(num_gt, 1), dtype=np.float64)
    assigned = np.zeros(max(num_dt, 1), dtype=np.int32)

    f64p = ctypes.POINTER(ctypes.c_double)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.kitti_compute_statistics(
        overlaps.ctypes.data_as(f64p), num_dt, num_gt,
        gt_alphas.ctypes.data_as(f64p), dt_alphas.ctypes.data_as(f64p),
        dt_scores.ctypes.data_as(f64p),
        ignored_gt.ctypes.data_as(i32p), ignored_det.ctypes.data_as(i32p),
        float(min_overlap), float(thresh), int(compute_fp), int(compute_aos),
        out.ctypes.data_as(f64p), out_th.ctypes.data_as(f64p),
        assigned.ctypes.data_as(i32p))
    n_th = int(out[4])
    return (int(out[0]), int(out[1]), int(out[2]), float(out[3]),
            list(out_th[:n_th]), assigned.astype(bool))
