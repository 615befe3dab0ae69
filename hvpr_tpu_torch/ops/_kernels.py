"""Build, load, declare and call the port's hand-written CUDA kernels.

Each source ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds). Libraries land in ``build/`` at
the repository root, named by a hash of their source and of the shared
headers ``csrc/*.cuh``, and are built at first use: all missing ones at
once, one ``nvcc`` process per source, started together. Nothing here runs
at import time.

:data:`ENTRIES` declares every C function the port calls, once: its source,
its symbol and its signature, set on the function at its first use. The
kernels are declared by their launch-count names (:data:`KERNELS`).

Every wrapper in ``ops/`` is made by :func:`wrapper`, one call path: report
the call to an active ``utils.flops.Counter`` (one check of
``flops.counter`` when none is), else run the plain version on a CPU tensor
or in a :func:`plain_versions` block, else refuse inputs that require grad
where the kernel has no backward, then run the wrapper's own code, which
checks its inputs, allocates its outputs and calls :func:`launch`: the
declared entry with the current stream last, a raise on a nonzero
``cudaError``, and one more launch on the kernel's count, so a run can show
which kernels it went through.
"""

import contextlib
import ctypes
import functools
import hashlib
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import torch

from ..utils import flops

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / 'csrc'
BUILD_DIR = _PKG.parent / 'build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')


class Entry(NamedTuple):
    """A C function of a kernel library: ``source`` (``csrc/<source>.cu``),
    its ``symbol`` and ``argtypes``. A launch returns a ``cudaError`` and
    takes the current stream after ``argtypes``; it adds one to the launch
    count ``counts`` (None: to none). A helper (``restype`` set) launches
    nothing: it returns a size or a limit."""
    source: str
    symbol: str
    argtypes: list
    counts: str = None
    restype: type = None


_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

# Every C function the port calls, by the name it calls it by. The kernels
# first, by launch-count name: K1-K3 the inference path, K4-K10 the train
# step (memory_recon.cu holds K6 and K7, topk_attend.cu K8-K10, K9 as two
# kernels: the dense sweep and the pair pass of a call handed another
# call's selection), K11 the bucketed 3-NN, which no path calls; K12 (the
# deterministic backward of the row gathers), K13 (the rotated BEV IoU of
# box pairs) and K14 (every tap's neighbour lookup of a sparse conv) have no
# TPU kernel, the JAX package's are XLA.
ENTRIES = {
    'segment_sweep': Entry('segment_sweep', 'hvpr_segment_sweep', [_P] * 3 + [_I] * 4,
                           'segment_sweep'),
    'memory_lookup': Entry('memory_lookup', 'hvpr_memory_lookup', [_P] * 6 + [_I] * 4,
                           'memory_lookup'),
    'bev_canvas': Entry('bev_canvas', 'hvpr_bev_canvas', [_P] * 5 + [_I] * 6, 'bev_canvas'),
    'ball_query': Entry('ball_query', 'hvpr_ball_query', [_P] * 5 + [_F] + [_I] * 4,
                        'ball_query'),
    'fps_chunks': Entry('fps_chunks', 'hvpr_fps_chunks', [_P] * 3 + [_I] * 3, 'fps_chunks'),
    'memory_recon_fwd': Entry('memory_recon', 'hvpr_memory_recon_fwd',
                              [_P] * 3 + [_I] * 3 + [_F], 'memory_recon_fwd'),
    'memory_recon_bwd': Entry('memory_recon', 'hvpr_memory_recon_bwd',
                              [_P] * 9 + [_I] * 3 + [_F, _I], 'memory_recon_bwd'),
    'bucket_threshold': Entry('topk_attend', 'hvpr_bucket_threshold', [_P] * 5 + [_I] * 5,
                              'bucket_threshold'),
    'masked_attend_fwd': Entry('topk_attend', 'hvpr_masked_attend_fwd', [_P] * 12 + [_I] * 5,
                               'masked_attend_fwd'),
    'masked_attend_pairs': Entry('topk_attend', 'hvpr_masked_attend_pairs',
                                 [_P] * 14 + [_I] * 5, 'masked_attend_pairs'),
    'masked_attend_bwd': Entry('topk_attend', 'hvpr_masked_attend_bwd', [_P] * 13 + [_I] * 5,
                               'masked_attend_bwd'),
    'three_nn_bucket': Entry('three_nn', 'hvpr_three_nn', [_P] * 6 + [_I] * 3,
                             'three_nn_bucket'),
    'gather_grad': Entry('gather_grad', 'hvpr_gather_grad', [_P] * 4 + [_L] + [_I] * 4,
                         'gather_grad'),
    'rotated_iou': Entry('rotated_iou', 'hvpr_rotated_iou',
                         [_P, _I, _P, _P] * 2 + [_P] + [_I] * 3 + [_P], 'rotated_iou'),
    'sparse_rulebook': Entry('sparse_rulebook', 'hvpr_sparse_rulebook',
                             [_P, _I, _P, _I, _P] + [_I] * 9 + [_P] * 2, 'sparse_rulebook'),
    # the second entries of K4 (two radii in one sweep) and K5 (sets above
    # 8192 rows), counted as theirs
    'ball_query2': Entry('ball_query', 'hvpr_ball_query2',
                         [_P] * 5 + [_F, _I] + [_P] * 2 + [_F] + [_I] * 4, 'ball_query'),
    'fps_long': Entry('fps_chunks', 'hvpr_fps_long', [_P] * 4 + [_I] * 3, 'fps_chunks'),
    # launches that count for no path: K12's set-up alone, K13's records of
    # the boxes and K6 run to the end of one of its parts, for holding them
    # to their plain versions and timing them
    'gather_grad_ranges': Entry('gather_grad', 'hvpr_gather_grad_ranges', [_P] * 2 + [_L, _I]),
    'rotated_iou_records': Entry('rotated_iou', 'hvpr_rotated_iou_records',
                                 [_P, _I, _P, _P, _I, _P]),
    'memory_recon_fwd_part': Entry('memory_recon', 'hvpr_memory_recon_fwd_part',
                                   [_P] * 3 + [_I] * 3 + [_F, _I]),
    # helpers: shared memory a block, scratch sizes, list caps
    'memory_lookup_smem': Entry('memory_lookup', 'hvpr_memory_lookup_smem', [_I], restype=_L),
    'memory_recon_fwd_smem': Entry('memory_recon', 'hvpr_memory_recon_fwd_smem', [_I],
                                   restype=_L),
    'memory_recon_fwd_cap': Entry('memory_recon', 'hvpr_memory_recon_fwd_cap', [], restype=_I),
    'masked_attend_bwd_work': Entry('topk_attend', 'hvpr_masked_attend_bwd_work', [_I] * 3,
                                    restype=_L),
    'gather_grad_scratch': Entry('gather_grad', 'hvpr_gather_grad_scratch', [_L] * 2,
                                 restype=_L),
    'three_nn_padded': Entry('three_nn', 'hvpr_three_nn_padded', [_I], restype=_I),
    'fps_long_head': Entry('fps_chunks', 'hvpr_fps_long_head', [], restype=_I),
}
SOURCES = tuple(dict.fromkeys(e.source for e in ENTRIES.values()))
KERNELS = tuple(dict.fromkeys(e.counts for e in ENTRIES.values() if e.counts))

_libs = {}
_fns = {}
_launches = dict.fromkeys(KERNELS, 0)
_plain = [False]


def _nvcc():
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not Path(path).exists():
        raise RuntimeError('nvcc not found: the CUDA kernels build only '
                           'where the CUDA toolkit is installed')
    return path


def _lib_path(name):
    # the headers of csrc/ too: a source that includes an edited header
    # must not load a library built from the old one
    headers = b''.join(p.read_bytes() for p in sorted(CSRC.glob('*.cuh')))
    digest = hashlib.sha256((CSRC / f'{name}.cu').read_bytes() + headers
                            + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f'libhvpr_{name}_{digest}.so'


def build_all():
    """Compile every kernel library that is not built yet, in parallel.

    Returns {name: {'seconds': wall time, 'log': nvcc/ptxas output}} for the
    libraries it built (empty when all were already there).
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in SOURCES if not _lib_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        tmp = _lib_path(name).with_suffix('.tmp')
        cmd = [nvcc, *NVCC_FLAGS, '-o', str(tmp), str(CSRC / f'{name}.cu')]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    report, failed = {}, []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        report[name] = {'seconds': time.perf_counter() - t0, 'log': log}
        if proc.returncode != 0:
            failed.append(f'{name}:\n{log}')
        else:
            tmp.replace(_lib_path(name))
    if failed:
        raise RuntimeError('nvcc failed for ' + '\n'.join(failed))
    return report


def library(name):
    """The loaded ctypes library of source ``name`` (built on first use)."""
    lib = _libs.get(name)
    if lib is None:
        if not _lib_path(name).exists():
            build_all()
        lib = ctypes.CDLL(str(_lib_path(name)))
        _libs[name] = lib
    return lib


def entry(name):
    """The C function of :data:`ENTRIES` ``name``, its signature set at its
    first use."""
    fn = _fns.get(name)
    if fn is None:
        e = ENTRIES[name]
        fn = getattr(library(e.source), e.symbol)
        if e.restype is None:
            fn.argtypes, fn.restype = [*e.argtypes, _P], _I
        else:
            fn.argtypes, fn.restype = e.argtypes, e.restype
        _fns[name] = fn
    return fn


def stream_handle(tensor):
    """Raw handle of PyTorch's current stream on ``tensor``'s device."""
    return ctypes.c_void_p(torch.cuda.current_stream(tensor.device).cuda_stream)


def ptr(tensor):
    return ctypes.c_void_p(tensor.data_ptr())


def launch(name, on, *args):
    """Launch :data:`ENTRIES` ``name`` with ``args`` and the current stream
    of ``on``'s device; raise on a launch error, else add one to its
    kernel's launch count."""
    err = entry(name)(*args, stream_handle(on))
    if err != 0:
        raise RuntimeError(f'CUDA kernel {name} failed to launch: cudaError {err}')
    counts = ENTRIES[name].counts
    if counts is not None:
        _launches[counts] += 1


def wrapper(name, plain, work, on=0, no_backward=False, count_args=None):
    """Make a kernel wrapper, called with positional arguments, from its
    own code ``body``, which checks the inputs, allocates the outputs and
    calls :func:`launch`. A call:

    1. under an active ``flops.Counter``, reports itself under ``name``
       (or ``name(*args)``, where one wrapper launches two kernels) with the
       work ``work(out, *args)``: the wrapper runs again with the counter
       off, on ``count_args(*args)`` where given (a call whose work reads
       an output that the caller's call does not ask for);
    2. runs ``plain(*args)`` unless :func:`use_kernel` of ``args[on]``;
    3. refuses inputs that require grad where the kernel has
       ``no_backward``;
    4. runs ``body(*args)``.
    """
    def make(body):
        @functools.wraps(body)
        def call(*args):
            if flops.counter is not None:
                if count_args is not None:
                    args = count_args(*args)
                return flops.counter.kernel(name if isinstance(name, str) else name(*args),
                                            lambda: call(*args), lambda out: work(out, *args))
            if not use_kernel(args[on]):
                return plain(*args)
            if no_backward:
                refuse_grad(name, *args)
            return body(*args)
        return call
    return make


def launch_counts():
    return dict(_launches)


def reset_launch_counts():
    for k in _launches:
        _launches[k] = 0


def use_kernel(tensor):
    """True when ``tensor`` is on a CUDA device and no :func:`plain_versions`
    block is active; CPU tensors always take the plain version."""
    return tensor.device.type == 'cuda' and not _plain[0]


@contextlib.contextmanager
def plain_versions():
    """Run every wrapper's plain PyTorch version, also on CUDA tensors.

    Only for holding the kernels against their plain versions on the card
    (``chip_smoke.py``, the CUDA tests); the main path never enters it.
    """
    _plain[0] = True
    try:
        yield
    finally:
        _plain[0] = False


def refuse_grad(name, *args):
    """Raise if autograd would need a gradient through a kernel that has no
    backward (a tensor of ``args`` requires grad): the output of such a
    kernel carries no history, so a training forward through it would drop
    every gradient upstream silently."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in args):
        raise RuntimeError(
            f'{name}: the CUDA kernel has no backward, but an input requires '
            f'grad; run it under torch.no_grad() or call its plain version')


def check_cuda_input(name, tensor, dtype, ndim):
    """Validate a tensor handed to a CUDA kernel wrapper."""
    if tensor.device.type != 'cuda':
        raise ValueError(f'{name}: expected a CUDA tensor, got {tensor.device}')
    if tensor.dtype != dtype:
        raise ValueError(f'{name}: expected {dtype}, got {tensor.dtype}')
    if tensor.dim() != ndim:
        raise ValueError(f'{name}: expected {ndim} dims, got {tuple(tensor.shape)}')
    if not tensor.is_contiguous():
        raise ValueError(f'{name}: expected a contiguous tensor')
