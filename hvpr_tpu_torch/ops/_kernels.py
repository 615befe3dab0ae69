"""Build, load and count the port's hand-written CUDA kernels.

Each source ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds). Libraries land in ``build/`` at
the repository root, named by a hash of their source and of the shared
headers ``csrc/*.cuh``, and are built at first use: all missing ones at
once, one ``nvcc`` process per source, started together. Nothing here runs
at import time.

Every wrapper in ``ops/`` calls :func:`launched` right after its kernel
returns: it raises on a nonzero ``cudaGetLastError()`` and otherwise adds one
to that kernel's launch count, so a run can show which kernels it went
through. At its entry each wrapper also reports its work to an active
``utils.flops.Counter`` (one check of ``flops.counter`` when none is).
"""

import contextlib
import ctypes
import hashlib
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / 'csrc'
BUILD_DIR = _PKG.parent / 'build'
SOURCES = ('segment_sweep', 'memory_lookup', 'bev_canvas', 'ball_query',
           'fps_chunks', 'memory_recon', 'topk_attend', 'three_nn', 'gather_grad',
           'rotated_iou', 'sparse_rulebook')
# one launch count per kernel; memory_recon.cu holds K6 and K7, topk_attend.cu
# K8-K10, and K9 two kernels: the dense sweep (masked_attend_fwd) and the
# pair pass of a call handed another call's selection (masked_attend_pairs);
# gather_grad.cu holds K12, the deterministic backward of the point stream's
# row gathers (no TPU kernel: the JAX package's gathers are XLA);
# rotated_iou.cu holds K13, the rotated BEV IoU of box pairs (no TPU kernel);
# sparse_rulebook.cu K14, every tap's neighbour lookup of a sparse conv (no
# TPU kernel)
KERNELS = ('segment_sweep', 'memory_lookup', 'bev_canvas', 'ball_query',
           'fps_chunks', 'memory_recon_fwd', 'memory_recon_bwd',
           'bucket_threshold', 'masked_attend_fwd', 'masked_attend_pairs',
           'masked_attend_bwd', 'three_nn_bucket', 'gather_grad', 'rotated_iou',
           'sparse_rulebook')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_libs = {}
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


def entry(source, name, argtypes, restype=ctypes.c_int):
    """The C function ``name`` of library ``source``, its signature declared
    on its first use (a ctypes function keeps it)."""
    fn = getattr(library(source), name)
    if fn.argtypes is None:
        fn.argtypes, fn.restype = argtypes, restype
    return fn


def stream_handle(tensor):
    """Raw handle of PyTorch's current stream on ``tensor``'s device."""
    return ctypes.c_void_p(torch.cuda.current_stream(tensor.device).cuda_stream)


def ptr(tensor):
    return ctypes.c_void_p(tensor.data_ptr())


def launched(name, err):
    """Raise on a launch error, else count one launch of kernel ``name``."""
    if err != 0:
        raise RuntimeError(f'CUDA kernel {name} failed to launch: '
                           f'cudaError {err}')
    _launches[name] += 1


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


def refuse_grad(name, *tensors):
    """Raise if autograd would need a gradient through a kernel that has no
    backward: the output of such a kernel carries no history, so a training
    forward through it would drop every gradient upstream silently."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
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
