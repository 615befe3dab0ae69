"""FLOP and byte accounting, rooflines and MFU on the card (port of
``hvpr_tpu/utils/flops.py``).

Three sources, combined by the profilers of ``hvpr_tpu_torch/tools/``:

- **The aten count** (:func:`count`, :class:`Counter`, the counterpart of
  ``xla_cost``): a ``TorchDispatchMode`` that sees every aten op the eager
  program runs. FLOPs come from ``torch.utils.flop_counter``'s registered
  formulas (matmuls, convolutions, attention and their backwards), a
  multiply-add counted as 2 flops, as XLA counts it. Bytes are each op's
  tensor operands plus its results; a result that shares storage with an
  operand counts 0, and an op whose every result does (a view) counts 0.
  Two differences from XLA's cost analysis:

  - XLA counts only the in-bounds taps of a padded convolution, plus one
    flop for each element of an elementwise op; the formulas count every
    tap and no elementwise op. A 2x16x32x32 input through a 3x3 SAME
    convolution to 32 channels and a ReLU: XLA on the CPU counts 18,161,664
    and this count 18,874,368; the gap is the edge taps (778,240), less the
    ReLU's 65,536.
  - Eager ops are not fused, so the bytes are the traffic of each op as it
    runs, and what an op finds in L2 counts as device-memory traffic: an
    ``hbm_frac`` above 1 is a finding about that, not a rate.

- **The kernels' reports.** Each kernel wrapper of ``ops/`` checks
  :data:`counter` at its entry (``ops/_kernels.wrapper``, the call path
  they share): with a counter active it runs through
  :meth:`Counter.kernel`, which suspends the aten count inside it (on the
  CPU the plain version's own ops, on the card the wrapper's conversions)
  and adds the work its data-dependent function below gives for the call
  (valid rows, selected points, the ball query's visited pairs, nonzero
  weights). A CPU count and a card count of one path are then equal. With
  no counter active the wrapper does nothing more than that one check.
  Inside the counting pass a wrapper may read back what its count needs;
  outside it, nothing is read back.

- **The analytic formulas** of the JAX package (``memory_lookup_fused_flops``,
  ``bucket_threshold_flops``, ``masked_attend_flops``,
  ``memory_recon_flops``): the dense products their docstrings list,
  without the TPU's lane padding, so at widths that are multiples of 128
  (256 for V) they equal the JAX values. They are the ceiling of what the
  wrappers report, which counts only the work these inputs need.

The kernels' work functions are also the bound column of ``PERF.md``
(``chip_smoke.py``): the least time the card could take, the larger of the
bytes over the memory rate and the operations over the peak of their type
(:func:`bound`).

MFU = flops / seconds / bf16 peak, as in the JAX package (conservative for
f32 work); ``hbm_frac`` = bytes / seconds / memory rate. Without a card
:func:`device_peaks` raises: a profiler on the CPU writes ``null`` in
those fields.
"""

import os
import shutil
import subprocess
from typing import NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# NVIDIA's data sheet, H100 SXM, dense rates (no sparsity) at the full 700 W
# power limit: bf16 tensor cores, TF32, f32 outside the tensor cores, f64 on
# the tensor cores (DMMA), device memory in bytes/s
H100 = {'bf16': 989e12, 'tf32': 495e12, 'f32': 67e12, 'f64_tc': 67e12, 'hbm': 3.35e12}
# torch.cuda.get_device_name substring (lower case) -> rates
_CARDS = {'h100 80gb hbm3': H100, 'h100 sxm': H100}

counter = None      # the active Counter, read by ops/_kernels.wrapper's call path


def device_rates(device=None):
    """The published rates (:data:`H100`'s keys) of the CUDA device; raises
    without a card, or for a card the table does not hold."""
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: device rates are the card\'s; set '
                           'HVPR_PEAK_TFLOPS and HVPR_HBM_GBPS to give them')
    name = torch.cuda.get_device_name(device)
    for sub, rates in _CARDS.items():
        if sub in name.lower():
            return rates
    raise RuntimeError(f'no published rates for {name!r}: set HVPR_PEAK_TFLOPS '
                       f'and HVPR_HBM_GBPS')


def device_peaks(device=None):
    """(bf16 peak FLOP/s, device-memory bytes/s) of the CUDA device.

    Env overrides: HVPR_PEAK_TFLOPS / HVPR_HBM_GBPS (both: no card needed).
    """
    tflops = os.environ.get('HVPR_PEAK_TFLOPS')
    gbps = os.environ.get('HVPR_HBM_GBPS')
    if tflops and gbps:
        return float(tflops) * 1e12, float(gbps) * 1e9
    rates = device_rates(device)
    return (float(tflops) * 1e12 if tflops else rates['bf16'],
            float(gbps) * 1e9 if gbps else rates['hbm'])


def power_limit():
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card, e.g.
    'NVIDIA H100 80GB HBM3, 700.00 W'; None where there is no nvidia-smi."""
    smi = shutil.which('nvidia-smi')
    if smi is None:
        return None
    res = subprocess.run([smi, '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# the aten count
# ---------------------------------------------------------------------------


def _storage(t):
    return t.untyped_storage().data_ptr()


def _bytes_read(t):
    """Bytes of ``t``'s elements, an expanded (stride 0) dimension once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _op_bytes(func, args, kwargs, out):
    ins = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
    outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
    read = {_storage(t) for t in ins}
    fresh = [t for t in outs if _storage(t) not in read]
    if outs and not fresh and not func._schema.is_mutable:
        return 0.0                                    # a view: nothing moves
    return float(sum(map(_bytes_read, ins)) + sum(map(_bytes_read, fresh)))


class Work(NamedTuple):
    """What one kernel call needs: ``ops`` operations of the type of
    ``rate`` (a key of :data:`H100`), ``nbytes`` moved (each input read
    once, each output written once), and of ``ops`` the products the kernel
    runs on the FP64 tensor cores (``dmma_ops``)."""
    ops: float
    nbytes: float
    rate: str
    dmma_ops: float = 0.0


class Counter(TorchDispatchMode):
    """Counts the flops and bytes of the aten ops run inside it, and the
    work the kernel wrappers report. ``flops`` and ``bytes`` are the totals
    of both; ``kernels`` is {kernel name: {'calls', 'ops', 'bytes', 'rate',
    'dmma_ops'}} of the reports. One counter at a time."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.kernels = {}
        self._suspended = 0
        self._formulas = None

    def __enter__(self):
        global counter
        if counter is not None:
            raise RuntimeError('a Counter is already active')
        from torch.utils.flop_counter import flop_registry
        self._formulas = flop_registry
        counter = self
        return super().__enter__()

    def __exit__(self, *exc):
        global counter
        counter = None
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._suspended:
            formula = self._formulas.get(func._overloadpacket)
            if formula is not None:
                self.flops += float(formula(*args, **kwargs, out_val=out))
            self.bytes += _op_bytes(func, args, kwargs, out)
        return out

    def kernel(self, name, call, work):
        """``call()`` (a kernel wrapper's own call) with the aten count
        suspended, then add ``work(its result)``, a :class:`Work`, under
        kernel ``name``. Returns the result."""
        global counter
        counter = None
        self._suspended += 1
        try:
            out = call()
            w = work(out)
        finally:
            self._suspended -= 1
            counter = self
        entry = self.kernels.setdefault(name, {'calls': 0, 'ops': 0.0, 'bytes': 0.0,
                                               'rate': w.rate, 'dmma_ops': 0.0})
        entry['calls'] += 1
        entry['ops'] += w.ops
        entry['bytes'] += w.nbytes
        entry['dmma_ops'] += w.dmma_ops
        self.flops += w.ops
        self.bytes += w.nbytes
        return out


def count(fn, *args, **kwargs):
    """(fn(*args, **kwargs), flops, bytes) of the call, counted by a
    :class:`Counter`: the counterpart of the JAX package's ``xla_cost``."""
    with Counter() as c:
        out = fn(*args, **kwargs)
    return out, c.flops, c.bytes


# ---------------------------------------------------------------------------
# the analytic formulas (unpadded, madd = 2 flops)
# ---------------------------------------------------------------------------


def memory_lookup_fused_flops(rows, m, c):
    """ops/memory_lookup.py: bmax logits (2rMC) + apply logits (2rMC) +
    output matmul (2rMC); the threshold loop is negligible."""
    return 6.0 * rows * m * c


def bucket_threshold_flops(b, v, n, c):
    """ops/topk_attend.py bucket_threshold: one (V, C) x (C, N) score
    matmul per scan."""
    return 2.0 * b * v * n * c


def masked_attend_flops(b, v, n, c, shared, with_bwd):
    """ops/topk_attend.py masked_attend: fwd = selection scores (2BVNC)
    [+ aggregation logits (2BVNC) when not shared] + output matmul (2BVNC);
    bwd recomputes the weight tile (the same matmuls minus the output) and
    adds the transposed d_val matmul (2BVNC)."""
    unit = 2.0 * b * v * n * c
    fwd = unit * (2 if shared else 3)
    if not with_bwd:
        return fwd
    return fwd + unit * ((1 if shared else 2) + 1)


def memory_recon_flops(rows, m, c, with_bwd):
    """ops/memory_recon.py: fwd = addressing logits (2rMC) + reconstruction
    (2rMC); bwd recomputes the attention tile and runs the two cotangent
    matmuls (four units with the forward's two: 6 in all). K7 runs five
    products (the logits, dn, dx and dW's two), one more than this counts,
    so a backward call is held against the ``with_bwd`` value whole."""
    return 2.0 * rows * m * c * (6 if with_bwd else 2)


def tensor_bytes(*tensors):
    """Total bytes of the tensors' elements."""
    return float(sum(t.numel() * t.element_size() for t in tensors))


# ---------------------------------------------------------------------------
# the kernels' work from this run's inputs, and the bound
# ---------------------------------------------------------------------------


def bound(ops, flops_per_s, nbytes):
    """(bound ms, 'operations' or 'bytes') of ``ops`` operations at
    ``flops_per_s`` that move ``nbytes`` at the H100's memory rate."""
    t_ops, t_bytes = ops / flops_per_s, nbytes / H100['hbm']
    return max(t_ops, t_bytes) * 1e3, 'operations' if t_ops > t_bytes else 'bytes'


def total(works):
    """The :class:`Work` of several calls of one kernel."""
    works = list(works)
    return Work(sum(w.ops for w in works), sum(w.nbytes for w in works), works[0].rate,
                sum(w.dmma_ops for w in works))


def work_bound(work):
    """(bound ms, bound_by, ms of its DMMA products or None) of a
    :class:`Work` on the H100."""
    ms, by = bound(work.ops, H100[work.rate], work.nbytes)
    return ms, by, (work.dmma_ops / H100['f64_tc'] * 1e3 if work.dmma_ops else None)


def segment_sweep_work(c, r):
    """K1 on (C, R) f32 rows: the rows read and written once, the slots read."""
    return Work(0.0, 2.0 * c * r * 4 + r * 4, 'f32')


def memory_lookup_work(r, r_valid, m, c, selected):
    """K2: the logits of the valid rows and 2C flops a selected column on
    the bf16 tensor cores (the logits on DMMA); pillars read and output
    written in f32, the memory and the row mask read."""
    logits = 2.0 * r_valid * m * c
    return Work(logits + 2.0 * c * selected, 2.0 * r * c * 4 + m * c * 4 + r, 'bf16',
                logits)


def bev_canvas_work(b, v, c, ny, nx, valid, out_elsize, in_elsize):
    """K3: the canvas written once, the valid pillars' rows read once, the
    coords (12 B) and mask (1 B) of every slot read."""
    return Work(0.0, b * ny * nx * c * out_elsize + valid * c * in_elsize + b * v * 13.0,
                'f32')


def ball_stop(idx, cnt, nsample, n):
    """(B, S) points a centre's sweep for one radius needs: up to the first
    hit of its nsample-th bucket, else all ``n``."""
    return torch.where(cnt == nsample, idx[..., -1].long() + 1, n)


def ball_bytes(b, n, s, nsamples):
    """Bytes a ball query moves: points, centres (xyz f32) and mask in, idx
    and cnt out for each nsample."""
    return (b * n * 3 + b * s * 3) * 4.0 + b * n + sum(b * s * (ns + 1) * 4.0
                                                      for ns in nsamples)


def ball_query_work(b, n, s, nsamples, visited):
    """K4, one sweep for ``len(nsamples)`` radii: ~8 f32 operations for the
    distance and a compare a radius per (centre, point) pair up to the
    point at which every radius has its nsample buckets (``visited`` pairs,
    from :func:`ball_stop`)."""
    return Work((8.0 + len(nsamples)) * visited, ball_bytes(b, n, s, nsamples), 'f32')


def fps_work(r, l, nsamp):
    """K5: ~10 f32 operations per row and step (3 sub, 3 mul, 2 add, min,
    compare); points and validity read, samples written."""
    return Work(10.0 * r * l * nsamp, r * l * 3 * 4.0 + r * l + r * nsamp * 4.0, 'f32')


def three_nn_work(b, n, s):
    """K11: ~10 f32 operations per (unknown, known) pair; inputs read,
    distances and indices written."""
    return Work(10.0 * b * n * s, (b * n * 3 + b * s * 3) * 4.0 + b * s + b * n * 3 * 8.0,
                'f32')


def memory_recon_fwd_work(r, m, c, nonzero):
    """K6: x W^T and n W over the ``nonzero`` weights of n (a sparse
    product), on bf16 tensor cores (DMMA in the kernel)."""
    ops = 2.0 * r * m * c + 2.0 * c * nonzero
    return Work(ops, (2.0 * r * c + m * c) * 4, 'bf16', ops)


def memory_recon_bwd_work(r, m, c):
    """K7: five dense products (x W^T, dy W^T, dl W, dl^T x, n^T dy)."""
    ops = 5 * 2.0 * r * m * c
    return Work(ops, (3.0 * r * c + 2 * m * c) * 4, 'bf16', ops)


def _attend_io(b, v, n, c):
    """Elements of the pillars, one table, neg and the row mask."""
    return b * v * c + b * n * c + b * n + b * v


def _attend_outs(b, v, c, pair_cap):
    """Bytes K9 writes: out, mx, den, count, and the pairs (int32 + bf16)."""
    return b * v * c * 4.0 + 3 * b * v * 4 + b * v * pair_cap * 6


def bucket_threshold_work(b, v, n, c, r_valid):
    """K8: the dense (R, N) score product of the R valid rows."""
    ops = 2.0 * r_valid * n * c
    return Work(ops, _attend_io(b, v, n, c) * 4.0 + b * v + b * v * 4, 'bf16', ops)


def masked_attend_fwd_work(b, v, n, c, r_valid, selected, shared, pair_cap):
    """K9's dense sweep: the (R, N) scores, then 2C flops a selected point
    for the output, 2C more for its logit where the tables are split."""
    ops = 2.0 * r_valid * n * c + (1 if shared else 2) * 2.0 * c * selected
    io = _attend_io(b, v, n, c) + (0 if shared else b * n * c)
    return Work(ops, io * 4.0 + b * v + _attend_outs(b, v, c, pair_cap), 'bf16', ops)


def masked_attend_pairs_work(b, v, n, c, r_valid, selected, shared, overflow, listed,
                             pair_cap):
    """K9's pair pass on an earlier call's selection: no dense product but
    for its ``overflow`` rows; the selection's count and ``listed``
    indices read, each selected value row read once."""
    per = 1 if shared else 2
    ops = per * 2.0 * c * selected + per * 2.0 * c * n * overflow
    nbytes = ((r_valid * c + b * n * c + b * n + b * v * 2) * 4.0 + b * v + listed * 4
              + _attend_outs(b, v, c, pair_cap))
    return Work(ops, nbytes, 'bf16')


def masked_attend_bwd_work(b, v, n, c, r_valid, selected, shared, overflow, listed):
    """K10: the reduce over the listed pairs (2C flops a pair, f32), the
    overflow rows' scores (and split logits) at every point; the valid rows
    of dout and the pairs read, dval written."""
    ops = 2.0 * c * selected + (1 if shared else 2) * 2.0 * c * n * overflow
    return Work(ops, r_valid * c * 4.0 + listed * 6 + b * n * c * 4, 'f32')


def gather_grad_work(rows, c, elsize, n):
    """K12: the gathered rows' gradient and their int64 targets read once,
    the source gradient written once; an f32 add an element."""
    return Work(float(rows * c), rows * c * elsize + rows * 8.0 + n * c * elsize, 'f32')



# f32 operations a pair of the plain rotated IoU (ops/rotated_iou.py, its
# (N, M) planes' add, sub, mul, div, maximum, minimum and clamp): P's edges
# clipped to Q, 4 edges x (4 half-planes x 15 + 12), Q's to P, 4 x (4 x 12
# + 12), the area cap, the sum, the half, the clamp and the cap's min; the
# IoU's sum of areas, difference, clamp and quotient on top
ROTATED_OVERLAP_OPS = 4 * (4 * 15 + 12) + 4 * (4 * 12 + 12) + 5
ROTATED_IOU_OPS = ROTATED_OVERLAP_OPS + 4


def rotated_iou_work(n, m, iou):
    """K13 on (N, 7) x (M, 7) boxes: the plain arithmetic's operations for
    every pair (the kernel skips most of them for pairs it proves apart);
    the boxes' 21-float records read, the (N, M) f32 plane written."""
    ops = ROTATED_IOU_OPS if iou else ROTATED_OVERLAP_OPS
    return Work(float(ops * n * m), 4.0 * n * m + 84.0 * (n + m), 'f32')


def sparse_rulebook_work(b, v, m, taps, coord_elsize):
    """K14 on (B, V) sorted ids and (B, M) query sites: the ids, the
    queries' zyx coordinates and validity read once, the (taps, B, M)
    int64 rows and bool hits written once; no float operation."""
    return Work(0.0, 8.0 * b * v + b * m * (3.0 * coord_elsize + 1.0) + 9.0 * taps * b * m,
                'f32')

# ---------------------------------------------------------------------------
# reporting
# ---------------------------------------------------------------------------


def utilization(flops, bytes_accessed, seconds, peaks=None):
    """dict(mfu, hbm_frac, bound) for one measured region; ``peaks``
    (bf16 FLOP/s, bytes/s) defaults to :func:`device_peaks`."""
    peak_flops, peak_bw = device_peaks() if peaks is None else peaks
    mfu = flops / seconds / peak_flops if seconds > 0 else 0.0
    hbm = bytes_accessed / seconds / peak_bw if seconds > 0 else 0.0
    if mfu < 0.02 and hbm < 0.1:
        bound_by = 'latency/host'
    elif mfu >= hbm:
        bound_by = 'compute'
    else:
        bound_by = 'hbm'
    return {'mfu': round(mfu, 4), 'hbm_frac': round(hbm, 4), 'bound': bound_by}
