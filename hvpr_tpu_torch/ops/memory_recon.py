"""Memory reconstruction for training, forward and backward (kernels K6, K7).

Port of ``hvpr_tpu/ops/memory_recon.py`` ``memory_recon``: every row
addresses a learnable (M, C) memory with ``softmax(x W^T)``, hard shrinkage
(lambda) with L1 renorm, and is reconstructed as ``n W``; differentiable in
both ``x`` and ``W`` through the hand-derived backward of the JAX package::

    l = x W^T;  a = softmax(l);  u = a - lam
    s = relu(u) * a / (|u| + eps);  t = max(sum_m s, delta);  n = s / t
    y = n W
    dn = dy W^T
    ds = dn / t - 1{sum_m s > delta} * (sum_m dn*s) / t^2
    da = ds * 1{u > 0} * [(a + u) / (u + eps) - u*a / (u + eps)^2]
    dl = a * (da - sum_m da*a)
    dx = dl W;   dW = dl^T x + n^T dy

(``lam = 0`` skips the shrink: n = a, da = dn.) Every product takes bf16
inputs, as the JAX package's do: x, W, dy, n and dl are rounded to bf16
before ``x W^T``, ``n W``, ``dy W^T``, ``dl W``, ``dl^T x`` and ``n^T dy``.
Softmax, shrink and renorm run in f32.

Sums of bf16 products and the row sums (softmax denominator, ``sum s``,
``sum dn*s``, ``sum da*a``) accumulate in f64 and round to f32 once, in the
plain versions and in the kernels alike; the elementwise f32 steps are the
same IEEE operations in the same order. So on the card kernel and plain
version agree to the last bit, but for the rare f64 sum whose order-dependent
last bit decides an f32 rounding. The JAX package sums in f32; against it the
port differs by f32 rounding, amplified where a bf16 rounding of n or dl
flips.

On a CUDA tensor :func:`recon_forward` launches ``csrc/memory_recon.cu``'s
forward kernel (K6: the logits on the FP64 tensor cores, the row chain, and
``n W`` over each row's nonzero weights, or on the FP64 tensor cores where
a row has more than 512 of them or ``lam = 0``) and :func:`recon_backward`
its backward kernels (K7: the logits and dn, the row chain, dx and dW, the
products on the FP64 tensor cores); on a CPU tensor each runs its plain
version.
"""

import torch

from ..utils import flops
from . import _kernels

_EPS = 1e-12       # hard-shrink epsilon
_DELTA = 1e-12     # L1-renorm floor
_PLAIN_ROWS = 8192     # rows per chunk of the plain versions (bounds memory)
_MAX_C = 64
_SMEM_LIMIT = 232448   # bytes of shared memory a block can have on sm_90
_BWD_MAX_M = 3072      # memory rows K7's row chain holds (12 a thread, 256 threads)


def _bf(t):
    """Round to bf16, widen to f64 (bf16 products are exact in f64)."""
    return t.to(torch.bfloat16).double()


def _attention(x, w, lam):
    """(rows, M) softmax, shrunk weights s, their sum, and the normalized n."""
    l = (_bf(x) @ _bf(w).t()).float()
    e = torch.exp(l - l.amax(dim=-1, keepdim=True))
    a = e / e.double().sum(dim=-1, keepdim=True).float()
    if lam <= 0:
        return a, a, None, a
    u = a - lam
    s = torch.clamp(u, min=0.0) * a / (u.abs() + _EPS)
    t_raw = s.double().sum(dim=-1, keepdim=True).float()
    return a, s, t_raw, s / torch.clamp(t_raw, min=_DELTA)


def nonzero_weights(x, w, lam):
    """(R,) count of each row's nonzero bf16(n): the weights K6's sparse
    ``n W`` runs over."""
    return torch.cat([(_attention(xc, w, lam)[3].to(torch.bfloat16) != 0).sum(dim=1)
                      for xc in x.split(_PLAIN_ROWS)])


def recon_forward_plain(x, w, lam):
    out = [(_bf(_attention(xc, w, lam)[3]) @ _bf(w)).float()
           for xc in x.split(_PLAIN_ROWS)]
    return torch.cat(out) if out else x.new_zeros(0, w.shape[1])


def recon_backward_plain(x, w, dy, lam):
    dxs = []
    dw = torch.zeros(w.shape, dtype=torch.float64, device=w.device)
    for xc, dyc in zip(x.split(_PLAIN_ROWS), dy.split(_PLAIN_ROWS)):
        a, s, t_raw, n = _attention(xc, w, lam)
        dn = (_bf(dyc) @ _bf(w).t()).float()
        if lam > 0:
            t = torch.clamp(t_raw, min=_DELTA)
            dot = (dn.double() * s.double()).sum(dim=-1, keepdim=True).float()
            ds = dn / t - torch.where(t_raw > _DELTA, dot / (t * t), 0.0)
            u = a - lam
            d = u + _EPS
            da = ds * torch.where(u > 0, (a + u) / d - u * a / (d * d), 0.0)
        else:
            da = dn
        s2 = (da.double() * a.double()).sum(dim=-1, keepdim=True).float()
        dl = a * (da - s2)
        dxs.append((_bf(dl) @ _bf(w)).float())
        dw += _bf(dl).t() @ _bf(xc) + _bf(n).t() @ _bf(dyc)
    dx = torch.cat(dxs) if dxs else x.new_zeros(x.shape)
    return dx, dw.float()


def _check(name, x, w, *more):
    r, c = x.shape
    m = w.shape[0]
    for t in (x, w, *more):
        _kernels.check_cuda_input(name, t, torch.bfloat16, 2)
        if t.device != x.device:
            raise ValueError(f'{name}: inputs on two devices')
    if w.shape[1] != c or any(t.shape != x.shape for t in more):
        raise ValueError(f'{name}: x {tuple(x.shape)}, W {tuple(w.shape)}')
    if not 1 <= c <= _MAX_C:
        raise ValueError(f'{name}: C={c} outside [1, {_MAX_C}]')
    if m < 1:
        raise ValueError(f'{name}: the memory has no row')
    return r, m, c


def _pad8(t):
    """Zero channels up to a multiple of 8 (K6 stages 16-byte rows); a zero
    channel adds exact zeros to every product."""
    c = t.shape[1]
    return t if c % 8 == 0 else torch.nn.functional.pad(t, (0, 8 - c % 8))


@_kernels.wrapper('memory_recon_fwd', recon_forward_plain,
                  lambda out, x, w, lam: flops.memory_recon_fwd_work(
                      x.shape[0], w.shape[0], x.shape[1],
                      float(nonzero_weights(x, w, lam).sum())))
def recon_forward(x, w, lam):
    """(R, C) f32 rows, (M, C) f32 memory -> (R, C) f32 reconstructions."""
    xb = _pad8(x.to(torch.bfloat16)).contiguous()
    wb = _pad8(w.to(torch.bfloat16)).contiguous()
    r, m, cp = _check('memory_recon', xb, wb)
    c = x.shape[1]
    smem = _kernels.entry('memory_recon_fwd_smem')(m)
    if smem > _SMEM_LIMIT:
        raise ValueError(f'memory_recon: M={m} needs {smem} B of shared memory per '
                         f'block, above {_SMEM_LIMIT}')
    y = torch.empty(r, cp, dtype=torch.float32, device=x.device)
    if r == 0:
        return y[:, :c]
    _kernels.launch('memory_recon_fwd', x, _kernels.ptr(xb), _kernels.ptr(wb), _kernels.ptr(y),
                    r, m, cp, float(lam))
    return y if cp == c else y[:, :c].contiguous()


@_kernels.wrapper('memory_recon_bwd', recon_backward_plain,
                  lambda out, x, w, dy, lam: flops.memory_recon_bwd_work(
                      x.shape[0], w.shape[0], x.shape[1]))
def recon_backward(x, w, dy, lam):
    """(dx (R, C), dW (M, C)) f32 for upstream gradient ``dy`` (R, C)."""
    xb = x.to(torch.bfloat16).contiguous()
    wb = w.to(torch.bfloat16).contiguous()
    dyb = dy.to(torch.bfloat16).contiguous()
    r, m, c = _check('memory_recon backward', xb, wb, dyb)
    if m > _BWD_MAX_M:
        raise ValueError(f'memory_recon backward: M={m} above the {_BWD_MAX_M} '
                         f'memory rows its row chain holds')
    dev = x.device
    dx = torch.empty(r, c, dtype=torch.float32, device=dev)
    dw = torch.empty(m, c, dtype=torch.float32, device=dev)
    if r == 0:
        return dx, dw.zero_()
    if r > 64 * 65535:
        raise ValueError(f'memory_recon backward: R={r} rows exceed the grid of '
                         f'its logits pass')
    # f32 l and dn between the logits pass and the row chain, bf16 dl and n
    # between the chain and the dx and dW passes; per-split f64 partial dW
    # summed in a fixed order by a last pass
    ld = torch.empty(2, r, m, dtype=torch.float32, device=dev)
    dl = torch.empty(r, m, dtype=torch.bfloat16, device=dev)
    n = torch.empty(r, m, dtype=torch.bfloat16, device=dev)
    splits = max(1, min(16, r // 2048))
    partial = torch.empty(splits, m, c, dtype=torch.float64, device=dev)
    _kernels.launch('memory_recon_bwd', x, _kernels.ptr(xb), _kernels.ptr(wb),
                    _kernels.ptr(dyb), _kernels.ptr(dx), _kernels.ptr(ld), _kernels.ptr(dl),
                    _kernels.ptr(n), _kernels.ptr(partial), _kernels.ptr(dw), r, m, c,
                    float(lam), splits)
    return dx, dw


class _MemoryRecon(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, lam):
        ctx.save_for_backward(x, w)
        ctx.lam = lam
        return recon_forward(x, w, lam)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = recon_backward(x, w, dy.contiguous(), ctx.lam)
        return dx, dw, None


def memory_recon(rows, weight, shrink_thres=0.0):
    """Memory-attention reconstruction of every row (training path).

    Args:
        rows: (R, C) feature rows; weight: (M, C) memory; shrink_thres:
            hard-shrink lambda (0 disables shrink and renorm).
    Returns:
        (R, C) f32, differentiable in ``rows`` and ``weight``.
    """
    return _MemoryRecon.apply(rows.float(), weight.float(), float(shrink_thres))
