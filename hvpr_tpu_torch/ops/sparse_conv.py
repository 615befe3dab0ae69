"""Sparse 3D convolution on an active-site list (the SECOND-family backbones).

Port of ``hvpr_tpu/ops/sparse_conv.py``, which is XLA in the JAX package (no
TPU kernel), so this is plain PyTorch: the convolutions run directly on the
active sites of a voxel grid, never on the dense grid.

- Sites are (B, V, 3) zyx coords + (B, V, C) features + a (B, V) validity
  mask, sorted per sample by linear cell id over the valid sites (invalid
  sites last).
- A neighbour is found by a binary search (``torch.searchsorted``) of its
  linear cell id in the sorted site list: no hash table.
- A Kz x Ky x Kx convolution is prod(K) rounds of lookup -> row gather ->
  (rows, C_in) @ (C_in, C_out), added to the output in the (dz, dy, dx)
  raster order of :func:`_offsets`: every output gathers its taps and
  nothing is scattered, so the forward is deterministic. The row gathers go
  through :func:`~hvpr_tpu_torch.ops.gather_rows.gather_rows`, whose
  backward sums each site's gradients in a fixed order (kernel K12 on the
  card) where ``torch.gather``'s would add by float atomics: a miss reads
  a real row (its value is masked out), so indices repeat. The misses'
  rows are spread over the sites rather than clipped to one (the JAX
  package clips them): K12 sums a row's contributions one after the
  other, and a row that took every miss of a layer would hold its thread
  for tens of thousands of zeros.
- Submanifold convs keep the input sites; a strided sparse conv builds its
  output sites (every strided cell whose receptive field touches an active
  input) by a sort and head-flag compaction, capped at ``max_out`` sites,
  and counts the sites the cap drops.

Kernel, stride and padding are per axis (z, y, x), so the backbone's
``conv_out`` (kernel (3, 1, 1), stride (2, 1, 1), padding 0) maps directly.
Weights are (Kz*Ky*Kx, C_in, C_out), tap-major in (dz, dy, dx) raster order,
the JAX package's layout.
"""

import numpy as np
import torch

from .gather_rows import gather_rows


def _triple(x):
    """Broadcast an int to a per-axis (z, y, x) tuple."""
    if isinstance(x, (tuple, list)):
        if len(x) != 3:
            raise ValueError(f'expected 3 per-axis values, got {x}')
        return tuple(int(v) for v in x)
    return (int(x),) * 3


def _linear_ids(coords, grid, valid):
    """(..., 3) zyx -> int64 linear ids; invalid -> the sentinel nz*ny*nx."""
    nz, ny, nx = grid
    c = coords.long()
    lin = c[..., 0] * (ny * nx) + c[..., 1] * nx + c[..., 2]
    return torch.where(valid, lin, lin.new_full((), nz * ny * nx))


def _in_grid(nb, grid):
    nz, ny, nx = grid
    return ((nb[..., 0] >= 0) & (nb[..., 0] < nz) & (nb[..., 1] >= 0) & (nb[..., 1] < ny)
            & (nb[..., 2] >= 0) & (nb[..., 2] < nx))


def spread_rows(shape, n, device):
    """(B, M) row indices 0, 1, ..., n - 1, 0, 1, ... along each row: where a
    gather's result is masked out, its rows spread over the source, so that
    no source row collects a hub of (zero) gradients, which the row
    gathers' backward would sum one after the other."""
    return (torch.arange(shape[1], device=device) % n).expand(shape)


def _lookup(sorted_lin, query_lin, query_valid):
    """Row of each query cell in the (B, V) sorted site list and whether it
    is there; a miss gives a spread row (:func:`spread_rows`)."""
    v = sorted_lin.shape[1]
    pos = torch.clamp(torch.searchsorted(sorted_lin, query_lin), 0, v - 1)
    hit = (torch.gather(sorted_lin, 1, pos) == query_lin) & query_valid
    return torch.where(hit, pos, spread_rows(pos.shape, v, pos.device)), hit


def _offsets(kernel, centered):
    """(prod(K), 3) tap offsets in (dz, dy, dx) raster order.

    ``centered``: offsets span [-(k-1)//2, k//2] per axis (submanifold);
    otherwise [0, k) from the window origin (strided conv).
    """
    rs = [np.arange(k) - ((k - 1) // 2 if centered else 0) for k in kernel]
    return np.stack(np.meshgrid(*rs, indexing='ij'), -1).reshape(-1, 3)


def _gather_taps(feats, weights, in_lin, query_coords, query_ok, offs, grid):
    """sum over taps t, in order, of (feats at query + offs[t]) @ weights[t],
    zero where the neighbour is not an active site."""
    out = feats.new_zeros(*query_coords.shape[:2], weights.shape[-1])
    offs = query_coords.new_tensor(offs)          # one copy to the device a call
    for t in range(len(offs)):
        nb = query_coords + offs[t]
        ok = query_ok & _in_grid(nb, grid)
        pos, hit = _lookup(in_lin, _linear_ids(nb, grid, ok), ok)
        rows = torch.where(hit[..., None], gather_rows(feats, pos), 0.0)
        out = out + rows @ weights[t]
    return out


def subm_conv3d(feats, coords, valid, weights, grid, kernel=None):
    """Submanifold sparse conv: the output sites are the input sites.

    Args:
        feats: (B, V, C_in).
        coords: (B, V, 3) int zyx, sorted by linear id over the valid sites.
        valid: (B, V) bool.
        weights: (prod(K), C_in, C_out).
        grid: (nz, ny, nx).
        kernel: per-axis kernel size; default cubic, from the weight rows
            (odd sizes only: a submanifold conv needs a centre tap).
    Returns:
        (B, V, C_out) features on the same sites, 0 on the invalid ones.
    """
    kernel = (_triple(round(len(weights) ** (1 / 3))) if kernel is None
              else _triple(kernel))
    if int(np.prod(kernel)) != weights.shape[0]:
        raise ValueError(f'kernel {kernel} does not match weights {tuple(weights.shape)}')
    if any(k % 2 == 0 for k in kernel):
        raise ValueError(f'submanifold conv needs odd kernels (centre tap); got {kernel}')
    grid = tuple(int(g) for g in grid)
    offs = _offsets(kernel, centered=True)
    lin = _linear_ids(coords, grid, valid)
    out = _gather_taps(feats, weights, lin, coords.long(), valid, offs, grid)
    return torch.where(valid[..., None], out, 0.0)


def sparse_conv3d_out_grid(grid, kernel, stride, padding):
    """Output grid of a strided sparse conv: floor((n + 2p - k) / s) + 1."""
    return tuple((n + 2 * p - k) // s + 1
                 for n, k, s, p in zip(grid, _triple(kernel), _triple(stride),
                                       _triple(padding)))


def _output_sites(coords, valid, kernel, stride, padding, out_grid, max_out):
    """The sorted output sites of a strided conv: (B, max_out) linear ids
    (the sentinel past the last site) and the (B,) count of sites the cap
    drops."""
    onz, ony, onx = out_grid
    sentinel = onz * ony * onx
    c = coords.long()
    pad, st, kn, og = c.new_tensor([padding, stride, kernel, out_grid]).unbind(0)
    # input z reaches output o iff z = s*o - p + j, j in [0, k): the
    # candidates are o = floor((z + p) / s) - d for d in [0, ceil(k / s))
    ncand = [-(-k // s) for k, s in zip(kernel, stride)]
    cands = c.new_tensor(np.stack(np.meshgrid(*[np.arange(n) for n in ncand],
                                              indexing='ij'), -1).reshape(-1, 3))
    lins = []
    for d in cands:
        oc = torch.div(c + pad, st, rounding_mode='floor') - d
        j = c + pad - oc * st
        ok = (valid & (j >= 0).all(-1) & (j < kn).all(-1) & (oc >= 0).all(-1)
              & (oc < og).all(-1))
        lins.append(torch.where(ok, oc[..., 0] * (ony * onx) + oc[..., 1] * onx + oc[..., 2],
                                c.new_full((), sentinel)))
    slin = torch.sort(torch.cat(lins, dim=1), dim=1).values
    head = (slin < sentinel) & torch.cat(
        [torch.ones_like(slin[:, :1], dtype=torch.bool), slin[:, 1:] != slin[:, :-1]], dim=1)
    rank = torch.cumsum(head, dim=1) - 1
    slot = torch.where(head & (rank < max_out), rank, rank.new_full((), max_out))
    out_lin = slin.new_full((slin.shape[0], max_out + 1), sentinel)
    out_lin = out_lin.scatter(1, slot, torch.where(slot < max_out, slin, sentinel))
    n_dropped = torch.clamp(head.sum(dim=1) - max_out, min=0).to(torch.int32)
    return out_lin[:, :max_out], n_dropped


def sparse_conv3d(feats, coords, valid, weights, grid, kernel, stride, padding,
                  max_out):
    """Strided sparse conv (spconv's SparseConv3d): a new output site list.

    Args:
        feats: (B, V, C_in); coords: (B, V, 3) sorted; valid: (B, V).
        weights: (prod(K), C_in, C_out).
        grid: the INPUT (nz, ny, nx).
        kernel, stride, padding: int or per axis (z, y, x).
        max_out: the output site cap.
    Returns:
        out_feats (B, max_out, C_out), out_coords (B, max_out, 3) sorted (in
        ``coords``' dtype), out_valid (B, max_out), n_dropped (B,) int32:
        the sites lost to the ``max_out`` cap (0 when the cap is adequate).
    """
    kernel, stride, padding = _triple(kernel), _triple(stride), _triple(padding)
    if int(np.prod(kernel)) != weights.shape[0]:
        raise ValueError(f'kernel {kernel} does not match weights {tuple(weights.shape)}')
    grid = tuple(int(g) for g in grid)
    og = sparse_conv3d_out_grid(grid, kernel, stride, padding)
    if min(og) <= 0:
        raise ValueError(f'empty output grid {og} from {grid} k={kernel} s={stride} '
                         f'p={padding}')
    onz, ony, onx = og
    out_lin, n_dropped = _output_sites(coords, valid, kernel, stride, padding, og,
                                       int(max_out))
    out_ok = out_lin < onz * ony * onx
    oyx = out_lin % (ony * onx)
    out_coords = torch.stack([out_lin // (ony * onx), oyx // onx, oyx % onx], dim=-1)
    # each output's taps: input cell s*o - p + offset
    origin = (out_coords * out_coords.new_tensor(stride)
              - out_coords.new_tensor(padding))
    out = _gather_taps(feats, weights, _linear_ids(coords, grid, valid), origin, out_ok,
                       _offsets(kernel, centered=False), grid)
    return (torch.where(out_ok[..., None], out, 0.0), out_coords.to(coords.dtype), out_ok,
            n_dropped)


def sparse_conv3d_downsample(feats, coords, valid, weights, grid, stride, max_out):
    """Kernel-3/pad-1 strided sparse conv (the VoxelBackBone8x stage shape)."""
    return sparse_conv3d(feats, coords, valid, weights, grid, kernel=3, stride=stride,
                         padding=1, max_out=max_out)
