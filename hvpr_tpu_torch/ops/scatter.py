"""Plain PyTorch segment and scatter ops of the flat pillar layout.

Port of ``hvpr_tpu/ops/scatter.py``: ``scatter_to_bev`` (pillars into a
dense NHWC canvas), the masked doubling sweeps ``segment_broadcast_max_t`` /
``segment_sums_t`` over channel-major (C, R) rows, and
``segment_last_row``. These are the plain versions the CUDA kernels of
``segment_sweep.py`` and ``bev_canvas.py`` are held against.
"""

import torch


def scatter_to_bev(features, coords, mask, ny, nx):
    """(B, V, C) pillar features -> (B, ny, nx, C) canvas, zeros elsewhere.

    coords (B, V, 3) int (z, y, x); mask (B, V) bool. Cells of valid pillars
    must be unique per sample.
    """
    b, v, c = features.shape
    cell = coords[..., 1].long() * nx + coords[..., 2].long()          # (B, V)
    canvas = torch.zeros(b, ny * nx, c, dtype=features.dtype,
                         device=features.device)
    bi, vi = torch.nonzero(mask, as_tuple=True)
    canvas.index_put_((bi, cell[bi, vi]), features[bi, vi])
    return canvas.reshape(b, ny, nx, c)


def _sweep(y, safe_slot, max_seg, combine, neutral, reverse):
    """One masked doubling sweep along the row axis of (C, R) ``y``."""
    d = 1
    while d < max_seg:
        same = (safe_slot[:-d] == safe_slot[d:])[None, :]
        if reverse:
            nxt = torch.where(same, y[:, d:], neutral)
            y = torch.cat([combine(y[:, :-d], nxt), y[:, -d:]], dim=1)
        else:
            prv = torch.where(same, y[:, :-d], neutral)
            y = torch.cat([y[:, :d], combine(y[:, d:], prv)], dim=1)
        d *= 2
    return y


def segment_broadcast_max_t(x_t, safe_slot, max_seg=32):
    """Every row of (C, R) ``x_t`` replaced by its segment's max.

    Segments are contiguous runs of <= ``max_seg`` rows of equal slot;
    invalid rows carry a sentinel slot and -1e9. A forward running max then a
    reverse running max of it, each a masked doubling sweep.
    """
    neg = torch.tensor(-1e9, dtype=x_t.dtype, device=x_t.device)
    y = _sweep(x_t, safe_slot, max_seg, torch.maximum, neg, reverse=False)
    return _sweep(y, safe_slot, max_seg, torch.maximum, neg, reverse=True)


def segment_sums_t(x_t, safe_slot, max_seg=32):
    """Every row of (C, R) ``x_t`` replaced by its segment's full sum:
    inclusive prefix + inclusive suffix - self (invalid rows carry 0)."""
    zero = torch.tensor(0.0, dtype=x_t.dtype, device=x_t.device)
    fwd = _sweep(x_t, safe_slot, max_seg, torch.add, zero, reverse=False)
    bwd = _sweep(x_t, safe_slot, max_seg, torch.add, zero, reverse=True)
    return fwd + bwd - x_t


def segment_last_row(safe_slot, num_slots):
    """Index of each slot's last row: (num_slots,) int64, -1 if empty.

    Rows whose slot is >= num_slots (the sentinel) are dropped."""
    r = safe_slot.shape[0]
    last = torch.full((num_slots + 1,), -1, dtype=torch.int64,
                      device=safe_slot.device)
    idx = torch.clamp(safe_slot.long(), max=num_slots)
    last.scatter_reduce_(0, idx, torch.arange(r, device=safe_slot.device),
                         reduce='amax')
    return last[:num_slots]
