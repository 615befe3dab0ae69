"""Top-k-masked attention over a point table, for training (kernels K8-K10).

Port of ``hvpr_tpu/ops/topk_attend.py`` with the semantics of its XLA twin
(the non-Pallas branch of ``bucket_threshold`` and ``_attend_emulation``).
Per pillar row v of scan b, with ``s[v,n] = bf16(pillar) . bf16(sel[n]) +
neg[n]`` over the scan's N points (``neg`` is 0 for a valid point, -1e30
for padding):

- :func:`bucket_threshold` (K8): the points are split into 128 buckets by
  ``n mod 128`` (N padded to a multiple of 128 with -1e30 scores), and the
  threshold is the k-th largest of the 128 bucket maxima, ties counted
  (``topk(bmax, k)[-1]``). ``s >= threshold`` keeps a small superset of the
  exact top-k. Its inputs are detached (the JAX package's
  ``stop_gradient``) and it has no backward.
- :func:`masked_attend` (K9 forward, K10 backward): over the selected set
  ``{n : s[v,n] >= th[v], neg[n] == 0}``, with logits ``l = s`` when the
  call is shared (one tensor as both tables) and ``l = bf16(pillar) .
  bf16(val[n])`` otherwise::

      mx = max l;  e = exp(l - mx);  den = sum e;  w = e / den (0 if den == 0)
      out = bf16(w) . bf16(val)
      dval[n] = bf16( sum_v bf16(w[v,n]) * dout[v] )

  Differentiable in ``val_table`` only: the weights carry no gradient and
  ``pillars`` and ``sel_table`` get none (the JAX package's custom VJP
  returns zeros for them).

A call may be handed the selection of an earlier call over the same
pillars, selection table, ``neg``, threshold and row mask (its count and
``pair_idx``): the fused train step's second call, whose value table (the
memory reconstructions) is all that differs from the first. It then selects
the points listed there instead of recomputing the (V, N) scores, and
recomputes only rows that listed none because they overflow (below); its
outputs are the same bits.

The forward also returns each row's selected pairs, which the backward
reduces instead of recomputing the (V, N) scores: ``pair_idx`` (B, V, 128)
int32 holds the row's selected points in index order and ``pair_w`` (B, V,
128) bf16 the weights ``bf16(w)`` it used for ``out``, index -1 and weight 0
past the row's count. A row inside ``row_mask`` that selects more than 128
points (an overflow row: a tie over many points) keeps no pairs (all -1);
the backward recomputes its weights from the saved ``mx`` and ``den``, as
the dense plain version :func:`masked_attend_bwd_plain` does for every row.
That dense version stays as the oracle of both backwards.

Where the twin rounds in the backward (found from ``jax.grad`` of
``_attend_emulation``): ``dout`` stays f32 (the transposed product takes the
f32 cotangent and the bf16 weights with an f32 result), and ``dval``, the
cotangent of ``bf16(val)``, is rounded to bf16 before it is cast back to
f32. The twin also sums its 2048-row chunks of V in bf16; the port sums all
rows first and rounds once. The Pallas backward of the JAX package instead
returns ``dval`` in f32 and rounds ``dout`` to bf16.

Precision, as in K2 and K6/K7: ``s``, ``l``, ``out`` and ``dval`` are sums of
exact bf16 (or bf16 x f32) products, accumulated in f64 and rounded to f32
once; ``den`` sums f32 terms in f64. The f32 softmax steps (subtract, exp,
divide) are the same IEEE operations in the kernels and the plain versions.
So the selected sets and thresholds are the same bits in both, and the
float outputs differ at most by the order-dependent last bit of an f64 sum
(in practice not at all). The JAX package accumulates in f32.

Rows outside ``row_mask`` (B, V) (empty pillar slots, whose all-zero
features would select every point) are not computed: their
threshold, output, ``mx``, ``den`` and selected count are 0, and they add
nothing to ``dval``. The JAX package computes them; nothing reads them (the
canvas scatter drops them and the memory loss multiplies by the mask). A
row inside the mask may still select anything from 0 to N points.

On a CUDA tensor each wrapper launches its kernel from
``csrc/topk_attend.cu`` (the forward: the dense sweep, or the pair pass when
it is handed a selection); on a CPU tensor it runs the plain version.
"""

import torch

from ..utils import flops
from . import _kernels

NUM_BUCKETS = 128
_NEG = -1e30
_MAX_C = 64
_PLAIN_ROWS = 1024     # rows per chunk of the plain versions: (rows, N) f64 scores
PAIR_CAP = 128         # pair slots a row: the length of K9's shared list


def _round_up(x, m):
    return (x + m - 1) // m * m


def _bf(t):
    """Round to bf16, widen to f64 (bf16 products are exact in f64)."""
    return t.to(torch.bfloat16).double()


def _row_chunks(row_mask):
    """Per scan, (scan, row indices) in chunks of at most ``_PLAIN_ROWS``:
    the rows inside ``row_mask``."""
    for bi in range(row_mask.shape[0]):
        for chunk in torch.nonzero(row_mask[bi]).squeeze(1).split(_PLAIN_ROWS):
            yield bi, chunk


def _scores(p, tab, ng):
    """(rows, N) f32 selection scores of bf16-widened rows ``p``."""
    return (p @ tab.t()).float() + ng


def _scan_rows(pillars, sel_table, neg, thresh, bi, rows):
    """Scan ``bi``'s pillar rows ``rows``: (the rows widened from bf16, the
    scan's f32 neg, their (rows, N) f32 scores, the (rows, N) bool set they
    select)."""
    p, ng = _bf(pillars[bi, rows]), neg[bi].float()
    s = _scores(p, _bf(sel_table[bi]), ng)
    return p, ng, s, (s >= thresh[bi, rows, None]) & (ng == 0.0)


def selection(pillars, sel_table, neg, thresh, row_mask):
    """Per scan b, (b, its rows inside ``row_mask``, the (rows, N) bool set
    of points they select): the selection of K9, K10 and their plain
    versions."""
    for bi in range(pillars.shape[0]):
        rows = torch.nonzero(row_mask[bi]).squeeze(1)
        yield bi, rows, torch.cat([_scan_rows(pillars, sel_table, neg, thresh, bi, ch)[3]
                                   for ch in rows.split(_PLAIN_ROWS)])


def _exp(sel, l, mx):
    return torch.where(sel, torch.exp(l - mx[:, None]), 0.0)


def _normalize(e, den):
    return torch.where(den[:, None] > 0, e / den[:, None].clamp(min=1e-30), 0.0)


def bucket_threshold_plain(pillars, table, neg, k, row_mask):
    b, v, _ = pillars.shape
    n = table.shape[1]
    pad = _round_up(n, NUM_BUCKETS) - n
    th = torch.zeros(b, v, dtype=torch.float32, device=pillars.device)
    for bi, rows in _row_chunks(row_mask):
        s = _scores(_bf(pillars[bi, rows]), _bf(table[bi]), neg[bi].float())
        if pad:
            s = torch.cat([s, s.new_full((s.shape[0], pad), _NEG)], dim=1)
        bmax = s.reshape(s.shape[0], -1, NUM_BUCKETS).amax(dim=1)
        th[bi, rows] = torch.topk(bmax, k, dim=-1).values[:, -1]
    return th


def _pairs(sel, w):
    """A chunk's pair slots from its (rows, N) selection and bf16 weights:
    (rows, PAIR_CAP) int32 indices in index order, -1 past the count, and
    their weights as bf16, 0 past the count; all -1 and 0 for a row that
    selects more than PAIR_CAP points."""
    n = sel.shape[1]
    cnt = sel.sum(dim=-1)
    listed = sel & (cnt <= PAIR_CAP)[:, None]
    # the selected indices first, ascending: sort keys n (selected), n + N
    cols = torch.arange(n, device=sel.device).expand_as(sel)
    order = torch.sort(torch.where(listed, cols, cols + n), dim=-1).values
    order = order[:, :min(n, PAIR_CAP)]
    keep = order < n
    idx = torch.where(keep, order, -1).to(torch.int32)
    wts = torch.where(keep, torch.gather(w, 1, order % n), 0.0).to(torch.bfloat16)
    if n < PAIR_CAP:
        idx = torch.cat([idx, idx.new_full((idx.shape[0], PAIR_CAP - n), -1)], 1)
        wts = torch.cat([wts, wts.new_zeros((wts.shape[0], PAIR_CAP - n))], 1)
    return idx, wts


def _listed(pair_idx, n):
    """(rows, N) bool: the points a chunk's pair slots list."""
    sel = torch.zeros(pair_idx.shape[0], n + 1, dtype=torch.bool, device=pair_idx.device)
    sel.scatter_(1, torch.where(pair_idx >= 0, pair_idx, n).long(), True)
    return sel[:, :n]


def masked_attend_fwd_plain(pillars, sel_table, val_table, neg, thresh, shared,
                            row_mask, selection=None):
    """(out (B, V, C), mx (B, V), den (B, V), selected count (B, V) int32,
    pair_idx (B, V, 128) int32, pair_w (B, V, 128) bf16). ``selection``:
    an earlier call's (count, pair_idx) over the same pillars, sel_table,
    neg, thresh and row_mask, whose listed points are selected again; rows
    that overflowed recompute their selection."""
    b, v, c = pillars.shape
    n = sel_table.shape[1]
    dev = pillars.device
    out = torch.zeros(b, v, c, dtype=torch.float32, device=dev)
    mx = torch.zeros(b, v, dtype=torch.float32, device=dev)
    den = torch.zeros(b, v, dtype=torch.float32, device=dev)
    cnt = torch.zeros(b, v, dtype=torch.int32, device=dev)
    pair_idx = torch.full((b, v, PAIR_CAP), -1, dtype=torch.int32, device=dev)
    pair_w = torch.zeros(b, v, PAIR_CAP, dtype=torch.bfloat16, device=dev)
    for bi, rows in _row_chunks(row_mask):
        if selection is None or shared:
            # the shared call's logits are its scores
            p, _, s, sel = _scan_rows(pillars, sel_table, neg, thresh, bi, rows)
        else:
            p, s = _bf(pillars[bi, rows]), None
        if selection is not None:
            over = selection[0][bi, rows] > PAIR_CAP
            sel = _listed(selection[1][bi, rows], n)
            if bool(over.any()):
                sel[over] = _scan_rows(pillars, sel_table, neg, thresh, bi, rows[over])[3]
        val = _bf(val_table[bi])
        l = s if shared else (p @ val.t()).float()
        m = torch.where(sel, l, _NEG).amax(dim=-1)
        e = _exp(sel, l, m)
        d = e.double().sum(dim=-1).float()
        w = _bf(_normalize(e, d))
        out[bi, rows] = (w @ val).float()
        mx[bi, rows], den[bi, rows] = m, d
        cnt[bi, rows] = sel.sum(dim=-1).to(torch.int32)
        pair_idx[bi, rows], pair_w[bi, rows] = _pairs(sel, w.float())
    return out, mx, den, cnt, pair_idx, pair_w


def masked_attend_bwd_plain(pillars, sel_table, val_table, neg, thresh, mx, den,
                            dout, shared, row_mask):
    """(B, N, C) f32 gradient of ``val_table``, each value bf16-exact."""
    dval = torch.zeros(val_table.shape, dtype=torch.float64, device=pillars.device)
    for bi, rows in _row_chunks(row_mask):
        p, _, s, sel = _scan_rows(pillars, sel_table, neg, thresh, bi, rows)
        l = s if shared else (p @ _bf(val_table[bi]).t()).float()
        w = _normalize(_exp(sel, l, mx[bi, rows]), den[bi, rows])
        dval[bi] += _bf(w).t() @ dout[bi, rows].double()
    return dval.float().to(torch.bfloat16).float()


def masked_attend_bwd_pairs_plain(pillars, sel_table, val_table, neg, thresh, mx,
                                  den, dout, shared, row_mask, pair_idx, pair_w, cnt):
    """The plain version of K10: the gradient of ``val_table`` from the
    forward's pairs. Listed rows take their weights from the pairs and
    overflow rows (count above 128) recompute theirs; the (rows, N) weights
    then go through the same f64 product as :func:`masked_attend_bwd_plain`,
    so the two give the same bits when the pairs hold the forward's
    weights."""
    n = val_table.shape[1]
    dval = torch.zeros(val_table.shape, dtype=torch.float64, device=pillars.device)
    for bi, rows in _row_chunks(row_mask):
        listed = cnt[bi, rows] <= PAIR_CAP
        idx = pair_idx[bi, rows].long()
        # slots past a row's count (-1) land in a dropped column N
        w = torch.zeros(len(rows), n + 1, dtype=torch.float64, device=pillars.device)
        w.scatter_(1, torch.where(idx >= 0, idx, n), pair_w[bi, rows].double())
        w = w[:, :n]
        ovf = torch.nonzero(~listed).squeeze(1)
        if len(ovf):
            r = rows[ovf]
            p, _, s, sel = _scan_rows(pillars, sel_table, neg, thresh, bi, r)
            l = s if shared else (p @ _bf(val_table[bi]).t()).float()
            w[ovf] = _bf(_normalize(_exp(sel, l, mx[bi, r]), den[bi, r]))
        dval[bi] += w.t() @ dout[bi, rows].double()
    return dval.float().to(torch.bfloat16).float()


def _check(name, pillars, tables, neg, vecs, row_mask):
    """Validate the kernel inputs; returns (B, V, N, C)."""
    b, v, c = pillars.shape
    n = tables[0].shape[1]
    _kernels.check_cuda_input(f'{name} pillars', pillars, torch.bfloat16, 3)
    for t in tables:
        _kernels.check_cuda_input(f'{name} table', t, torch.bfloat16, 3)
        if t.shape != (b, n, c):
            raise ValueError(f'{name}: table {tuple(t.shape)} vs pillars '
                             f'{tuple(pillars.shape)}')
    _kernels.check_cuda_input(f'{name} neg', neg, torch.float32, 2)
    if neg.shape != (b, n):
        raise ValueError(f'{name}: neg {tuple(neg.shape)}, expected {(b, n)}')
    for t, shape in vecs:
        _kernels.check_cuda_input(name, t, torch.float32, len(shape))
        if t.shape != shape:
            raise ValueError(f'{name}: {tuple(t.shape)}, expected {shape}')
    _kernels.check_cuda_input(f'{name} row_mask', row_mask, torch.bool, 2)
    if row_mask.shape != (b, v):
        raise ValueError(f'{name}: row_mask {tuple(row_mask.shape)}, '
                         f'expected {(b, v)}')
    everything = (pillars, *tables, neg, *(t for t, _ in vecs), row_mask)
    if any(t.device != pillars.device for t in everything):
        raise ValueError(f'{name}: inputs on two devices')
    if c % 8 or not 8 <= c <= _MAX_C:
        raise ValueError(f'{name}: C={c} must be a multiple of 8 in [8, {_MAX_C}]')
    if n < 1:
        raise ValueError(f'{name}: the table has no point')
    return b, v, n, c


def _bf16(t):
    return t.detach().to(torch.bfloat16).contiguous()


def _selection_counts(cnt, row_mask):
    """(valid rows, points they select) of a (B, V) selected count."""
    return int(row_mask.sum()), float(cnt[row_mask].sum())


def pair_counts(cnt, row_mask):
    """(overflow rows, listed pairs) of a (B, V) selected count: the valid
    rows above the PAIR_CAP list, and the pairs the others list."""
    listed = (cnt <= PAIR_CAP) & row_mask
    return int(((cnt > PAIR_CAP) & row_mask).sum()), float(torch.where(listed, cnt, 0).sum())


def _check_k(k):
    if k > NUM_BUCKETS or k < 1:
        raise ValueError(
            f'bucket_threshold requires 1 <= k <= {NUM_BUCKETS} (got k={k}): '
            f'the per-bucket-max superset guarantee breaks past the bucket count')


def _threshold_plain(pillars, table, neg, k, row_mask):
    _check_k(k)
    return bucket_threshold_plain(pillars.detach(), table.detach(), neg, k, row_mask)


@_kernels.wrapper('bucket_threshold', _threshold_plain,
                  lambda out, pillars, table, neg, k, row_mask: flops.bucket_threshold_work(
                      *pillars.shape[:2], table.shape[1], pillars.shape[2],
                      int(row_mask.sum())))
def bucket_threshold(pillars, table, neg, k, row_mask):
    """Per-pillar top-k score threshold over the pillar's scan (kernel K8).

    Args:
        pillars: (B, V, C) query rows; table: (B, N, C) selection table;
            neg: (B, N) f32, 0 for valid points and -1e30 for padding;
            k: top-k, <= 128; row_mask: (B, V) bool, the rows to compute.
    Returns:
        (B, V) f32; ``score >= threshold`` on valid points is a superset of
        the exact top-k (0 outside ``row_mask``). No gradient flows
        through it.
    """
    _check_k(k)
    pb, tb = _bf16(pillars), _bf16(table)
    ng = neg.float().contiguous()
    b, v, n, c = _check('bucket_threshold', pb, (tb,), ng, (), row_mask)
    th = torch.empty(b, v, dtype=torch.float32, device=pillars.device)
    if b * v == 0:
        return th
    _kernels.launch('bucket_threshold', pillars, _kernels.ptr(pb), _kernels.ptr(tb),
                    _kernels.ptr(ng), _kernels.ptr(row_mask), _kernels.ptr(th), b, v, n, c,
                    int(k))
    return th


def _attend_kernel(pillars, sel_table, val_table, neg, thresh, shared, row_mask,
                   selection=None):
    """K9's kernel of a call: the pair pass when it is handed a selection,
    else the dense sweep."""
    return 'masked_attend_fwd' if selection is None else 'masked_attend_pairs'


def _fwd_work(out, pillars, sel_table, val_table, neg, thresh, shared, row_mask,
              selection=None):
    """The :class:`flops.Work` of a K9 call that returned ``out``."""
    dims = (*pillars.shape[:2], sel_table.shape[1], pillars.shape[2])
    if selection is None:
        return flops.masked_attend_fwd_work(*dims, *_selection_counts(out[3], row_mask),
                                            shared, PAIR_CAP)
    return flops.masked_attend_pairs_work(*dims, *_selection_counts(out[3], row_mask), shared,
                                          *pair_counts(selection[0], row_mask), PAIR_CAP)


@_kernels.wrapper(_attend_kernel, masked_attend_fwd_plain, _fwd_work)
def masked_attend_fwd(pillars, sel_table, val_table, neg, thresh, shared,
                      row_mask, selection=None):
    """Forward of :func:`masked_attend` (kernel K9): (out (B, V, C), mx, den,
    selected count, pair_idx, pair_w) with mx, den and count (B, V) and the
    pairs (B, V, 128) (see the module docstring). ``selection``: the (count,
    pair_idx) of an earlier call over the same pillars, sel_table, neg,
    thresh and row_mask; K9's pair pass then replaces its dense sweep."""
    pb, sb = _bf16(pillars), _bf16(sel_table)
    vb = sb if shared else _bf16(val_table)
    ng, th = neg.float().contiguous(), thresh.detach().float().contiguous()
    b, v, n, c = _check('masked_attend', pb, (sb, vb), ng,
                        ((th, (pillars.shape[0], pillars.shape[1])),), row_mask)
    dev = pillars.device
    if selection is not None:
        sel_cnt, sel_idx = (t.contiguous() for t in selection)
        for name, t, shape in (('count', sel_cnt, (b, v)),
                               ('pair_idx', sel_idx, (b, v, PAIR_CAP))):
            _kernels.check_cuda_input(f'masked_attend selection {name}', t, torch.int32,
                                      len(shape))
            if t.shape != shape or t.device != dev:
                raise ValueError(f'masked_attend: selection {name} {tuple(t.shape)}, '
                                 f'expected {shape} on the pillars device')
    out = torch.empty(b, v, c, dtype=torch.float32, device=dev)
    mx = torch.empty(b, v, dtype=torch.float32, device=dev)
    den = torch.empty(b, v, dtype=torch.float32, device=dev)
    cnt = torch.empty(b, v, dtype=torch.int32, device=dev)
    pair_idx = torch.empty(b, v, PAIR_CAP, dtype=torch.int32, device=dev)
    pair_w = torch.empty(b, v, PAIR_CAP, dtype=torch.bfloat16, device=dev)
    if b * v == 0:
        return out, mx, den, cnt, pair_idx, pair_w
    outs = [_kernels.ptr(t) for t in (out, mx, den, cnt, pair_idx, pair_w)]
    ins = [_kernels.ptr(t) for t in (pb, sb, vb, ng, th, row_mask)]
    if selection is None:
        name, extra = 'masked_attend_fwd', []
    else:
        name, extra = 'masked_attend_pairs', [_kernels.ptr(sel_cnt), _kernels.ptr(sel_idx)]
    _kernels.launch(name, pillars, *ins, *extra, *outs, b, v, n, c, int(bool(shared)))
    return out, mx, den, cnt, pair_idx, pair_w


def _bwd_work(out, pillars, sel_table, val_table, neg, thresh, mx, den, dout, shared,
              row_mask, pair_idx, pair_w, cnt):
    return flops.masked_attend_bwd_work(
        *pillars.shape[:2], sel_table.shape[1], pillars.shape[2],
        *_selection_counts(cnt, row_mask), shared, *pair_counts(cnt, row_mask))


@_kernels.wrapper('masked_attend_bwd', masked_attend_bwd_pairs_plain, _bwd_work)
def masked_attend_bwd(pillars, sel_table, val_table, neg, thresh, mx, den, dout,
                      shared, row_mask, pair_idx, pair_w, cnt):
    """Backward of :func:`masked_attend` (kernel K10): the (B, N, C) f32
    gradient of ``val_table`` for upstream gradient ``dout`` (B, V, C), from
    the forward's outputs ``mx``, ``den``, ``cnt`` and pairs."""
    pb, sb = _bf16(pillars), _bf16(sel_table)
    vb = sb if shared else _bf16(val_table)
    ng, th = neg.float().contiguous(), thresh.detach().float().contiguous()
    dy = dout.float().contiguous()
    bv = (pillars.shape[0], pillars.shape[1])
    b, v, n, c = _check('masked_attend backward', pb, (sb, vb), ng,
                        ((th, bv), (mx, bv), (den, bv), (dy, tuple(pillars.shape))),
                        row_mask)
    for name, t, dtype, shape in (('cnt', cnt, torch.int32, bv),
                                  ('pair_idx', pair_idx, torch.int32, bv + (PAIR_CAP,)),
                                  ('pair_w', pair_w, torch.bfloat16, bv + (PAIR_CAP,))):
        _kernels.check_cuda_input(f'masked_attend backward {name}', t, dtype, len(shape))
        if t.shape != shape or t.device != pillars.device:
            raise ValueError(f'masked_attend backward: {name} {tuple(t.shape)}, '
                             f'expected {shape} on the pillars device')
    if b * v * PAIR_CAP >= 2 ** 31:
        raise ValueError(f'masked_attend backward: B*V={b * v} rows give pair keys '
                         f'past int32')
    dval = torch.empty(b, n, c, dtype=torch.float32, device=pillars.device)
    if b * v == 0:
        return dval.zero_()
    work = torch.empty(_kernels.entry('masked_attend_bwd_work')(b, v, n), dtype=torch.int32,
                       device=pillars.device)
    _kernels.launch('masked_attend_bwd', pillars, _kernels.ptr(pb), _kernels.ptr(sb),
                    _kernels.ptr(vb), _kernels.ptr(ng), _kernels.ptr(th), _kernels.ptr(mx),
                    _kernels.ptr(den), _kernels.ptr(cnt), _kernels.ptr(pair_idx),
                    _kernels.ptr(pair_w), _kernels.ptr(dy), _kernels.ptr(dval),
                    _kernels.ptr(work), b, v, n, c, int(bool(shared)))
    return dval


class _MaskedAttend(torch.autograd.Function):

    @staticmethod
    def forward(ctx, pillars, sel_table, val_table, neg, thresh, row_mask, shared,
                sel_cnt, sel_idx):
        selection = None if sel_cnt is None else (sel_cnt, sel_idx)
        out, mx, den, cnt, pair_idx, pair_w = masked_attend_fwd(
            pillars, sel_table, val_table, neg, thresh, shared, row_mask, selection)
        ctx.save_for_backward(pillars, sel_table, val_table, neg, thresh,
                              row_mask, mx, den, cnt, pair_idx, pair_w)
        ctx.shared = shared
        ctx.mark_non_differentiable(cnt, pair_idx)
        # the selection outputs carry no gradient: backward gets None for
        # them (and for out when nothing used it), not tensors of zeros
        ctx.set_materialize_grads(False)
        return out, cnt, pair_idx

    @staticmethod
    def backward(ctx, dout, _cnt, _pair_idx):
        if dout is None:
            return (None,) * 9
        (pillars, sel_table, val_table, neg, thresh, row_mask, mx, den, cnt,
         pair_idx, pair_w) = ctx.saved_tensors
        dval = masked_attend_bwd(pillars, sel_table, val_table, neg, thresh, mx,
                                 den, dout, ctx.shared, row_mask, pair_idx, pair_w,
                                 cnt)
        # the gradient goes to the val slot only: when shared the same
        # tensor fills both table slots, and a gradient in both would double
        return None, None, dval.to(val_table.dtype), None, None, None, None, None, None


def masked_attend(pillars, sel_table, val_table, neg, thresh, row_mask,
                  selection=None, return_selection=False):
    """Threshold-selected softmax aggregation of value rows per pillar.

    Args:
        pillars: (B, V, C). sel_table, val_table: (B, N, C); passing the
            SAME tensor for both makes the call shared (the selection
            scores are then the aggregation logits).
        neg: (B, N) f32, 0 valid and -1e30 padded.
        thresh: (B, V) f32 from :func:`bucket_threshold` over the same
            sel_table.
        row_mask: (B, V) bool; rows outside it output 0.
        selection: optional, what ``return_selection`` returned from a call
            over the same pillars, sel_table, neg, thresh and row_mask
            (another val_table): its selected points are reused, not
            recomputed.
        return_selection: also return this call's selection.
    Returns:
        (B, V, C) f32, differentiable in ``val_table`` only (and, with
        ``return_selection``, the selection: (count (B, V), pair_idx (B, V,
        128)) int32). A row whose selected set is empty aggregates to
        exactly 0.
    """
    sel_cnt, sel_idx = (None, None) if selection is None else selection
    out, cnt, pair_idx = _MaskedAttend.apply(pillars, sel_table, val_table, neg, thresh,
                                             row_mask, sel_table is val_table, sel_cnt,
                                             sel_idx)
    return (out, (cnt, pair_idx)) if return_selection else out
