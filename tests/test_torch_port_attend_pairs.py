"""The masked attention's selected pairs (what K9 saves and K10 reduces) and
the pair-based backward, on the CPU.

The forward's plain version writes, per row, the points it selected in
index order with the bf16 weights it used for the output; the backward's
plain version (K10's) reduces them, recomputing the weights of overflow rows
(more than 128 selected). Both are held to the selection of
``topk_attend.selection``, to the dense backward ``masked_attend_bwd_plain``
(exactly: the same weights go through the same f64 product) and to the JAX
package's ``jax.grad`` of ``masked_attend`` (its XLA twin) at the tolerance
tests/test_torch_port_topk_attend.py states (1e-2 of scale: an f32-ulp
difference in den can flip a bf16 weight's rounding; dval is itself bf16).

The inputs cover shared and split tables, a zero pillar row that ties with
every valid point (selects N - 37 > 128: an overflow row), a scan with no
valid point (rows that select nothing) and rows outside ``row_mask``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hvpr_tpu.ops import topk_attend as jax_ta

from hvpr_tpu_torch.ops import topk_attend as port_ta

RTOL = 1e-2
CAP = port_ta.PAIR_CAP


def _t(x):
    return torch.from_numpy(np.array(x))


def _inputs(seed, b, v, n, c, quantized=False):
    """Pillars, selection and value tables, neg, a row mask and dout. Scan 0
    ends in 37 padded points and has the zero row 1 (inside the mask); scan
    2 has no valid point; a third of the rows are outside the mask."""
    rng = np.random.default_rng(seed)
    if quantized:                       # bf16-exact: multiples of 1/8
        def make(s):
            return (rng.integers(-32, 32, size=s) / 8.0).astype(np.float32)
    else:
        def make(s):
            return rng.normal(size=s).astype(np.float32)
    pillars, points, vals = make((b, v, c)), make((b, n, c)), make((b, n, c))
    pillars[0, 1] = 0.0
    neg = np.zeros((b, n), np.float32)
    neg[0, -37:] = -1e30
    neg[2] = -1e30
    mask = rng.uniform(size=(b, v)) > 0.3
    mask[0, 1] = True
    dout = rng.normal(size=(b, v, c)).astype(np.float32)
    return pillars, points, vals, neg, mask, dout


def _forward(pillars, points, vals, neg, mask, k, shared):
    tp, ts, tn, tm = _t(pillars), _t(points), _t(neg), _t(mask)
    tv = ts if shared else _t(vals)
    th = port_ta.bucket_threshold(tp, ts, tn, k, tm)
    return (tp, ts, tv, tn, th, tm), port_ta.masked_attend_fwd(tp, ts, tv, tn, th,
                                                               shared, tm)


@pytest.mark.parametrize('shared', [True, False])
@pytest.mark.parametrize('n', [100, 300])       # fewer points than slots; an overflow row
def test_plain_pairs_are_the_selection(shared, n):
    b, v, c, k = 3, 40, 16, 4
    pillars, points, vals, neg, mask, _ = _inputs(n + shared, b, v, n, c)
    (tp, ts, tv, tn, th, tm), (_, mx, den, cnt, pidx, pw) = _forward(
        pillars, points, vals, neg, mask, k, shared)
    assert pidx.shape == (b, v, CAP) and pidx.dtype == torch.int32
    assert pw.shape == (b, v, CAP) and pw.dtype == torch.bfloat16
    assert int(cnt[0, 1]) == n - 37                   # the zero row
    assert (cnt[2] == 0).all()                        # no valid point
    assert (pidx[~tm] == -1).all() and (pw[~tm] == 0).all()
    seen = 0
    for bi, rows, sel in port_ta.selection(tp, ts, tn, th, tm):
        # the dense weights the oracle recomputes from the saved mx and den
        p = tp[bi, rows].to(torch.bfloat16).double()
        s = (p @ ts[bi].to(torch.bfloat16).double().t()).float() + tn[bi]
        l = s if shared else (p @ tv[bi].to(torch.bfloat16).double().t()).float()
        e = torch.where(sel, torch.exp(l - mx[bi, rows, None]), 0.0)
        d = den[bi, rows, None]
        w = torch.where(d > 0, e / d.clamp(min=1e-30), 0.0).to(torch.bfloat16)
        for i, row in enumerate(rows.tolist()):
            picked = torch.nonzero(sel[i]).squeeze(1)
            assert int(cnt[bi, row]) == len(picked)
            if len(picked) > CAP:                     # an overflow row keeps no pair
                assert (pidx[bi, row] == -1).all() and (pw[bi, row] == 0).all()
                seen += 1
                continue
            m = len(picked)
            np.testing.assert_array_equal(pidx[bi, row, :m].numpy(), picked.numpy())
            assert (pidx[bi, row, m:] == -1).all() and (pw[bi, row, m:] == 0).all()
            assert torch.equal(pw[bi, row, :m], w[i, picked])
    assert seen == (1 if n > CAP + 37 else 0)


@pytest.mark.parametrize('shared', [True, False])
@pytest.mark.parametrize('masked', [True, False])
def test_pairs_backward_equals_dense_oracle(shared, masked):
    b, v, n, c, k = 3, 40, 300, 16, 4
    pillars, points, vals, neg, mask, dout = _inputs(7 + shared, b, v, n, c)
    if not masked:
        mask[:] = True
    (tp, ts, tv, tn, th, tm), (_, mx, den, cnt, pidx, pw) = _forward(
        pillars, points, vals, neg, mask, k, shared)
    assert int(cnt[tm].max()) > CAP                   # the overflow path runs
    got = port_ta.masked_attend_bwd(tp, ts, tv, tn, th, mx, den, _t(dout), shared, tm,
                                    pidx, pw, cnt)
    want = port_ta.masked_attend_bwd_plain(tp, ts, tv, tn, th, mx, den, _t(dout), shared,
                                           tm)
    assert torch.equal(got, want)
    assert float(got.abs().max()) > 0.0
    assert (got[2] == 0).all()                        # scan 2 selects nothing
    # the overflow rows' recomputed terms count: read as rows with no pair,
    # the gradient changes
    no_ovf = torch.where(cnt > CAP, 0, cnt)
    assert not torch.equal(port_ta.masked_attend_bwd_pairs_plain(
        tp, ts, tv, tn, th, mx, den, _t(dout), shared, tm, pidx, pw, no_ovf), got)


@pytest.mark.parametrize('n', [100, 300])        # with an overflow row at 300
@pytest.mark.parametrize('masked', [True, False])
def test_split_call_given_the_shared_selection(n, masked):
    """The fused step's second (split) call, handed the first (shared)
    call's count and pairs, returns the same bits as when it recomputes the
    selection: out, mx, den, count and pairs. Covers the zero row (it
    overflows at n = 300 and recomputes), masked rows, a whole masked tile
    of 32 rows, and a scan with no valid point."""
    b, v, c, k = 3, 80, 16, 4
    pillars, points, vals, neg, mask, _ = _inputs(n + masked, b, v, n, c)
    if masked:
        mask[:, 32:64] = False                     # a whole tile out
    else:
        mask[:] = True
    tp, ts, tv, tn, tm = _t(pillars), _t(points), _t(vals), _t(neg), _t(mask)
    th = port_ta.bucket_threshold(tp, ts, tn, k, tm)
    first = port_ta.masked_attend_fwd(tp, ts, ts, tn, th, True, tm)
    selection = (first[3], first[4])
    assert (int(first[3][0, 1]) > CAP) == (n > CAP + 37)
    assert (first[3][2] == 0).all()                # scan 2: no valid point
    want = port_ta.masked_attend_fwd(tp, ts, tv, tn, th, False, tm)
    got = port_ta.masked_attend_fwd(tp, ts, tv, tn, th, False, tm, selection)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    # the shared call given its own selection: the same bits too
    for g, w in zip(port_ta.masked_attend_fwd(tp, ts, ts, tn, th, True, tm, selection),
                    first):
        assert torch.equal(g, w)


def test_masked_attend_returns_and_reuses_its_selection():
    """Through autograd: the selection a shared call returns, handed to the
    split call, leaves its output and its gradient (to the value table
    only) as they are without it."""
    b, v, n, c, k = 3, 40, 300, 16, 4
    pillars, points, vals, neg, mask, dout = _inputs(3, b, v, n, c)
    tp, ts, tn, tm = _t(pillars), _t(points), _t(neg), _t(mask)
    th = port_ta.bucket_threshold(tp, ts, tn, k, tm)
    out1, selection = port_ta.masked_attend(tp, ts, ts, tn, th, tm, return_selection=True)
    assert torch.equal(out1, port_ta.masked_attend(tp, ts, ts, tn, th, tm))
    assert not any(t.requires_grad for t in selection)
    grads = []
    for sel in (None, selection):
        val = _t(vals).requires_grad_()
        out = port_ta.masked_attend(tp, ts, val, tn, th, tm, selection=sel)
        (out * _t(dout)).sum().backward()
        grads.append((out.detach(), val.grad))
    assert torch.equal(grads[0][0], grads[1][0]) and torch.equal(grads[0][1], grads[1][1])


def _jax_grad(pillars, points, vals, neg, dout, k, shared):
    """jax.grad of sum(masked_attend * dout) wrt the value table (with the
    selection table when shared), the JAX package's XLA twin."""
    pj, sj, nj = jnp.asarray(pillars), jnp.asarray(points), jnp.asarray(neg)
    th = jax_ta.bucket_threshold(pj, sj, nj, k)

    def loss(s, v_):
        out = jax_ta.masked_attend(pj, s, s if shared else v_, nj, th, shared)
        return (out * dout).sum()

    gs, gv = jax.grad(loss, argnums=(0, 1))(sj, jnp.asarray(vals))
    return np.asarray(gs) if shared else np.asarray(gv)


@pytest.mark.parametrize('shared', [True, False])
@pytest.mark.parametrize('quantized', [True, False])
def test_pairs_backward_matches_jax_grad(shared, quantized):
    b, v, n, c, k = 3, 24, 300, 64 if not quantized else 16, 8
    pillars, points, vals, neg, mask, dout = _inputs(11 + 2 * shared + quantized, b, v,
                                                     n, c, quantized)
    # rows outside the mask: the port skips them, JAX gets no cotangent there
    want = _jax_grad(pillars, points, vals, neg, np.where(mask[..., None], dout, 0.0),
                     k, shared)
    (tp, ts, tv, tn, th, tm), (_, mx, den, cnt, pidx, pw) = _forward(
        pillars, points, vals, neg, mask, k, shared)
    assert int(cnt[0, 1]) > CAP
    got = port_ta.masked_attend_bwd(tp, ts, tv, tn, th, mx, den, _t(dout), shared, tm,
                                    pidx, pw, cnt).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())
    np.testing.assert_array_equal(got, _t(got).to(torch.bfloat16).float().numpy())
    # through autograd: the same gradient, once on the val slot
    pts = _t(points).requires_grad_()
    val = pts if shared else _t(vals).requires_grad_()
    out = port_ta.masked_attend(tp, pts, val, tn, th, tm)
    (out * _t(dout)).sum().backward()
    np.testing.assert_array_equal(val.grad.numpy(), got)
