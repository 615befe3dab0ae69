"""The row gathers' deterministic backward (kernel K12's plain versions)
against the JAX package, on the CPU.

``group_points`` is SA2's grouping of SA1's features: its gradient sums
each point's contributions, which the port takes from
``gather_rows_backward_plain`` (an f32 ``index_add_`` in source order) and
the JAX package from ``jax.grad`` of its gather (XLA's scatter-add). f32:
rtol 1e-6, the same sums perhaps in another order. bf16: the port's bf16
gradient against JAX's f32 gradient of the upcast features rounded to
bf16, within one bf16 ulp, since both round one f32 sum once. The kernel's
set-up (a counting sort of the rows by target) has its plain version,
``gather_grad_ranges_plain``, held here to a stable sort and searchsorted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hvpr_tpu.ops import pointnet2 as jax_pn2

from hvpr_tpu_torch.ops import pointnet2 as port_pn2
from hvpr_tpu_torch.ops.gather_rows import gather_grad_ranges_plain

B, N, S, K, C = 2, 64, 32, 16, 24     # scans, points, centres, samples, channels


def _group_idx(case, rng):
    """(B, S, K) int32 indices of the grouping in ``case``."""
    if case == 'one target':
        return np.full((B, S, K), 3, np.int32)
    if case == 'empty targets':
        return rng.integers(0, N // 2, (B, S, K)).astype(np.int32)   # the upper half: none
    idx = rng.integers(0, N - 1, (B, S, K)).astype(np.int32)          # point N - 1: none
    if case == 'hub':
        # a ball query's backfill: a centre's empty slots repeat its first hit
        idx[:, ::3, 4:] = 7
    return idx


@pytest.mark.parametrize('case', ['hub', 'empty targets', 'one target', 'bf16'])
def test_group_points_gradient_matches_jax_grad(case):
    rng = np.random.default_rng(len(case))
    idx = _group_idx(case, rng)
    feats = rng.normal(size=(B, N, C)).astype(np.float32)
    dout = rng.normal(size=(B, S, K, C)).astype(np.float32)
    dtype = torch.bfloat16 if case == 'bf16' else torch.float32
    if dtype == torch.bfloat16:
        # bf16 values, so that both sides sum the same f32 numbers
        feats, dout = (torch.from_numpy(a).bfloat16().float().numpy() for a in (feats, dout))
    want = np.array(jax.grad(lambda f: jnp.sum(jax_pn2.group_points(
        f, jnp.asarray(idx)) * dout))(jnp.asarray(feats)))
    f = torch.from_numpy(feats).to(dtype).requires_grad_()
    out = port_pn2.group_points(f, torch.from_numpy(idx).long())
    assert out.shape == (B, S, K, C) and out.dtype == dtype
    (out.float() * torch.from_numpy(dout)).sum().backward()
    assert f.grad.dtype == dtype
    got = f.grad.float().numpy()
    listed = np.zeros((B, N), bool)
    np.put_along_axis(listed, idx.reshape(B, -1), True, axis=1)
    assert (~listed).any() and not got[~listed].any()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    else:
        want_bf16 = torch.from_numpy(want).bfloat16().float().numpy()
        mag = np.maximum(np.abs(got), np.abs(want_bf16))
        ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
        assert (np.abs(got - want_bf16) <= ulp).all()


@pytest.mark.parametrize('case', ['hub', 'empty targets', 'one target', 'no rows',
                                  'out of range'])
def test_gather_grad_ranges_plain_matches_stable_sort(case):
    """K12's set-up, plain: each target's offsets and its rows ascending,
    as a stable sort of the targets and searchsorted give them (rows whose
    target lies outside [0, n) left out)."""
    rng = np.random.default_rng(len(case))
    n = B * N
    if case == 'no rows':
        index = np.zeros(0, np.int64)
    else:
        index = (_group_idx(case if case != 'out of range' else 'plain', rng).astype(np.int64)
                 + N * np.arange(B)[:, None, None]).reshape(-1)
    if case == 'out of range':
        index[::7] = -2
        index[3::11] = n
    index = torch.from_numpy(index)
    offsets, order = gather_grad_ranges_plain(index, n)
    keep = torch.nonzero((index >= 0) & (index < n)).squeeze(1)
    keys, pos = torch.sort(index[keep], stable=True)
    assert torch.equal(offsets, torch.searchsorted(keys, torch.arange(n + 1)))
    assert torch.equal(order, keep[pos])
    assert int(offsets[-1]) == len(keep) and offsets.dtype == order.dtype == torch.int64
