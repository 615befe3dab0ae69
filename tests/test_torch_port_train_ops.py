"""The port's train-path ops against the JAX package, on the CPU.

Inputs come from numpy seeds and go to both packages unchanged.

Tolerances and why:
- ball query and FPS select indices: exact. Both sides compute squared
  distances as ((dx*dx + dy*dy) + dz*dz) in f32, every op rounded, and
  apply the same selection rules.
- three_nn: indices exact; squared distances atol 1e-3 m^2: the same
  centred matmul form |u|^2 + |k|^2 - 2 u.k, whose f32 cancellation noise the
  JAX package puts at ~1e-4 m^2, summed in another order. The weights and
  three_interpolate, given the same inputs: rtol 1e-6.
- memory_recon: the port accumulates bf16 products and row sums in f64,
  the JAX package in f32, so the f32 inputs of the bf16 roundings of n and
  dl differ by f32 ulps and an occasional bf16 rounding flips (2^-8 of one
  term). Forward and both gradients: atol 1e-4 of the largest magnitude,
  rtol 2e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hvpr_tpu.ops import memory_recon as jax_recon
from hvpr_tpu.ops import pn2_select as jax_sel
from hvpr_tpu.ops import pointnet2 as jax_pn2

from hvpr_tpu_torch.ops import memory_recon as port_recon
from hvpr_tpu_torch.ops import pn2_select as port_sel
from hvpr_tpu_torch.ops import pointnet2 as port_pn2


def _cloud(rng, b, n, extent=2.0, invalid=0):
    """(B, N, 3) points over a small box (so radii hit many points), with
    duplicates (exact ties) and the last ``invalid`` points padded."""
    xyz = rng.uniform(-extent, extent, (b, n, 3)).astype(np.float32)
    xyz[:, 5] = xyz[:, 3]                       # an exact duplicate point
    mask = np.ones((b, n), bool)
    if invalid:
        mask[:, -invalid:] = False
    return xyz, mask


@pytest.mark.parametrize('n,s,radius,nsample,invalid', [
    (100, 40, 0.8, 8, 0),         # N < 128: no bucket collisions
    (700, 64, 1.0, 16, 37),       # mod-128 collisions + padded points
    (1000, 50, 0.3, 32, 200),     # sparse hits, many empty slots
])
def test_ball_query_bucket_matches_jax(n, s, radius, nsample, invalid):
    rng = np.random.default_rng(n)
    xyz, mask = _cloud(rng, 2, n, invalid=invalid)
    centres = xyz[:, rng.choice(n - invalid, s, replace=False)]
    centres[0, 0] = [9.0, 9.0, 9.0]             # a centre with no hit
    want_idx, want_cnt = jax_sel.ball_query_bucket_xla(
        radius, nsample, jnp.asarray(xyz), jnp.asarray(centres), jnp.asarray(mask))
    k_idx, k_cnt = jax_sel.ball_query_bucket(
        radius, nsample, jnp.asarray(xyz), jnp.asarray(centres), jnp.asarray(mask),
        interpret=True)
    got_idx, got_cnt = port_sel.ball_query_bucket(
        radius, nsample, torch.from_numpy(xyz), torch.from_numpy(centres),
        torch.from_numpy(mask))
    for idx, cnt in ((want_idx, want_cnt), (k_idx, k_cnt)):
        np.testing.assert_array_equal(got_idx.numpy(), np.asarray(idx))
        np.testing.assert_array_equal(got_cnt.numpy(), np.asarray(cnt))
    assert int(got_cnt.min()) == 0              # the centre with no hit
    # dense radii fill every slot, the sparse one leaves slots to back-fill
    assert (int(got_cnt.max()) == nsample) == (radius > 0.5)


@pytest.mark.parametrize('n,s,radii,nsamples,invalid', [
    (700, 64, (0.3, 1.0), (16, 32), 37),      # hvpr.yaml SA1's nsample, collisions
    (1000, 50, (0.5, 7.0), (16, 128), 200),   # every bucket at the large radius
    (100, 40, (1.2, 0.2), (8, 4), 0),         # N < 128, the small radius second
])
def test_ball_query_two_radii_matches_jax(n, s, radii, nsamples, invalid):
    """Both radii of a multi-scale level in one call (one sweep of K4 on the
    card) against two calls of the JAX package's ball_query_bucket_xla, and
    the model's ball_query_msg against JAX's ball_query per radius."""
    rng = np.random.default_rng(n + 1)
    xyz, mask = _cloud(rng, 2, n, invalid=invalid)
    centres = xyz[:, rng.choice(n - invalid, s, replace=False)]
    centres[0, 0] = [9.0, 9.0, 9.0]             # a centre with no hit
    args = (torch.from_numpy(xyz), torch.from_numpy(centres), torch.from_numpy(mask))
    got = port_sel.ball_query_bucket2(radii, nsamples, *args)
    msg = port_pn2.ball_query_msg(radii, nsamples, *args)
    for (idx, cnt), (midx, mcnt), r, ns in zip(got, msg, radii, nsamples):
        want_idx, want_cnt = jax_sel.ball_query_bucket_xla(
            r, ns, jnp.asarray(xyz), jnp.asarray(centres), jnp.asarray(mask))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(want_cnt))
        assert midx.dtype == torch.int64
        np.testing.assert_array_equal(midx.numpy(), np.asarray(want_idx))
        np.testing.assert_array_equal(mcnt.numpy(), np.asarray(want_cnt))
        assert int(cnt[0, 0]) == 0
    # the larger radius fills its slots at some centre
    large = int(np.argmax(radii))
    assert int(got[large][1].max()) == nsamples[large]


@pytest.mark.parametrize('semantics', ['first', 'bucket'])
def test_ball_query_semantics_match_jax(semantics):
    rng = np.random.default_rng(7)
    xyz, mask = _cloud(rng, 2, 300, invalid=20)
    centres = xyz[:, :30]
    want = jax_pn2.ball_query(0.9, 8, jnp.asarray(xyz), jnp.asarray(centres),
                              jnp.asarray(mask), semantics=semantics)
    got = port_pn2.ball_query(0.9, 8, torch.from_numpy(xyz),
                              torch.from_numpy(centres), torch.from_numpy(mask),
                              semantics=semantics)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize('r,l,nsamp,empty_set', [(6, 64, 16, True), (3, 200, 50, False)])
def test_fps_chunks_matches_pallas_kernel(r, l, nsamp, empty_set):
    rng = np.random.default_rng(l)
    pts = rng.normal(size=(r, l, 3)).astype(np.float32)
    pts[:, 7] = pts[:, 2]                       # exact tie in distance
    valid = rng.uniform(size=(r, l)) > 0.2
    if empty_set:
        valid[1] = False                        # no valid row: starts at L-1
    want = jax_sel.fps_chunks_pallas(jnp.asarray(pts), jnp.asarray(valid), nsamp,
                                     interpret=True)
    got = port_sel.fps_chunks(torch.from_numpy(pts), torch.from_numpy(valid), nsamp)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('num_chunks,npoint', [(4, 64), (1, 48)])
def test_furthest_point_sample_matches_jax(num_chunks, npoint):
    rng = np.random.default_rng(num_chunks)
    xyz = rng.uniform(-20, 20, (2, 512, 3)).astype(np.float32)
    mask = np.ones((2, 512), bool)
    mask[1, 300:] = False                       # tail chunks hold no valid point
    want = jax_pn2.furthest_point_sample(jnp.asarray(xyz), jnp.asarray(mask),
                                         npoint, num_chunks=num_chunks)
    got = port_pn2.furthest_point_sample(torch.from_numpy(xyz),
                                         torch.from_numpy(mask), npoint,
                                         num_chunks=num_chunks)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('invalid', ['tail', 'scattered'])
def test_exact_fps_over_a_whole_scan_matches_jax(invalid):
    """Exact FPS (num_chunks=1) over one 16,384-point scan: a single set
    twice as long as K5's one-block path holds (the card takes K5's long
    path), with a duplicated point and invalid points, against the JAX
    package's exact ``_fps_one``."""
    rng = np.random.default_rng(16384)
    n = 16384
    xyz = rng.uniform(-40, 40, (1, n, 3)).astype(np.float32)
    xyz[0, 9] = xyz[0, 4]                       # a duplicated point
    mask = np.ones((1, n), bool)
    if invalid == 'tail':
        mask[0, -1000:] = False                 # padded scan
    else:
        mask[0, rng.choice(n, 3000, replace=False)] = False
        mask[0, :3] = False                     # the first valid row is 3
        mask[0, 3] = True
    want = jax_pn2.furthest_point_sample(jnp.asarray(xyz), jnp.asarray(mask), 256,
                                         num_chunks=1)
    got = port_pn2.furthest_point_sample(torch.from_numpy(xyz), torch.from_numpy(mask),
                                         256, num_chunks=1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert mask[0, got.numpy()].all() and len(set(got[0].tolist())) == 256
    assert int(got[0, 0]) == (0 if invalid == 'tail' else 3)


def test_three_nn_and_interpolate_match_jax():
    rng = np.random.default_rng(3)
    unknown = rng.uniform(0, 40, (2, 300, 3)).astype(np.float32)
    known = rng.uniform(0, 40, (2, 80, 3)).astype(np.float32)
    kmask = np.ones((2, 80), bool)
    kmask[1, 60:] = False
    feats = rng.normal(size=(2, 80, 16)).astype(np.float32)
    jd, ji = jax_pn2.three_nn(jnp.asarray(unknown), jnp.asarray(known), jnp.asarray(kmask))
    td, ti = port_pn2.three_nn(torch.from_numpy(unknown), torch.from_numpy(known),
                               torch.from_numpy(kmask))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy() ** 2, np.asarray(jd) ** 2, rtol=1e-5,
                               atol=1e-3)
    jw = jax_pn2.three_nn_interpolate_weights(jd)
    tw = port_pn2.three_nn_interpolate_weights(torch.from_numpy(np.asarray(jd)))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-7)
    jout = jax_pn2.three_interpolate(jnp.asarray(feats), ji, jw)
    tout = port_pn2.three_interpolate(torch.from_numpy(feats), ti,
                                      torch.from_numpy(np.asarray(jw)))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-6, atol=1e-6)


def _close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-4 * np.abs(want).max(),
                               err_msg=what)


@pytest.mark.parametrize('lam', [0.0, 0.0025])
def test_memory_recon_forward_and_grads_match_jax(lam):
    rng = np.random.default_rng(int(lam * 1e4))
    r, m, c = 300, 200, 32                      # 300 rows: not a multiple of the blocks
    x = rng.normal(size=(r, c)).astype(np.float32)
    w = (rng.uniform(-1, 1, (m, c)) / c ** 0.5 * 6).astype(np.float32)
    dy = rng.normal(size=(r, c)).astype(np.float32)

    def jloss(xx, ww):
        y = jax_recon.memory_recon(xx, ww, shrink_thres=lam, block_rows=128,
                                   bwd_block_rows=64, interpret=True)
        return (y * dy).sum(), y

    (_, jy), (jdx, jdw) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    ty = port_recon.memory_recon(tx, tw, shrink_thres=lam)
    (ty * torch.from_numpy(dy)).sum().backward()
    _close(ty.detach().numpy(), jy, 'forward')
    _close(tx.grad.numpy(), jdx, 'dx')
    _close(tw.grad.numpy(), jdw, 'dW')
    if lam > 0:         # the shrink is live: some attention weights are cut
        a = torch.softmax(torch.from_numpy(x) @ torch.from_numpy(w).t(), -1)
        assert bool((a < lam).any()) and bool((a > lam).any())


def test_memory_recon_plain_backward_matches_jax_grad_of_reference():
    """The plain backward's hand-derived formulas against ``jax.grad`` of
    the differentiable XLA reference (autodiff, not the Pallas VJP). That
    autodiff emits dx and dW from transposed bf16 products in bf16, so the
    tolerance is bf16's: rtol and atol 8e-3 (2^-7) of the largest value."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(64, 16)).astype(np.float32)
    w = (rng.uniform(-1, 1, (40, 16)) * 1.5).astype(np.float32)
    dy = rng.normal(size=(64, 16)).astype(np.float32)
    jdx, jdw = jax.grad(lambda a, b: (jax_recon.memory_recon(a, b, shrink_thres=0.0025)
                                      * dy).sum(), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    dx, dw = port_recon.recon_backward_plain(torch.from_numpy(x), torch.from_numpy(w),
                                             torch.from_numpy(dy), 0.0025)
    for got, want in ((dx, jdx), (dw, jdw)):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.numpy(), want, rtol=8e-3,
                                   atol=8e-3 * np.abs(want).max())
