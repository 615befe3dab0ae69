"""The port's sparse 3D convolutions against the JAX package's on the CPU.

Mirrors ``tests/test_sparse_conv.py``: the same random active sites (numpy,
fixed seeds) go through ``hvpr_tpu.ops.sparse_conv`` and
``hvpr_tpu_torch.ops.sparse_conv``. Both are plain array code (XLA in the
JAX package, no TPU kernel). Tolerances: output sites, their order, the
validity masks and ``n_dropped`` exactly equal; features within 1e-5 of the
output's largest magnitude (f32, the per-tap products may sum their C_in
terms in another order); gradients likewise, against ``jax.grad``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hvpr_tpu.ops import sparse_conv as jsc

from hvpr_tpu_torch.ops import _kernels
from hvpr_tpu_torch.ops import sparse_conv as tsc

GRID = (5, 12, 10)  # nz, ny, nx
RTOL = 1e-5


def _random_sites(rng, b, v, n_active, c_in, grid=GRID):
    nz, ny, nx = grid
    feats = rng.normal(size=(b, v, c_in)).astype(np.float32)
    coords = np.zeros((b, v, 3), np.int32)
    valid = np.zeros((b, v), bool)
    for i in range(b):
        cells = np.sort(rng.choice(nz * ny * nx, n_active[i], replace=False))
        coords[i, :n_active[i]] = np.stack([cells // (ny * nx), (cells // nx) % ny,
                                            cells % nx], -1)
        valid[i, :n_active[i]] = True
    feats[~valid] = 0
    return feats, coords, valid


def _close(got, want):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=RTOL * scale)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def test_subm_conv_matches_jax():
    rng = np.random.default_rng(0)
    feats, coords, valid = _random_sites(rng, 2, 64, [50, 37], 4)
    w = rng.normal(size=(27, 4, 6)).astype(np.float32)
    want = jsc.subm_conv3d(jnp.asarray(feats), jnp.asarray(coords), jnp.asarray(valid),
                           jnp.asarray(w), GRID)
    before = _kernels.launch_counts()['gather_grad']
    got = tsc.subm_conv3d(*_t(feats, coords, valid, w), GRID)
    assert _kernels.launch_counts()['gather_grad'] == before
    _close(got.numpy(), want)
    assert (got.numpy()[~valid] == 0).all()


@pytest.mark.parametrize('kernel,stride,padding,max_out', [
    (3, 2, 1, 192),                           # the stage downsample
    ((3, 1, 1), (2, 1, 1), (0, 0, 0), 96),    # conv_out
    (3, 2, 1, 20),                            # a cap that overflows
], ids=['stride2_pad1', 'asymmetric_conv_out', 'overflow'])
def test_sparse_conv_matches_jax(kernel, stride, padding, max_out):
    rng = np.random.default_rng(1)
    feats, coords, valid = _random_sites(rng, 2, 48, [40, 29], 3)
    kvol = int(np.prod(tsc._triple(kernel)))
    w = rng.normal(size=(kvol, 3, 5)).astype(np.float32)
    want = jsc.sparse_conv3d(jnp.asarray(feats), jnp.asarray(coords), jnp.asarray(valid),
                             jnp.asarray(w), GRID, kernel=kernel, stride=stride,
                             padding=padding, max_out=max_out)
    got = tsc.sparse_conv3d(*_t(feats, coords, valid, w), GRID, kernel=kernel,
                            stride=stride, padding=padding, max_out=max_out)
    wf, wc, wm, wd = (np.asarray(x) for x in want)
    gf, gc, gm, gd = (x.numpy() for x in got)
    np.testing.assert_array_equal(gm, wm)
    np.testing.assert_array_equal(gc[gm], wc[wm])
    np.testing.assert_array_equal(gd, wd)
    assert gc.dtype == np.int32 and gd.dtype == np.int32
    _close(gf, wf)
    assert (gf[~gm] == 0).all()
    assert tsc.sparse_conv3d_out_grid(GRID, kernel, stride, padding) == \
        jsc.sparse_conv3d_out_grid(GRID, kernel, stride, padding)
    if max_out == 20:
        assert (gd > 0).all() and gm.all()
    else:
        assert (gd == 0).all()


def test_downsample_alias_matches_jax():
    rng = np.random.default_rng(2)
    feats, coords, valid = _random_sites(rng, 1, 32, [30], 2)
    w = rng.normal(size=(27, 2, 3)).astype(np.float32)
    want = jsc.sparse_conv3d_downsample(jnp.asarray(feats), jnp.asarray(coords),
                                        jnp.asarray(valid), jnp.asarray(w), GRID,
                                        stride=2, max_out=128)
    got = tsc.sparse_conv3d_downsample(*_t(feats, coords, valid, w), GRID, stride=2,
                                       max_out=128)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    _close(got[0].numpy(), want[0])


def test_backward_matches_jax_grad():
    """One backward through subm -> strided -> subm, against jax.grad, for
    the features and every weight."""
    rng = np.random.default_rng(3)
    feats, coords, valid = _random_sites(rng, 2, 40, [33, 21], 3)
    w1 = rng.normal(size=(27, 3, 4)).astype(np.float32)
    w2 = rng.normal(size=(27, 4, 5)).astype(np.float32)
    w3 = rng.normal(size=(27, 5, 2)).astype(np.float32)
    og = jsc.sparse_conv3d_out_grid(GRID, 3, 2, 1)
    probe = rng.normal(size=(2, 64, 2)).astype(np.float32)

    def jax_loss(f, a, b, c):
        x = jsc.subm_conv3d(f, jnp.asarray(coords), jnp.asarray(valid), a, GRID)
        y, yc, ym, _ = jsc.sparse_conv3d(x, jnp.asarray(coords), jnp.asarray(valid), b,
                                         GRID, kernel=3, stride=2, padding=1, max_out=64)
        z = jsc.subm_conv3d(y, yc, ym, c, og)
        return (z * probe).sum()

    want = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (feats, w1, w2, w3)))

    f, a, b, c = (t.requires_grad_() for t in _t(feats, w1, w2, w3))
    ct, vt = _t(coords, valid)
    x = tsc.subm_conv3d(f, ct, vt, a, GRID)
    y, yc, ym, _ = tsc.sparse_conv3d(x, ct, vt, b, GRID, kernel=3, stride=2, padding=1,
                                     max_out=64)
    z = tsc.subm_conv3d(y, yc, ym, c, og)
    (z * torch.from_numpy(probe)).sum().backward()
    for got, w in zip((f, a, b, c), want):
        _close(got.grad.numpy(), w)
