"""The port's bucketed 3-NN (kernel K11's plain version) against the JAX
package's ``three_nn_bucket`` on the CPU.

The JAX side runs its Pallas sweep in interpret mode, as its own tests do;
the port's wrapper takes its plain version because the tensors lie on the
CPU. Inputs come from numpy with a fixed seed. Indices must be equal.
Distances are held to 1e-6 relative: the port computes
``(dx*dx + dy*dy) + dz*dz`` in f32 with every operation rounded, while XLA's
CPU interpret path contracts some of these products into FMAs (observed: about
one distance in ten then differs by 1 f32 ulp, at most 1.2e-7 relative). The
CUDA kernel follows the port's order and equals the plain version bit for bit
on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hvpr_tpu.ops.pn2_select import three_nn_bucket as jax_three_nn_bucket

from hvpr_tpu_torch.ops import _kernels
from hvpr_tpu_torch.ops.pn2_select import three_nn_bucket


def _compare(unknown, known, mask):
    want_d, want_i = jax_three_nn_bucket(jnp.asarray(unknown), jnp.asarray(known),
                                         jnp.asarray(mask), interpret=True)
    before = _kernels.launch_counts()['three_nn_bucket']
    got_d, got_i = three_nn_bucket(torch.from_numpy(unknown), torch.from_numpy(known),
                                   torch.from_numpy(mask))
    assert _kernels.launch_counts()['three_nn_bucket'] == before   # plain on the CPU
    assert got_i.dtype == torch.int32 and got_d.dtype == torch.float32
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-6, atol=0)
    return got_d.numpy(), got_i.numpy()


def _points(rng, b, n, scale=4.0):
    return rng.uniform(-scale, scale, (b, n, 3)).astype(np.float32)


CASES = ('exact', 'collisions', 'masked', 'all_masked_bucket', 'no_valid_point',
         'empty_buckets', 'duplicates')


@pytest.mark.parametrize('case', CASES)
def test_three_nn_bucket_matches_jax(case):
    rng = np.random.default_rng(CASES.index(case))
    b, q, s = {'exact': (2, 200, 128), 'collisions': (2, 256, 700),
               'empty_buckets': (2, 96, 5)}.get(case, (2, 128, 400))
    unknown, known = _points(rng, b, q), _points(rng, b, s)
    mask = np.ones((b, s), bool)
    if case == 'masked':
        mask = rng.uniform(size=(b, s)) > 0.3
    elif case == 'no_valid_point':
        mask[1] = False
    elif case == 'all_masked_bucket':
        # only buckets 7 and 9 hold valid points: the third neighbour is the
        # lowest all-masked bucket, 0, reported as index 0 at distance 1e5
        mask[0] = False
        mask[0, [7, 135, 263, 9]] = True
    elif case == 'duplicates':
        known[0, 128:256] = known[0, 0:128]        # same bucket, higher index
        known[0, 1] = known[0, 0]                  # two buckets, one distance
        unknown[0, :8] = known[0, :8]              # distance 0
    dist, idx = _compare(unknown, known, mask)
    if case == 'exact':
        # S <= 128: one point a bucket, so the bucket 3-NN is the exact 3-NN
        d2 = ((unknown[:, :, None] - known[:, None]) ** 2).sum(-1)
        np.testing.assert_array_equal(np.sort(idx, -1),
                                      np.sort(np.argsort(d2, -1, kind='stable')[..., :3], -1))
    elif case == 'all_masked_bucket':
        assert (idx[0, :, 2] == 0).all() and (dist[0, :, 2] == np.float32(1e5)).all()
        assert set(np.unique(idx[0, :, :2])) <= {7, 135, 263, 9}
    elif case == 'no_valid_point':
        # every neighbour is index 0 at the capped distance sqrt(1e10)
        assert (idx[1] == 0).all() and (dist[1] == np.float32(1e5)).all()
    elif case == 'empty_buckets':
        # 5 valid points, 123 empty buckets: three distinct real neighbours
        assert (np.sort(idx, -1)[..., 1:] != np.sort(idx, -1)[..., :-1]).all()
        assert (dist < np.float32(1e5)).all()
    elif case == 'duplicates':
        assert not ((idx[0] >= 128) & (idx[0] < 256)).any()   # the lower index wins
        assert (idx[0, 0, :2] == [0, 1]).all() and (dist[0, 0, :2] == 0).all()

