"""The frozen scan generator gives, for a seed, the arrays of its source
commit (1380d4cbc8b81ffdba01a8b3179518351fd96dae)."""

import hashlib

import numpy as np
import pytest

from traffic.scans import pool, realistic_scans_with_boxes

PCR = [0, -19.84, -2.5, 47.36, 19.84, 0.5]
# sha256 of realistic_scans_with_boxes(default_rng(seed), 2, 16384, PCR)'s
# points and boxes, taken from hvpr_tpu_torch/utils/scans.py at the commit
DIGESTS = {
    0: 'ef9a8c3ba19e1676d4492c6e40184ee4dc0d6e98fa27484b47edcee6e1d71726',
    2 ** 31 + 11: 'd73f6d99f60d0b8fabe113749a3c269cf8178af23858ccb57ea64b1b21a46bea',
}


def _digest(seed):
    pts, gt = realistic_scans_with_boxes(np.random.default_rng(seed), 2, 16384, PCR)
    return hashlib.sha256(pts.tobytes() + gt.tobytes()).hexdigest()


@pytest.mark.parametrize('seed', sorted(DIGESTS))
def test_frozen_generator_gives_the_source_commits_arrays(seed):
    assert _digest(seed) == DIGESTS[seed]


def test_pool_is_the_generators_draws_in_order():
    traffic = {'generator': 'realistic_scans', 'batch': 2, 'points_per_scan': 16384,
               'pool_batches': 2}
    pts, gt = pool(traffic, 5, PCR)
    want_pts, want_gt = realistic_scans_with_boxes(np.random.default_rng(5), 4, 16384, PCR)
    assert pts.shape == (2, 2, 16384, 4)
    np.testing.assert_array_equal(pts.reshape(4, 16384, 4), want_pts)
    np.testing.assert_array_equal(gt.reshape(4, 49, 8), want_gt)
