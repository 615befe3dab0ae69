"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where torch sees no CUDA device (the
kernels have no CPU form). On a machine with a card run them with
``python -m pytest tests/test_torch_port_cuda.py -q``. The kernels repeat
their plain versions' arithmetic in the same order (K1) or with exact f64
accumulation (K2), or copy bytes (K3), so every comparison is exact.
"""

import numpy as np
import pytest
import torch

from hvpr_tpu_torch.ops import _kernels
from hvpr_tpu_torch.ops.bev_canvas import canvas_from_sorted
from hvpr_tpu_torch.ops.memory_lookup import memory_lookup_fused
from hvpr_tpu_torch.ops.segment_sweep import segment_sweep

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device; the kernels have no CPU form')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _both(fn, *args, **kwargs):
    got = fn(*args, **kwargs)
    with _kernels.plain_versions():
        want = fn(*args, **kwargs)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.parametrize('op', ['max', 'sum'])
@pytest.mark.parametrize('c', [4, 64])
def test_segment_sweep_kernel(cuda, op, c):
    rng = np.random.default_rng(c)
    r = 20000
    lengths = rng.integers(1, 33, r)
    slot = np.repeat(np.arange(r), lengths)[:r].astype(np.int32)
    slot[-500:] = r                                          # sentinel tail
    x = rng.normal(size=(c, r)).astype(np.float32)
    x[:, -500:] = -1e9 if op == 'max' else 0.0
    before = _kernels.launch_counts()['segment_sweep']
    got, want = _both(segment_sweep, torch.from_numpy(x).to(cuda),
                      torch.from_numpy(slot).to(cuda), 32, op)
    assert torch.equal(got, want)
    assert _kernels.launch_counts()['segment_sweep'] == before + 1


@pytest.mark.parametrize('m,c,k', [(2000, 64, 20), (64, 32, 4), (300, 16, 128)])
def test_memory_lookup_kernel(cuda, m, c, k):
    rng = np.random.default_rng(m)
    pillars = torch.from_numpy(rng.normal(size=(1000, c)).astype(np.float32)).to(cuda)
    pillars[:3] = 0.0                                        # all-tie rows
    memory = torch.from_numpy((rng.uniform(-1, 1, (m, c)) / c ** 0.5)
                              .astype(np.float32)).to(cuda)
    row_mask = torch.rand(1000, device=cuda) > 0.3
    row_mask[:16] = False                                    # a whole block out
    for mask in (None, row_mask):
        got, want = _both(memory_lookup_fused, pillars, memory, k, mask,
                          return_stats=True)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_bev_canvas_kernel(cuda, dtype):
    rng = np.random.default_rng(0)
    b, v, c, ny, nx = 2, 3000, 32, 60, 70
    feat = torch.from_numpy(rng.normal(size=(b, v, c)).astype(np.float32)).to(cuda)
    coords = torch.zeros(b, v, 3, dtype=torch.int32)
    mask = torch.zeros(b, v, dtype=torch.bool)
    for i, n in enumerate((2900, 10)):
        cells = np.sort(rng.choice(ny * nx, n, replace=False))
        coords[i, :n, 1] = torch.from_numpy(cells // nx)
        coords[i, :n, 2] = torch.from_numpy(cells % nx)
        mask[i, :n] = True
    got, want = _both(canvas_from_sorted, feat, coords.to(cuda), mask.to(cuda),
                      ny, nx, dtype)
    assert got.dtype == dtype and torch.equal(got, want)
