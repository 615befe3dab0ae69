"""The port against the JAX package on hvpr.yaml's MODEL at full channel
widths (VFE 32/64, memory M=2000 C=64 k=20, backbone 128/256/512, the fused
head), batch 1, on a point-cloud range cropped to a 32 x 32 pillar grid so it
runs in seconds on the CPU. The full grid at batch 8 runs in chip_smoke.py.

fp32 (COMPUTE_DTYPE and CANVAS_DTYPE fp32) checks the algorithm: rtol 1e-4
and atol 1e-5 of the largest value where only summation order differs,
atol 1e-3 where the memory lookup's bf16 weights enter. The bf16 settings of
hvpr.yaml are checked once at a looser tolerance: the convs run in bf16
(rounding 2^-8 relative per layer, over ~20 layers, in another order than
XLA's), so rtol 3e-2 and atol 3e-2 of the largest value.
"""

import pytest

from torch_port_helpers import Pair, check_pipeline, check_stage, cropped_flagship_cfg

FP32_TOL = {'vfe': (1e-4, 1e-5), 'map_to_bev': (1e-2, 1e-3),
            'backbone_2d': (1e-4, 1e-5), 'dense_head': (1e-4, 1e-5)}
BF16_TOL = {'vfe': (1e-4, 1e-5), 'map_to_bev': (1e-2, 1e-2),
            'backbone_2d': (3e-2, 3e-2), 'dense_head': (3e-2, 3e-2)}


@pytest.fixture(scope='module', params=['fp32', 'bf16'])
def run(request):
    pair = Pair(cropped_flagship_cfg(request.param), batch=1, n_points=2048)
    jout = pair.jnet.module.apply(pair.jnet.variables, pair.jax_batch(),
                                  train=False)
    return request.param, pair, jout


@pytest.mark.parametrize('stage', list(FP32_TOL))
def test_stage_matches_flax(run, stage):
    compute, pair, jout = run
    tol = (FP32_TOL if compute == 'fp32' else BF16_TOL)[stage]
    check_stage(pair, jout, stage, tol)


def test_pipeline_matches_jax(run):
    compute, pair, _ = run
    n_live, n_kept = check_pipeline(pair, box_tol=1e-4 if compute == 'fp32' else 2e-3)
    assert n_live >= 400 and n_kept > 0       # hundreds of candidates reach NMS
