"""The port against the JAX package on hvpr_mini.yaml (f32), stage by stage
and end to end, with the weights carried across by ``from_flax_variables``.

Tolerances (f32 everywhere): the stages repeat the JAX arithmetic and
differ only in summation order (matmuls, convs, segment sums) and libm
ulps, so rtol 1e-4 with atol 1e-5 of the largest value; the memory
reconstruction inside map_to_bev rounds its weights to bf16, where an ulp
flip moves a value by ~2^-8 of one weight (atol 1e-3 of the largest).
"""

import numpy as np
import pytest

from torch_port_helpers import Pair, check_pipeline, check_stage, mini_cfg

TOL = {'vfe': (1e-4, 1e-5), 'map_to_bev': (1e-2, 1e-3),
       'backbone_2d': (1e-4, 1e-5), 'dense_head': (1e-4, 1e-5)}


@pytest.fixture(scope='module')
def pair():
    return Pair(mini_cfg(), batch=2, n_points=256)


@pytest.fixture(scope='module')
def jout(pair):
    return pair.jnet.module.apply(pair.jnet.variables, pair.jax_batch(),
                                  train=False)


@pytest.mark.parametrize('stage', list(TOL))
def test_stage_matches_flax(pair, jout, stage):
    check_stage(pair, jout, stage, TOL[stage])


def test_pipeline_matches_jax_with_recall(pair):
    gt = np.zeros((2, 3, 8), np.float32)
    gt[:, 0] = [10.0, 2.0, -1.0, 3.9, 1.6, 1.56, 0.1, 1]
    gt[:, 1] = [30.0, -5.0, -1.0, 3.9, 1.6, 1.56, 1.5, 1]
    n_live, n_kept = check_pipeline(pair, box_tol=1e-4, gt_boxes=gt)
    assert n_live >= 100 and n_kept > 0


def test_state_dict_keys_are_the_reference_ones(pair):
    keys = set(pair.tnet.module.state_dict())
    for k in ('vfe.pfn_layers.0.linear.weight', 'vfe.pfn_scale_layers.1.1.running_var',
              'map_to_bev_module.memory.weight', 'backbone_2d.blocks.0.4.weight',
              'backbone_2d.scale_layers.1.2.running_mean',
              'backbone_2d.sfmblocks_down.0.1.weight', 'backbone_2d.deblocks.1.0.weight',
              'backbone_2d.attention.spatial.conv.bias', 'dense_head.conv_dir_cls.weight'):
        assert k in keys, k
