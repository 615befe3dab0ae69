"""The port's train path in the shipped mode, TRAIN_ATTEND_MODE fused, against
the JAX package on hvpr_mini.yaml, on the CPU.

The same pair, batch and checks as tests/test_torch_port_train_step.py
(there in gather mode), with the point and memory aggregations through the
bucket threshold and the masked attention (kernels K8-K10's plain versions
in the port, the XLA twin in the JAX package).

Tolerances, where they differ from the gather mode's and why: the
attention rounds its weights and its dval to bf16 on both sides, from f32
sums in the JAX package and f64 sums in the port. Where the two land on
either side of a bf16 rounding boundary an element differs by 2^-8, and
the memory reconstruction's backward spreads a flipped dval over the
point's channels. Measured, leaf by leaf in L2: the point stream 2.5e-3
and the memory 1.8e-3 (tolerance 1e-2), the VFE 5.6e-4 and the BEV
backbone 4.1e-4 (tolerance 2e-3), the heads 8e-6 (1e-4, as in gather
mode); the one step's gradient norm 3.3e-4 (rtol 1e-3).
"""

import pytest

from test_torch_port_train_step import TrainPair, check_gradients, check_steps, train_cfg


@pytest.fixture(scope='module')
def pair():
    cfg = train_cfg()
    cfg.MODEL.MAP_TO_BEV.TRAIN_ATTEND_MODE = 'fused'
    return TrainPair(cfg)


def fused_grad_tol(name):
    if name.startswith(('backbone_3d.', 'map_to_bev_module.memory')):
        return 1e-2
    return 2e-3 if name.startswith(('vfe.', 'backbone_2d.')) else 1e-4


def test_fused_gradients_match_jax_leaf_by_leaf(pair):
    check_gradients(pair, fused_grad_tol)


def test_fused_train_step_matches_jax(pair):
    check_steps(pair, 1, first_rtol={'grad_norm': 1e-3})
