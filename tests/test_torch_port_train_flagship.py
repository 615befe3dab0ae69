"""One train step of the port against the JAX package on hvpr.yaml's MODEL
at full widths (point stream 4096/1024 with FPS_CHUNKS 16, VFE 32/64,
memory M=2000 C=64 k=20, backbone 128/256/512), batch 1 on the 5.12 m
cropped range of ``cropped_flagship_cfg``, all in fp32 (the point stream's
COMPUTE_DTYPE too), TRAIN_ATTEND_MODE gather and BALL_QUERY bucket.

Tolerances: the loss terms rtol 1e-3, the gradient norm rtol 2e-3, the
running statistics rtol 1e-3 with atol 1e-3 of the largest value, and 95%
of the updated parameters within 0.1 lr. At these widths the forward holds
three selections that an f32 rounding can flip: the 3-NN of the feature
propagation (matmul-form distances, ~1e-4 m^2 of summation-order noise
against ~1e-2 m^2 neighbour distances), the pillars' top-20 points, and the
hard shrink of the 2000-slot memory (softmax weights ~5e-4 against
lambda 2.5e-3, where the shrink jumps from 0 to a). The point features then
differ by ~1e-4 of their range, the memory features by up to 10%, the
gradients of the BEV backbone by up to 8% (in norm), the gradient norm by
~7e-4 and the running means of the memory map's BN by up to 2e-5 on values
~0.1 (measured). Adam's first step is sign(g) lr where |g| >> eps, so the
updates agree but where |g| is near eps = 1e-8: there an 8% change of g
moves the update by a few hundredths of lr, and where g is rounding noise
its sign may flip (measured: 4.2% of the weights differ by more than 1e-6
relative, 1.65% by more than 0.1 lr). The mini-config tests hold the
gradients leaf by leaf, where none of these selections sits near a tie.
"""

from test_torch_port_train_step import TrainPair, check_steps, train_cfg
from torch_port_helpers import cropped_flagship_cfg


def test_flagship_widths_one_train_step_matches_jax():
    cfg = cropped_flagship_cfg('fp32')
    cfg.MODEL.BACKBONE_3D.COMPUTE_DTYPE = 'fp32'
    cfg = train_cfg(cfg)
    cfg.MODEL.BACKBONE_3D.SA_CONFIG.FPS_CHUNKS = 16
    pair = TrainPair(cfg, batch=1, n_points=8192)
    rtol = dict.fromkeys(('rpn_loss_cls', 'rpn_loss_loc', 'rpn_loss_dir',
                          'rpn_loss_cls_pt', 'rpn_loss_loc_pt', 'rpn_loss_dir_pt',
                          'mem_loss', 'rpn_loss', 'rpn_loss_point', 'loss'), 1e-3)
    rtol['grad_norm'] = 2e-3
    tm = check_steps(pair, 1, first_rtol=rtol, stats_tol=(1e-3, 1e-3),
                     agree_lr_frac=0.1, agree_frac=0.95)
    assert tm[0]['mem_loss'] > 0 and tm[0]['rpn_loss_loc'] > 0
