"""Profile of the dense head's train step on the card: the target assigner,
the head with its losses, the optimizer update (port of
``tools/profile_head.py``).

    python -m hvpr_tpu_torch.tools.profile_head [--batch 4] [--iters 5]
        [--out FILE] [--device cuda]

hvpr.yaml's train network, its own seeded initialization. On seeded BEV
maps of the head's input shape (the backbone's channels at the anchors'
feature-map stride, both the voxel and the point path's) and the gt boxes
of ``realistic_scans_with_boxes`` (49 cars a scan), it times
``assign_targets`` alone; ``head fwd+bwd (dual path)``, the head's forward
with its losses and their gradient to its parameters and both maps;
``head convs only``, the two paths' 1x1 convs; and ``optimizer update``,
the adam_onecycle step of the whole network's parameters on fixed
gradients. Each row has its ms, GFLOP, GB and utilization (null on the
CPU).
"""

import torch

from .. import resolve_device
from ..models.dense_heads.anchor_head_single import class_anchors
from .profile_stages import (N_POINTS, build, cli, counted, device_record, load_config,
                             median_ms, region_row, scans)
from .profile_train_stages import TOTAL_STEPS


def run(cfg=None, batch=4, device='cuda', iters=5, seed=0):
    """{'batch', 'map', 'stages': rows, ...}."""
    cfg = load_config() if cfg is None else cfg
    device = resolve_device(device)
    record, peaks = device_record(device)
    net = build(cfg, device, train=True, seed=seed)
    net.init_training(cfg.OPTIMIZATION, TOTAL_STEPS)
    head = net.module.dense_head
    _, _, gt = scans(net, batch, N_POINTS, seed, device)
    stride = int(cfg.MODEL.DENSE_HEAD.ANCHOR_GENERATOR_CONFIG[0]['feature_map_stride'])
    nx, ny = (int(g) // stride for g in net.dataset.grid_size[:2])
    shape = (batch, ny, nx, net.module.backbone_2d.num_bev_features)
    gen = torch.Generator().manual_seed(seed)
    feat, feat_pt = (torch.randn(shape, generator=gen).to(device).requires_grad_()
                     for _ in range(2))
    head_params = [p for p in head.parameters() if p.requires_grad]
    opt = net.train_state.optimizer
    grads = [torch.randn(p.shape, generator=gen).to(device) * 1e-3 for p in opt.params]

    def assign():
        with torch.no_grad():
            return head.target_assigner.assign_targets(class_anchors(head), gt, global_step=0)

    def head_fwd_bwd():
        out = head({'spatial_features_2d': feat, 'spatial_features_point_2d': feat_pt,
                    'gt_boxes': gt, 'global_step': 0})
        return torch.autograd.grad(out['loss'], head_params + [feat, feat_pt])

    def convs():
        with torch.no_grad():
            return head._heads(feat), head._heads(feat_pt)

    rows = []
    for name, fn in (('assign_targets', assign), ('head fwd+bwd (dual path)', head_fwd_bwd),
                     ('head convs only', convs), ('optimizer update', lambda: opt.step(grads))):
        _, c = counted(fn)
        rows.append(region_row(name, median_ms(fn, device, iters), c, peaks))
    return {'batch': batch, 'map': list(shape), 'gt_boxes': list(gt.shape), 'stages': rows,
            **record}


def main(argv=None):
    return cli(__doc__.splitlines()[0], run, 4, 5, argv)


if __name__ == '__main__':
    main()
