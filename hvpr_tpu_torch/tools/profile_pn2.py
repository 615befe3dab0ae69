"""Profile of the PointNet++ point stream on the card, primitive by
primitive (port of ``tools/profile_pn2.py``).

    python -m hvpr_tpu_torch.tools.profile_pn2 [--batch 4] [--iters 10]
        [--out FILE] [--device cuda]

hvpr.yaml's BACKBONE_3D (its own seeded initialization, training mode) on
seeded points (normal, std 15 m; 97% valid), the JAX tool's inputs. It
times the first SA level's primitives: FPS (K5, Morton chunks), the ball
query of each radius alone and of both in one sweep (K4, the model's
call), ``group_points`` of its last radius, the first shared MLP on the
grouped offsets and features, and the FP modules' exact 3-NN of every
point among the level's centres; then the whole backbone, forward and
forward + backward (of the sum of its point features). Each row has its
ms, GFLOP, GB and utilization (null on the CPU).
"""

import numpy as np
import torch

from .. import resolve_device
from ..models.backbones_3d.pointnet2_backbone import PointNet2MSG
from ..ops import pointnet2 as pn2
from .profile_stages import (N_POINTS, cli, counted, device_record, load_config,
                             median_ms, region_row)


def run(cfg=None, batch=4, device='cuda', iters=10, n_points=N_POINTS, seed=0):
    """{'batch', 'points', 'stages': rows, ...}."""
    cfg = load_config() if cfg is None else cfg
    device = resolve_device(device)
    record, peaks = device_record(device)
    b3d = cfg.MODEL.BACKBONE_3D
    sa = b3d.SA_CONFIG
    npoint, chunks = int(sa.NPOINTS[0]), int(sa.get('FPS_CHUNKS', 1))
    radii, nsamples = [float(r) for r in sa.RADIUS[0]], [int(n) for n in sa.NSAMPLE[0]]
    rng = np.random.default_rng(seed)
    pts = torch.from_numpy(rng.normal(scale=15.0, size=(batch, n_points, 4))
                           .astype(np.float32)).to(device)
    mask = torch.from_numpy(rng.random((batch, n_points)) < 0.97).to(device)
    xyz = pts[..., :3].contiguous()
    torch.manual_seed(seed)
    net = PointNet2MSG(b3d, pts.shape[-1]).to(device).train()
    level = net.SA_modules[0]
    params = list(net.parameters())

    with torch.no_grad():
        idx = pn2.furthest_point_sample(xyz, mask, npoint, num_chunks=chunks)
        new_xyz = pn2.group_points(xyz, idx)
        new_mask = torch.gather(mask, 1, idx)
        nbr, cnt = pn2.ball_query(radii[-1], nsamples[-1], xyz, new_xyz, mask)
        feat_c = int(sa.MLPS[0][0][-1])
        feats = torch.from_numpy(rng.normal(size=(batch, n_points, feat_c))
                                 .astype(np.float32)).to(device)
        # the first scale's MLP input: offsets and the point features
        nbr0, cnt0 = pn2.ball_query(radii[0], nsamples[0], xyz, new_xyz, mask)
        grouped = pn2.group_points(pts, nbr0)
        mlp_in = torch.cat([grouped[..., :3] - new_xyz[:, :, None, :], grouped[..., 3:]], -1)
        slot_mask = ((torch.arange(nsamples[0], device=device) < cnt0[..., None])
                     & new_mask[..., None])

    def backbone_fwd():
        return net({'points': pts, 'point_valid_mask': mask})['point_features']

    def backbone_grad():
        out = net({'points': pts, 'point_valid_mask': mask})['point_features']
        return torch.autograd.grad(out.sum(), params, allow_unused=True)

    regions = [(f'fps {n_points}->{npoint} ({chunks} chunks)',
                lambda: pn2.furthest_point_sample(xyz, mask, npoint, num_chunks=chunks))]
    for r, ns in zip(radii, nsamples):
        regions.append((f'ball_query r={r} ns={ns} ({n_points}->{npoint})',
                        lambda r=r, ns=ns: pn2.ball_query(r, ns, xyz, new_xyz, mask)))
    regions += [
        (f'ball_query_msg r={tuple(radii)} ns={tuple(nsamples)} (one sweep)',
         lambda: pn2.ball_query_msg(radii, nsamples, xyz, new_xyz, mask)),
        (f'group_points ({npoint}x{nsamples[-1]}, C={feat_c})',
         lambda: pn2.group_points(feats, nbr)),
        (f'shared_mlp ({npoint}x{nsamples[0]}, {mlp_in.shape[-1]}->{level.mlps[0].out_channels})',
         lambda: level.mlps[0](mlp_in, slot_mask)),
        (f'three_nn ({n_points} from {npoint})', lambda: pn2.three_nn(xyz, new_xyz, new_mask)),
        ('backbone fwd', backbone_fwd),
        ('backbone fwd+bwd', backbone_grad),
    ]
    rows = []
    for name, fn in regions:
        with torch.set_grad_enabled(name == 'backbone fwd+bwd'):
            _, c = counted(fn)
            rows.append(region_row(name, median_ms(fn, device, iters), c, peaks))
    return {'batch': batch, 'points': n_points, 'stages': rows, **record}


def main(argv=None):
    return cli(__doc__.splitlines()[0], run, 4, 10, argv)


if __name__ == '__main__':
    main()
