"""PointNet++ MSG point-stream backbone (training only).

Port of ``hvpr_tpu/models/backbones_3d/pointnet2_backbone.py``
(``SharedMLP``, ``SAModuleMSG``, ``FPModule``, ``PointNet2MSG``): set
abstraction levels (FPS, ball query per radius, grouped shared MLP, masked
max-pool) and feature propagation back to every point, on dense (B, N, C)
tensors with validity masks. The HVPR detector runs it only in training.

``COMPUTE_DTYPE: bf16`` runs the shared MLPs in bf16 (f32 accumulation,
f32 params and BN statistics); absolute xyz stays f32 through the gathers
and only the centred offsets are cast. Module keys follow the reference
OpenPCDet ones: ``SA_modules.{i}.mlps.{j}.{3k}`` (1x1 conv weight),
``.{3k+1}`` (BN), and ``FP_modules.{i}.mlp.{3k}``, where ``FP_modules[i]``
takes ``FP_MLPS[i]``.
"""

import torch
from torch import nn

from ...ops import pointnet2 as pn2
from ..model_utils.layers import MaskedBatchNorm, matmul_in


def _dtype_of(name):
    return torch.bfloat16 if str(name).lower() in ('bf16', 'bfloat16') \
        else torch.float32


class Conv1x1T(nn.Module):
    """A bias-free 1x1 conv (weight (out, in, 1, 1), the reference layout)
    applied to channel-major (C_in, R) rows in the input dtype."""

    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 1, 1))
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)

    def forward(self, x_t):
        return matmul_in(x_t.dtype, self.weight[:, :, 0, 0], x_t)


class SharedMLP(nn.Sequential):
    """Per-point [1x1 conv, masked BN, ReLU] stack, channel-major inside."""

    def __init__(self, in_channels, channels, compute_dtype=torch.float32):
        layers = []
        for ch in channels:
            layers += [Conv1x1T(in_channels, ch), MaskedBatchNorm(ch), nn.ReLU()]
            in_channels = ch
        super().__init__(*layers)
        self.compute_dtype = compute_dtype
        self.out_channels = in_channels

    def forward(self, x, mask):
        """(..., C_in) rows and (...) mask -> (..., C_out) in compute dtype."""
        lead = x.shape[:-1]
        x_t = x.reshape(-1, x.shape[-1]).t().to(self.compute_dtype)
        m = mask.reshape(-1)
        layers = list(self)
        for conv, norm, relu in zip(layers[0::3], layers[1::3], layers[2::3]):
            x_t = relu(norm(conv(x_t), m))
        return x_t.t().reshape(*lead, self.out_channels)


class SAModuleMSG(nn.Module):
    """Multi-scale-grouping set abstraction level."""

    def __init__(self, npoint, radii, nsamples, mlps, in_channels, use_xyz=True,
                 fps_chunks=1, ball_query_semantics='auto',
                 compute_dtype=torch.float32):
        super().__init__()
        self.npoint = npoint
        self.radii = list(radii)
        self.nsamples = list(nsamples)
        self.use_xyz = use_xyz
        self.fps_chunks = fps_chunks
        self.semantics = ball_query_semantics
        self.compute_dtype = compute_dtype
        c_in = in_channels + (3 if use_xyz or in_channels == 0 else 0)
        self.mlps = nn.ModuleList(SharedMLP(c_in, mlp, compute_dtype) for mlp in mlps)
        self.out_channels = sum(int(m[-1]) for m in mlps)

    def forward(self, xyz, features, mask):
        """xyz (B, N, 3), features (B, N, C) or None, mask (B, N) ->
        new_xyz (B, S, 3), new_features (B, S, C_out), new_mask (B, S)."""
        idx = pn2.furthest_point_sample(xyz, mask, self.npoint,
                                        num_chunks=self.fps_chunks)      # (B, S)
        new_xyz = pn2.group_points(xyz, idx)
        new_mask = torch.gather(mask, 1, idx)
        cd = self.compute_dtype
        # one gather per scale over [xyz | features]; xyz stays f32, only the
        # radius-bounded offsets are cast
        src = xyz if features is None else torch.cat([xyz, features.float()], dim=-1)
        outs = []
        neighbours = pn2.ball_query_msg(self.radii, self.nsamples, xyz, new_xyz, mask,
                                        semantics=self.semantics)
        for (nbr_idx, cnt), nsample, mlp in zip(neighbours, self.nsamples, self.mlps):
            grouped = pn2.group_points(src, nbr_idx)                      # (B, S, ns, C)
            grouped_xyz = (grouped[..., :3] - new_xyz[:, :, None, :]).to(cd)
            if features is not None:
                grouped_feat = grouped[..., 3:].to(cd)
                if self.use_xyz:
                    grouped_feat = torch.cat([grouped_xyz, grouped_feat], dim=-1)
            else:
                grouped_feat = grouped_xyz
            slot_mask = ((torch.arange(nsample, device=xyz.device) < cnt[..., None])
                         & new_mask[..., None])                           # (B, S, ns)
            x = mlp(grouped_feat, slot_mask)
            x = torch.where(slot_mask[..., None], x, x.new_full((), -1e9))
            x = x.amax(dim=2)
            outs.append(torch.where(x > -1e8, x, x.new_zeros(())))
        return new_xyz, torch.cat(outs, dim=-1), new_mask


class FPModule(nn.Module):
    """Feature propagation: 3-NN inverse-distance interpolation + shared MLP."""

    def __init__(self, in_channels, mlp, compute_dtype=torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.mlp = SharedMLP(in_channels, mlp, compute_dtype)

    def forward(self, unknown_xyz, known_xyz, unknown_feats, known_feats,
                unknown_mask, known_mask):
        cd = self.compute_dtype
        dist, idx = pn2.three_nn(unknown_xyz, known_xyz, known_mask)
        weight = pn2.three_nn_interpolate_weights(dist)    # from detached coordinates
        interpolated = pn2.three_interpolate(known_feats.to(cd), idx, weight.to(cd))
        if unknown_feats is not None:
            interpolated = torch.cat([interpolated, unknown_feats.to(cd)], dim=-1)
        return self.mlp(interpolated, unknown_mask)


class PointNet2MSG(nn.Module):

    def __init__(self, model_cfg, input_channels):
        super().__init__()
        sa = model_cfg['SA_CONFIG']
        cd = _dtype_of(model_cfg.get('COMPUTE_DTYPE', 'fp32'))
        feat_ch = input_channels - 3
        skip = [feat_ch]
        self.SA_modules = nn.ModuleList()
        for k in range(len(sa['NPOINTS'])):
            mod = SAModuleMSG(
                npoint=int(sa['NPOINTS'][k]), radii=list(sa['RADIUS'][k]),
                nsamples=list(sa['NSAMPLE'][k]),
                mlps=[list(m) for m in sa['MLPS'][k]], in_channels=feat_ch,
                use_xyz=sa.get('USE_XYZ', True),
                fps_chunks=int(sa.get('FPS_CHUNKS', 1)),
                ball_query_semantics=str(sa.get('BALL_QUERY', 'auto')),
                compute_dtype=cd)
            self.SA_modules.append(mod)
            feat_ch = mod.out_channels
            skip.append(feat_ch)
        fp_mlps = [list(m) for m in model_cfg['FP_MLPS']]
        self.FP_modules = nn.ModuleList()
        for i, mlp in enumerate(fp_mlps):
            known = fp_mlps[i + 1][-1] if i + 1 < len(fp_mlps) else skip[-1]
            self.FP_modules.append(FPModule(known + skip[i], mlp, cd))
        self.num_point_features = fp_mlps[0][-1]

    def forward(self, batch_dict):
        points = batch_dict['points']
        mask = batch_dict.get('point_valid_mask')
        if mask is None:
            mask = torch.ones(points.shape[:2], dtype=torch.bool, device=points.device)
        xyz = points[..., 0:3].float()
        feats = points[..., 3:] if points.shape[-1] > 3 else None
        l_xyz, l_feats, l_mask = [xyz], [feats], [mask]
        for sa_mod in self.SA_modules:
            nx, nf, nm = sa_mod(l_xyz[-1], l_feats[-1], l_mask[-1])
            l_xyz.append(nx)
            l_feats.append(nf)
            l_mask.append(nm)
        for i in range(len(self.FP_modules) - 1, -1, -1):
            l_feats[i] = self.FP_modules[i](l_xyz[i], l_xyz[i + 1], l_feats[i],
                                            l_feats[i + 1], l_mask[i], l_mask[i + 1])
        batch_dict['point_features'] = l_feats[0].float()
        batch_dict['point_coords'] = l_xyz[0]
        return batch_dict
