"""Plain PyTorch reference of SECOND's inference path, one scan at a time: the
reference that ``configs/second.json`` names (``"reference": "second"``).

Written from the published description (Yan, Mao, Li, SECOND: Sparsely
Embedded Convolutional Detection, Sensors 2018) as OpenPCDet's
``tools/cfgs/kitti_models/second.yaml`` configures it, and from nothing of
the program: MeanVFE, VoxelBackBone8x, HeightCompression, BaseBEVBackbone
and AnchorHeadSingle with the direction bins. The anchors, the head and the
decode are the pillar reference's (:class:`reference.model.Reference`).
Everything runs in float32 with TF32 off (:func:`reference.model.exact_f32`).

- Voxelization, its own and 3-D: the first ``MAX_NUMBER_OF_VOXELS['test']``
  voxels in linear cell order (z, y, x), each with its first
  ``MAX_POINTS_PER_VOXEL`` points in input order (:func:`voxelize3d`).
- MeanVFE: the mean of a voxel's kept points, every feature.
- VoxelBackBone8x on the dense grid, by the definition of its convolutions.
  The grid is upstream's sparse shape, ``grid_size[::-1] + [1, 0, 0]``
  (41 x 1600 x 1408 on KITTI's range): a submanifold conv is a dense
  ``conv3d`` with padding 1, masked to the input's active set; a strided
  sparse conv is a dense strided ``conv3d`` whose active set is the max-pool
  of the input's mask with the same kernel, stride and padding. Each conv is
  followed by BatchNorm (eval, eps 1e-3), ReLU and the mask again. The
  stage convs are (3, 3, 3) / 2 with padding 1, ``conv4``'s padding is (0,
  1, 1), ``conv_out`` is (3, 1, 1) / (2, 1, 1) with padding 0; the widths
  are the weights'. One scan's largest volume is 16 x 41 x 1600 x 1408
  float32 (5.9 GB), which fits the card whole, so no z-slabs are needed.
- HeightCompression: the (C, D, H, W) volume viewed as (C*D, H, W),
  upstream's channel order c*D + d.
- BaseBEVBackbone: per level a conv of the level's stride and LAYER_NUMS
  3x3 convs, each with BatchNorm and ReLU, then a transposed conv of the
  upsample stride; the levels concatenated.

The program's state dict is taken by name; two of its layouts are converted
when the reference takes it:

- a sparse conv's weight is (taps, C_in, C_out) with the taps in (dz, dy,
  dx) raster order, the centred offsets of a submanifold conv or the window
  offsets 0..k-1 of a strided one; tap (i, j, k) reads the cell that
  ``conv3d``'s weight [..., i, j, k] reads, so the weight becomes
  ``w.reshape(kz, ky, kx, C_in, C_out).permute(4, 3, 0, 1, 2)``;
- the program's HeightCompression orders the BEV channels d*C + c, so the
  input channels of the first BEV conv (``backbone_2d.blocks.0.1.weight``)
  are permuted to c*D + d.

``lowp=True`` makes the control: every stage computed in the nearest
precision below the configuration's float32, bfloat16: each stage's inputs
and weights are rounded to bfloat16, and so are the decoded residuals.
``count=True`` records each conv's input-output pairs that hit an active
site and its active output sites, from the masks, in ``conv_counts``.
"""

import math

import numpy as np
import torch
from torch.nn import functional as F

from reference.model import Reference as PillarReference, decode, exact_f32, stated_f32

STAGES = {'VFE': 'MeanVFE', 'BACKBONE_3D': 'VoxelBackBone8x', 'MAP_TO_BEV': 'HeightCompression',
          'BACKBONE_2D': 'BaseBEVBackbone', 'DENSE_HEAD': 'AnchorHeadSingle'}


def voxelize3d(points, pcr, voxel_size, grid, max_voxels, max_points):
    """(N, C) f32 points -> the first ``max_voxels`` voxels in linear cell
    order, each with its first ``max_points`` points in input order:
    voxels (V, P, C), counts (V,), coords (V, 3) as (z, y, x)."""
    pts = np.asarray(points, dtype=np.float32)
    gi = np.floor((pts[:, :3] - np.asarray(pcr[:3], np.float32))
                  / np.asarray(voxel_size, np.float32)).astype(np.int64)
    nx, ny, nz = grid
    ok = ((gi[:, 0] >= 0) & (gi[:, 0] < nx) & (gi[:, 1] >= 0) & (gi[:, 1] < ny)
          & (gi[:, 2] >= 0) & (gi[:, 2] < nz))
    idx = np.nonzero(ok)[0]
    cell = (gi[idx, 2] * ny + gi[idx, 1]) * nx + gi[idx, 0]
    order = np.argsort(cell, kind='stable')
    idx, cell = idx[order], cell[order]
    uniq, start, counts = np.unique(cell, return_index=True, return_counts=True)
    v = min(len(uniq), max_voxels)
    voxels = np.zeros((v, max_points, pts.shape[1]), np.float32)
    num = np.minimum(counts[:v], max_points).astype(np.int64)
    for p in range(max_points):
        has = num > p
        voxels[has, p] = pts[idx[start[:v][has] + p]]
    u = uniq[:v]
    coords = np.stack([u // (ny * nx), (u // nx) % ny, u % nx], axis=1)
    return voxels, num, coords


def backbone_convs(weights):
    """VoxelBackBone8x's convolutions in order: (weight key, BN key,
    kernel, stride, padding, submanifold); the stages' lengths are read
    from the weights' names."""
    out = [('backbone_3d.conv_input.0.weight', 'backbone_3d.conv_input.1',
            (3, 3, 3), 1, 1, True)]
    for stage in ('conv1', 'conv2', 'conv3', 'conv4'):
        j = 0
        while f'backbone_3d.{stage}.{j}.0.weight' in weights:
            strided = stage != 'conv1' and j == 0
            pad = (0, 1, 1) if stage == 'conv4' and strided else 1
            out.append((f'backbone_3d.{stage}.{j}.0.weight', f'backbone_3d.{stage}.{j}.1',
                        (3, 3, 3), 2 if strided else 1, pad, not strided))
            j += 1
    out.append(('backbone_3d.conv_out.0.weight', 'backbone_3d.conv_out.1', (3, 1, 1),
                (2, 1, 1), 0, False))
    return out


class Reference(PillarReference):
    """SECOND's inference path with the given weights ({state-dict name:
    tensor}) on ``device``."""

    MODEL_NAME = 'SECONDNet'

    def __init__(self, cfg, weights, device, lowp=False, count=False):
        super().__init__(cfg, weights, device, lowp=lowp)
        self.conv_counts = [] if count else None
        self.convs = backbone_convs(self.w)
        for key, _, kernel, _, _, _ in self.convs:
            w = self.w[key]
            self.w[key] = w.reshape(*kernel, *w.shape[1:]).permute(4, 3, 0, 1, 2).contiguous()
        # the program's BEV channel d*C + c -> upstream's c*D + d
        c = self.w[self.convs[-1][0]].shape[0]
        first = self.w['backbone_2d.blocks.0.1.weight']
        o, cd = first.shape[:2]
        self.w['backbone_2d.blocks.0.1.weight'] = (
            first.reshape(o, cd // c, c, *first.shape[2:]).transpose(1, 2)
            .reshape(first.shape).contiguous())
        self.sparse_shape = (self.grid[2] + 1, self.grid[1], self.grid[0])

    def check_stated(self):
        """Refuses a configuration that states anything but float32, or
        another module than SECOND's at a stage."""
        stated_f32(self.model)
        for stage, name in STAGES.items():
            if self.model[stage]['NAME'] != name:
                raise ValueError(f'the reference computes {name} at {stage}; the '
                                 f'configuration states {self.model[stage]["NAME"]}')

    # ------------------------------------------------------------------ stages

    def volume(self, voxels, num, coords):
        """MeanVFE's features on the dense grid: (1, C, D, H, W) and the
        active set's (1, 1, D, H, W) float mask."""
        feats = voxels.sum(dim=1) / num.clamp(min=1).float()[:, None]            # (V, C)
        d, h, w = self.sparse_shape
        lin = (coords[:, 0] * h + coords[:, 1]) * w + coords[:, 2]
        x = torch.zeros(feats.shape[1], d * h * w, device=self.device)
        x[:, lin] = feats.t()
        mask = torch.zeros(d * h * w, device=self.device)
        mask[lin] = 1.0
        return x.reshape(1, -1, d, h, w), mask.reshape(1, 1, d, h, w)

    def _count(self, mask, out_mask, kernel, stride, padding):
        """Pairs that hit an active site, and active output sites."""
        ones = torch.ones(1, 1, *kernel, device=self.device)
        hits = F.conv3d(mask, ones, stride=stride, padding=padding)
        self.conv_counts.append((int((hits * out_mask).sum(dtype=torch.float64)),
                                 int(out_mask.sum(dtype=torch.float64))))

    def sparse_conv(self, x, mask, conv):
        """One conv of the backbone with its BatchNorm, ReLU and mask."""
        key, bn, kernel, stride, padding, subm = conv
        y = F.conv3d(self.q(x), self.q(self.w[key]), stride=stride, padding=padding)
        out_mask = mask if subm else F.max_pool3d(mask, kernel, stride, padding)
        if self.conv_counts is not None:
            self._count(mask, out_mask, kernel, stride, padding)
        w = self.w
        shape = (1, -1, 1, 1, 1)
        scale = torch.rsqrt(w[f'{bn}.running_var'] + 1e-3) * w[f'{bn}.weight']
        y.sub_(w[f'{bn}.running_mean'].reshape(shape)).mul_(scale.reshape(shape))
        y.add_(w[f'{bn}.bias'].reshape(shape)).relu_().mul_(out_mask)
        return y, out_mask

    def backbone3d(self, x, mask):
        """VoxelBackBone8x -> HeightCompression: the (1, C*D, H, W) map."""
        for conv in self.convs:
            x, mask = self.sparse_conv(x, mask, conv)
        _, c, d, h, w = x.shape
        return x.reshape(1, c * d, h, w)

    def backbone2d(self, x):
        cfg = self.model['BACKBONE_2D']
        ups = []
        for i, n in enumerate(cfg['LAYER_NUMS']):
            x = self._conv_bn_relu(x, f'backbone_2d.blocks.{i}.1.weight',
                                   f'backbone_2d.blocks.{i}.2', int(cfg['LAYER_STRIDES'][i]))
            for j in range(n):
                x = self._conv_bn_relu(x, f'backbone_2d.blocks.{i}.{4 + 3 * j}.weight',
                                       f'backbone_2d.blocks.{i}.{5 + 3 * j}')
            ups.append(self._deconv_bn_relu(x, f'backbone_2d.deblocks.{i}.0.weight',
                                            f'backbone_2d.deblocks.{i}.1',
                                            int(cfg['UPSAMPLE_STRIDES'][i])))
        return torch.cat(ups, dim=1)

    # ----------------------------------------------------------------- a scan

    def forward(self, points):
        """One scan's (N, 4) points -> dict of cls (A, classes), res (A, 7),
        boxes (A, 7) decoded with the direction bins, dir_labels (A,)."""
        with exact_f32(), torch.no_grad():
            voxels, num, coords = voxelize3d(points, self.pcr, self.voxel_size, self.grid,
                                             self.max_voxels, self.max_points)
            x, mask = self.volume(torch.from_numpy(voxels).to(self.device),
                                  torch.from_numpy(num).to(self.device),
                                  torch.from_numpy(coords).to(self.device))
            bev = self.backbone3d(x, mask)
            del x, mask
            cls, res, dir_logits = self.head(self.backbone2d(bev))
            res = self.q(res)
            boxes = decode(res, self.anchors)
            head = self.model['DENSE_HEAD']
            period = 2 * math.pi / self.num_dir_bins
            labels = dir_logits.argmax(dim=-1)
            off, lim = float(head['DIR_OFFSET']), float(head['DIR_LIMIT_OFFSET'])
            rot = boxes[:, 6] - off
            rot = rot - torch.floor(rot / period + lim) * period
            boxes = torch.cat([boxes[:, :6], (rot + off + period * labels)[:, None]], dim=1)
        return {'cls': cls, 'res': res, 'boxes': boxes, 'dir_labels': labels}
