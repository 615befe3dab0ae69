"""Plain PyTorch reference of HVPR's inference path, one scan at a time: the
reference that ``configs/hvpr.json`` names (``"reference": "model"``).

Written from the configuration alone (``MixAnchor_Memory``: PillarVFE_Scale,
the attentive memory, the scale-aware BEV backbone with CBAM gates, the
anchor head). Another pillar detector's reference subclasses
:class:`Reference` and gives its own ``MODEL_NAME``, ``check_stated`` and
``bev``; voxelization, the pillar layers, the canvas, the head and the
decode are shared. It imports nothing of the program: it voxelizes the raw
points itself (a padded (pillars, points, 4) layout in numpy), and takes the
weights by their state-dict names. Everything runs in float32 with TF32
off, as the configuration states: the memory lookup takes the exact top-k
of each pillar's logits and a softmax over those k (TOPK_MODE 'exact', the
source's lookup). A configuration that states another precision or lookup
is refused, since the control below would not be the step beneath it.

``lowp=True`` makes the control: every stage computed in the nearest
precision below the configuration's float32, bfloat16: each stage's inputs
and weights are rounded to bfloat16, and so are the decoded residuals.
"""

import contextlib
import math

import numpy as np
import torch
from torch.nn import functional as F

BN_EPS = 1e-3


@contextlib.contextmanager
def exact_f32():
    """TF32 off for matmuls and convolutions inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _bf16(x):
    return x.to(torch.bfloat16).float()


def stated_f32(model):
    """Refuses a configuration that states anything but float32."""
    dtypes = [model[s].get('COMPUTE_DTYPE', 'fp32') for s in ('BACKBONE_2D', 'DENSE_HEAD')]
    dtypes.append(model['MAP_TO_BEV'].get('CANVAS_DTYPE', 'fp32'))
    if any(str(d).lower() not in ('fp32', 'float32') for d in dtypes):
        raise ValueError(f'the reference computes float32 only; the configuration states {dtypes}')


def voxelize(points, pcr, voxel_size, grid, max_voxels, max_points):
    """(N, 4) f32 points -> pillars in linear cell order, the first
    ``max_voxels``, each with its first ``max_points`` points in input
    order: voxels (V, P, 4), counts (V,), cells (V, 2) as (y, x)."""
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
    cells = np.stack([(uniq[:v] // nx) % ny, uniq[:v] % nx], axis=1)
    return voxels, num, cells


def point_and_pillar_counts(points, pcr, voxel_size, grid, max_voxels, max_points):
    """(kept points, pillars) of one scan under :func:`voxelize`."""
    _, num, _ = voxelize(points, pcr, voxel_size, grid, max_voxels, max_points)
    return int(num.sum()), int(num.shape[0])


def make_anchors(head_cfg, grid, pcr):
    """(A, 7) anchors flattened in (y, x, class, size, rotation) order."""
    out = []
    for c in head_cfg['ANCHOR_GENERATOR_CONFIG']:
        stride = c['feature_map_stride']
        fx, fy = int(grid[0]) // stride, int(grid[1]) // stride
        if c.get('align_center', False):
            xs_, ys_ = (pcr[3] - pcr[0]) / fx, (pcr[4] - pcr[1]) / fy
            xo, yo = xs_ / 2, ys_ / 2
        else:
            xs_, ys_ = (pcr[3] - pcr[0]) / (fx - 1), (pcr[4] - pcr[1]) / (fy - 1)
            xo = yo = 0
        xs = np.arange(pcr[0] + xo, pcr[3] + 1e-5, xs_, dtype=np.float32)
        ys = np.arange(pcr[1] + yo, pcr[4] + 1e-5, ys_, dtype=np.float32)
        sizes = np.asarray(c['anchor_sizes'], np.float32)
        rots = np.asarray(c['anchor_rotations'], np.float32)
        zs = np.asarray(c['anchor_bottom_heights'], np.float32)
        a = np.zeros((len(zs), len(ys), len(xs), len(sizes), len(rots), 7), np.float32)
        a[..., 0] = xs[None, None, :, None, None]
        a[..., 1] = ys[None, :, None, None, None]
        a[..., 2] = zs[:, None, None, None, None]
        a[..., 3:6] = sizes[None, None, None, :, None, :]
        a[..., 6] = rots[None, None, None, None, :]
        a[..., 2] += a[..., 5] / 2
        out.append(a.reshape(len(zs) * len(ys) * len(xs), -1, 7))
    return np.concatenate(out, axis=1).reshape(-1, 7)


def decode(res, anchors):
    """Residuals (A, 7) on anchors (A, 7) -> boxes (A, 7), heading raw."""
    xa, ya, za, dxa, dya, dza, ra = anchors.unbind(-1)
    diag = torch.sqrt(dxa ** 2 + dya ** 2)
    return torch.stack([res[:, 0] * diag + xa, res[:, 1] * diag + ya, res[:, 2] * dza + za,
                        torch.exp(res[:, 3]) * dxa, torch.exp(res[:, 4]) * dya,
                        torch.exp(res[:, 5]) * dza, res[:, 6] + ra], dim=-1)


def encode(boxes, anchors):
    """Inverse of :func:`decode` on columns 0-5 (the heading is left out)."""
    xa, ya, za, dxa, dya, dza, _ = anchors.unbind(-1)
    diag = torch.sqrt(dxa ** 2 + dya ** 2)
    return torch.stack([(boxes[:, 0] - xa) / diag, (boxes[:, 1] - ya) / diag,
                        (boxes[:, 2] - za) / dza, torch.log(boxes[:, 3] / dxa),
                        torch.log(boxes[:, 4] / dya), torch.log(boxes[:, 5] / dza)], dim=-1)


class Reference:
    """The inference path of one configuration with the given weights
    ({state-dict name: tensor}), on ``device``."""

    MODEL_NAME = 'MixAnchor_Memory'

    def __init__(self, cfg, weights, device, lowp=False):
        self.cfg = cfg
        self.model = cfg['MODEL']
        self.device = torch.device(device)
        self.w = {k: v.to(self.device, torch.float32) for k, v in weights.items()}
        self.lowp = lowp
        data = cfg['DATA_CONFIG']
        self.pcr = [float(v) for v in data['POINT_CLOUD_RANGE']]
        vox = {p['NAME']: p for p in data['DATA_PROCESSOR']}['transform_points_to_voxels']
        self.voxel_size = [float(v) for v in vox['VOXEL_SIZE']]
        self.grid = [int(round((self.pcr[i + 3] - self.pcr[i]) / self.voxel_size[i]))
                     for i in range(3)]
        self.max_points = int(vox['MAX_POINTS_PER_VOXEL'])
        self.max_voxels = int(vox['MAX_NUMBER_OF_VOXELS']['test'])
        if self.model['NAME'] != self.MODEL_NAME:
            raise ValueError(f'the reference is {self.MODEL_NAME}\'s; the configuration runs '
                             f'{self.model["NAME"]}')
        self.check_stated()
        head = self.model['DENSE_HEAD']
        self.anchors = torch.from_numpy(make_anchors(head, self.grid, self.pcr)).to(self.device)
        self.num_dir_bins = int(head['NUM_DIR_BINS'])

    def check_stated(self):
        """Refuses a configuration that states anything but float32 and the
        exact top-k."""
        stated_f32(self.model)
        mode = str(self.model['MAP_TO_BEV'].get('TOPK_MODE', 'fused')).lower()
        if mode != 'exact':
            raise ValueError(f'the reference takes the exact top-k; TOPK_MODE is {mode!r}')

    def q(self, x):
        """``x`` as a stage computes it: itself, or in the control rounded to
        bfloat16."""
        return _bf16(x) if self.lowp else x

    # ----------------------------------------------------------------- layers

    def _bn(self, x, key, dims):
        w = self.w
        shape = (-1,) + (1,) * dims
        inv = torch.rsqrt(w[f'{key}.running_var'] + BN_EPS)
        return ((x - w[f'{key}.running_mean'].reshape(shape)) * (inv * w[f'{key}.weight']).reshape(shape)
                + w[f'{key}.bias'].reshape(shape))

    def _linear(self, x, key):
        return self.q(x) @ self.q(self.w[key]).t()

    def _conv(self, x, key, stride=1, padding=1):
        return F.conv2d(self.q(x), self.q(self.w[key]), stride=stride,
                        padding=padding)

    def _conv_bn_relu(self, x, conv, bn, stride=1):
        return torch.relu(self._bn(self._conv(x, conv, stride), bn, 2))

    def _deconv_bn_relu(self, x, conv, bn, stride):
        y = F.conv_transpose2d(self.q(x), self.q(self.w[conv]),
                               stride=stride)
        return torch.relu(self._bn(y, bn, 2))

    # ------------------------------------------------------------------ stages

    def pfn(self, voxels, num, cells):
        """Pillar features (V, C): the pillar VFE's point layers, each a
        linear, BatchNorm and ReLU, and the max over a pillar's points."""
        cfg = self.model['VFE']
        v, p, _ = voxels.shape
        mask = torch.arange(p, device=self.device)[None, :] < num[:, None]       # (V, P)
        xyz = voxels[..., :3]
        cnt = num.clamp(min=1).float()[:, None]
        mean = xyz.sum(dim=1) / cnt                                               # (V, 3)
        vsz = torch.tensor(self.voxel_size, device=self.device)
        origin = torch.tensor(self.pcr[:3], device=self.device)
        cell_xyz = torch.stack([cells[:, 1], cells[:, 0], torch.zeros_like(cells[:, 0])],
                               dim=1).float()
        centre = cell_xyz * vsz + vsz / 2 + origin
        parts = [voxels if cfg.get('USE_ABSLOTE_XYZ', True) else voxels[..., 3:],
                 xyz - mean[:, None], xyz - centre[:, None]]
        if cfg.get('WITH_DISTANCE', False):
            parts.append(torch.linalg.norm(xyz, dim=-1, keepdim=True))
        x = torch.cat(parts, dim=-1) * mask[..., None]                            # (V, P, 10)
        filters = list(cfg['NUM_FILTERS'])
        for i in range(len(filters)):
            key = f'vfe.pfn_layers.{i}'
            y = torch.relu(self._bn(self._linear(x, f'{key}.linear.weight')
                                    .reshape(v * p, -1).t(), f'{key}.norm', 1).t()
                           ).reshape(v, p, -1)
            y_max = torch.where(mask[..., None], y, -math.inf).amax(dim=1)       # (V, C)
            if i == len(filters) - 1:
                x = y_max
            else:
                x = torch.cat([y * mask[..., None],
                               y_max[:, None].expand_as(y) * mask[..., None]], dim=-1)
        return x

    def scale(self, voxels, num):
        """Scale features (V, C_s) of PillarVFE_Scale: a pillar's point
        count, its mean's range and the mean, through the scale layers."""
        mean = voxels[..., :3].sum(dim=1) / num.clamp(min=1).float()[:, None]
        s = torch.cat([num.float()[:, None], torch.linalg.norm(mean, dim=1, keepdim=True),
                       mean], dim=1)                                              # (V, 5)
        for i in range(len(self.model['VFE']['NUM_SCALE_FEATURES'])):
            key = f'vfe.pfn_scale_layers.{i}'
            s = torch.relu(self._bn(self._linear(s, f'{key}.0.weight').t(),
                                    f'{key}.1', 1).t())
        return s

    def memory(self, pillars):
        """The memory's reconstruction of (V, C) pillars: each pillar's k
        largest logits against the (M, C) memory, a softmax over those k,
        and the weighted sum of their memory rows."""
        k = int(self.model['MAP_TO_BEV']['NUM_K'])
        mem = self.q(self.w['map_to_bev_module.memory.weight'])
        vals, idx = torch.topk(self.q(pillars) @ mem.t(), k, dim=-1)             # (V, k)
        wts = self.q(torch.softmax(vals, dim=-1))
        return (wts[..., None] * mem[idx]).sum(dim=1)

    def canvas(self, feats, cells):
        c = feats.shape[1]
        nx, ny = self.grid[0], self.grid[1]
        out = torch.zeros(c, ny * nx, device=self.device)
        out[:, cells[:, 0] * nx + cells[:, 1]] = self.q(feats).t()
        return out.reshape(1, c, ny, nx)

    def backbone(self, x, y):
        """The BEV backbone on the (1, C, H, W) canvas ``x`` with the scale
        stream ``y`` gating its SFM rounds."""
        cfg = self.model['BACKBONE_2D']
        ups = []
        for i, n in enumerate(cfg['LAYER_NUMS']):
            s = int(cfg['LAYER_STRIDES'][i])
            x = self._conv_bn_relu(x, f'backbone_2d.blocks.{i}.1.weight',
                                   f'backbone_2d.blocks.{i}.2', s)
            for j in range(n):
                x = self._conv_bn_relu(x, f'backbone_2d.blocks.{i}.{4 + 3 * j}.weight',
                                       f'backbone_2d.blocks.{i}.{5 + 3 * j}')
            y = self._conv_bn_relu(y, f'backbone_2d.scale_layers.{i}.1.weight',
                                   f'backbone_2d.scale_layers.{i}.2', s)
            gate = torch.sigmoid(self._bn(F.conv2d(
                self.q(torch.cat([y.amax(dim=1, keepdim=True), y.mean(dim=1, keepdim=True)],
                                 dim=1)),
                self.q(self.w['backbone_2d.attention.spatial.conv.weight']),
                self.w['backbone_2d.attention.spatial.conv.bias'], padding=1),
                'backbone_2d.attention.spatial.norm', 2))
            level = x           # the SFM rounds feed the upsampling, not the next level
            for _ in range(int(cfg['SFM_LAYER_NUMS'][i])):
                level = gate * self._conv_bn_relu(
                    level, f'backbone_2d.sfmblocks_down.{i}.0.weight',
                    f'backbone_2d.sfmblocks_down.{i}.1') + level
            ups.append(self._deconv_bn_relu(level, f'backbone_2d.deblocks.{i}.0.weight',
                                            f'backbone_2d.deblocks.{i}.1',
                                            int(cfg['UPSAMPLE_STRIDES'][i])))
        return torch.cat(ups, dim=1)

    def bev(self, voxels, num, cells):
        """The (1, C, H, W) map the head reads: the pillars and their
        memory reconstruction on the canvas, through the backbone gated by
        the scale stream."""
        pillars = self.pfn(voxels, num, cells)
        scale = self.scale(voxels, num)
        feats = torch.cat([pillars, self.memory(pillars)], dim=1)
        return self.backbone(self.canvas(feats, cells), self.canvas(scale, cells))

    def head(self, feat):
        """(1, C, H, W) -> cls logits (A, classes), residuals (A, 7), dir
        logits (A, bins), per anchor in (y, x, anchor) order."""
        c = feat.shape[1]
        flat = self.q(feat[0].reshape(c, -1).t())                         # (HW, C)
        outs = []
        for name in ('conv_cls', 'conv_box', 'conv_dir_cls'):
            w = self.q(self.w[f'dense_head.{name}.weight'][:, :, 0, 0])
            outs.append(flat @ w.t() + self.w[f'dense_head.{name}.bias'])
        a = self.anchors.shape[0]
        return outs[0].reshape(a, -1), outs[1].reshape(a, -1), outs[2].reshape(a, -1)

    # ----------------------------------------------------------------- a scan

    def forward(self, points):
        """One scan's (N, 4) points -> dict of cls (A, classes), res (A, 7),
        boxes (A, 7) decoded with the direction bins, dir_labels (A,)."""
        with exact_f32(), torch.no_grad():
            voxels, num, cells = voxelize(points, self.pcr, self.voxel_size, self.grid,
                                          self.max_voxels, self.max_points)
            voxels = torch.from_numpy(voxels).to(self.device)
            num = torch.from_numpy(num).to(self.device)
            cells = torch.from_numpy(cells).to(self.device)
            cls, res, dir_logits = self.head(self.bev(voxels, num, cells))
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
