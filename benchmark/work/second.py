"""The work module of SECOND (``"work": "second"``): the dense FLOPs of a
request and the operations and bytes of each sparse convolution.

:func:`batch_flops` counts, for each scan of a request, the sparse convs'
input-output pairs that hit an active site, times C_in x C_out x 2, from
site lists built on the reference's voxelization (:func:`conv_sites`: the
same convs and geometry as :mod:`reference.second`, upstream's), never on
the dense grid; then the BEV backbone and the head, which do not depend on
the scan. MeanVFE has no product. A multiply-add counts 2, an elementwise
op nothing, so it reads the same work whatever implements it.

:func:`conv_work` turns one conv's counted pairs, sites and widths into
operations and bytes, the roofline's inputs (the program's counters
``sparse.pairs`` and ``sparse.sites`` feed it in
``metrics/sparse_conv_roofline.infer.py``). Its bytes count each input
byte read once and each output byte written once: the input sites'
features and (z, y, x) coordinates, the weight, the output sites' features
and coordinates, 4 bytes a value.
"""

import numpy as np

from reference.second import voxelize3d
from work.flops import conv_flops


def _voxel_cfg(cfg):
    data = cfg['DATA_CONFIG']
    pcr = [float(v) for v in data['POINT_CLOUD_RANGE']]
    vox = {p['NAME']: p for p in data['DATA_PROCESSOR']}['transform_points_to_voxels']
    vs = [float(v) for v in vox['VOXEL_SIZE']]
    grid = [int(round((pcr[i + 3] - pcr[i]) / vs[i])) for i in range(3)]
    return pcr, vs, grid, int(vox['MAX_NUMBER_OF_VOXELS']['test']), int(
        vox['MAX_POINTS_PER_VOXEL'])


def conv_specs(cfg):
    """VoxelBackBone8x's convs in order: (kernel, stride, padding,
    submanifold, C_in, C_out), padding per axis, upstream's geometry; the
    widths are the port's (NUM_FILTERS, default [32, 64, 64]; OUT_CHANNELS,
    default 128) from the point features' count."""
    bb = cfg['MODEL']['BACKBONE_3D']
    c = len(cfg['DATA_CONFIG']['POINT_FEATURE_ENCODING']['used_feature_list'])
    subm = ((3, 3, 3), (1, 1, 1), (1, 1, 1), True)
    specs = [(*subm, c, 16), (*subm, 16, 16)]
    c = 16
    for i, ch in enumerate(bb.get('NUM_FILTERS', [32, 64, 64])):
        pad = (0, 1, 1) if i == 2 else (1, 1, 1)
        specs += [((3, 3, 3), (2, 2, 2), pad, False, c, ch), (*subm, ch, ch), (*subm, ch, ch)]
        c = ch
    specs.append(((3, 1, 1), (2, 1, 1), (0, 0, 0), False, c, int(bb.get('OUT_CHANNELS', 128))))
    return specs


def _lin(coords, shape):
    return (coords[..., 0] * shape[1] + coords[..., 1]) * shape[2] + coords[..., 2]


def _subm_pairs(coords, shape, kernel):
    """Pairs of a submanifold conv: each site's neighbours under the kernel
    that are sites, searched by their linear ids in the grid padded by one
    cell a side (a neighbour off the grid is never a site)."""
    padded = tuple(n + 2 for n in shape)
    active = _lin(coords + 1, padded)          # sorted: the sites are in linear order
    offs = np.stack(np.meshgrid(*[np.arange(n) - (n - 1) // 2 for n in kernel],
                                indexing='ij'), -1).reshape(-1, 3)
    pairs = 0
    for off in _lin(offs, padded):
        q = active + off
        at = np.minimum(np.searchsorted(active, q), len(active) - 1)
        pairs += int(np.count_nonzero(active[at] == q))
    return pairs


def _strided_sites(coords, shape, kernel, stride, padding):
    """A strided conv's output sites (sorted, linear order), its output grid
    and its pairs. Input z reaches output o iff z = s*o - p + j, j in [0,
    k): the candidates are o = (z + p) // s - d, d < ceil(k / s), and each
    valid candidate is one pair."""
    k, s, p = (np.asarray(v) for v in (kernel, stride, padding))
    out_shape = tuple(int(v) for v in (np.asarray(shape) + 2 * p - k) // s + 1)
    ds = np.stack(np.meshgrid(*[np.arange(-(-a // b)) for a, b in zip(kernel, stride)],
                              indexing='ij'), -1).reshape(-1, 3)
    o = ((coords + p) // s)[:, None, :] - ds[None]
    j = (coords + p)[:, None, :] - o * s
    ok = np.all((j < k) & (o >= 0) & (o < np.asarray(out_shape)), axis=-1)
    lin = np.unique(_lin(o[ok], out_shape))
    area = out_shape[1] * out_shape[2]
    out = np.stack([lin // area, (lin // out_shape[2]) % out_shape[1], lin % out_shape[2]],
                   axis=1)
    return out, out_shape, int(np.count_nonzero(ok))


def conv_sites(coords, shape, specs):
    """[(pairs, input sites, output sites)] of each conv in ``specs`` on the
    active (z, y, x) ``coords`` (in linear order) of a grid of ``shape``."""
    out = []
    coords = np.asarray(coords, np.int64)
    shape = tuple(int(n) for n in shape)
    subm_pairs = None           # a submanifold conv's pairs, the same for the next one
    for kernel, stride, padding, subm, _, _ in specs:
        if subm:
            if subm_pairs is None:
                subm_pairs = _subm_pairs(coords, shape, kernel)
            out.append((subm_pairs, len(coords), len(coords)))
            continue
        new, shape, pairs = _strided_sites(coords, shape, kernel, stride, padding)
        out.append((pairs, len(coords), len(new)))
        coords, subm_pairs = new, None
    return out


def scan_sites(cfg, points):
    """:func:`conv_sites` of one scan's (N, 4) points under the reference's
    voxelization, on upstream's sparse shape (one more z cell)."""
    pcr, vs, grid, max_voxels, max_points = _voxel_cfg(cfg)
    _, _, coords = voxelize3d(points, pcr, vs, grid, max_voxels, max_points)
    return conv_sites(coords, (grid[2] + 1, grid[1], grid[0]), conv_specs(cfg))


def bev_and_head_flops(cfg):
    """The scan-independent part: BaseBEVBackbone on the stride-8 map of
    HeightCompression's channels, and the head's 1x1 convs."""
    model = cfg['MODEL']
    _, _, grid, _, _ = _voxel_cfg(cfg)
    h, w = grid[1] // 8, grid[0] // 8
    bb = model['BACKBONE_2D']
    c_in = int(model['MAP_TO_BEV']['NUM_BEV_FEATURES'])
    total = 0.0
    for i, n in enumerate(bb['LAYER_NUMS']):
        s, f = int(bb['LAYER_STRIDES'][i]), int(bb['NUM_FILTERS'][i])
        h, w = h // s, w // s
        total += conv_flops(h, w, c_in, f, 3) + int(n) * conv_flops(h, w, f, f, 3)
        up = int(bb['UPSAMPLE_STRIDES'][i])
        total += conv_flops(h, w, f, int(bb['NUM_UPSAMPLE_FILTERS'][i]), up)
        up_h, up_w = h * up, w * up
        c_in = f
    head = model['DENSE_HEAD']
    na = sum(len(a['anchor_sizes']) * len(a['anchor_rotations']) * len(a['anchor_bottom_heights'])
             for a in head['ANCHOR_GENERATOR_CONFIG'])
    out = na * (len(cfg['CLASS_NAMES']) + 7 + (int(head['NUM_DIR_BINS'])
                                               if head.get('USE_DIRECTION_CLASSIFIER') else 0))
    c_bev = sum(int(v) for v in bb['NUM_UPSAMPLE_FILTERS'])
    return total + conv_flops(up_h, up_w, c_bev, out, 1)


def batch_flops(cfg, scans):
    """Dense FLOPs of one request's (B, N, 4) ``scans``."""
    specs = conv_specs(cfg)
    fixed = bev_and_head_flops(cfg)
    total = 0.0
    for points in scans:
        sparse = sum(2.0 * pairs * spec[4] * spec[5]
                     for (pairs, _, _), spec in zip(scan_sites(cfg, points), specs))
        total += sparse + fixed
    return total


def conv_work(pairs, in_sites, out_sites, taps, c_in, c_out):
    """(operations, bytes) of one sparse conv: 2 x pairs x C_in x C_out, and
    the input sites' features and coordinates, the weight and the output
    sites' features and coordinates at 4 bytes a value."""
    ops = 2.0 * pairs * c_in * c_out
    nbytes = 4.0 * (in_sites * (c_in + 3) + taps * c_in * c_out + out_sites * (c_out + 3))
    return ops, nbytes


def bound_s(ops, nbytes, rates):
    """The least seconds the card could take: float32 operations at its f32
    peak (the products are float32, TF32 off) or bytes at its memory rate."""
    return max(ops / rates['f32'], nbytes / rates['hbm'])
