"""The yardstick's work functions and the card's published peaks.

``H100``, the card table and :func:`power_limit` are a frozen copy of
``hvpr_tpu_torch/utils/flops.py`` at commit
1380d4cbc8b81ffdba01a8b3179518351fd96dae. This is the work module of
the pillar configurations (``"work": "flops"``): :func:`batch_flops`
counts the dense products of one request's inference from the
configuration and each scan's kept points and pillars under the
reference's voxelization: the VFE linears, the memory logits, every
convolution of the BEV backbone (the CBAM gate's conv once a SFM round, as
the model applies it) and the head's 1x1 convs. It counts a multiply-add
as 2 and no elementwise op, so it reads the same work whatever implements
it.
"""

import shutil
import subprocess

from reference.model import point_and_pillar_counts

# NVIDIA's data sheet, H100 SXM, dense rates (no sparsity) at the full 700 W
# power limit: bf16 tensor cores, TF32, f32 outside the tensor cores, f64 on
# the tensor cores (DMMA), device memory in bytes/s
H100 = {'bf16': 989e12, 'tf32': 495e12, 'f32': 67e12, 'f64_tc': 67e12, 'hbm': 3.35e12}
# torch.cuda.get_device_name substring (lower case) -> rates
CARDS = {'h100 80gb hbm3': H100, 'h100 sxm': H100}


def card_rates(name):
    """The published rates of the card named ``name``; None for another."""
    for sub, rates in CARDS.items():
        if sub in name.lower():
            return rates
    return None


def power_limit():
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card, e.g.
    'NVIDIA H100 80GB HBM3, 700.00 W'; None where there is no nvidia-smi."""
    smi = shutil.which('nvidia-smi')
    if smi is None:
        return None
    res = subprocess.run([smi, '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60, check=False)
    lines = res.stdout.strip().splitlines()
    return lines[0] if lines else None


def conv_flops(h_out, w_out, c_in, c_out, k):
    return 2.0 * h_out * w_out * c_in * c_out * k * k


def _grid(cfg):
    data = cfg['DATA_CONFIG']
    pcr = data['POINT_CLOUD_RANGE']
    vox = {p['NAME']: p for p in data['DATA_PROCESSOR']}['transform_points_to_voxels']
    vs = vox['VOXEL_SIZE']
    return [int(round((pcr[i + 3] - pcr[i]) / vs[i])) for i in range(2)]


def backbone_and_head_flops(cfg):
    """The scan-independent part: the BEV backbone and the head."""
    model = cfg['MODEL']
    nx, ny = _grid(cfg)
    bb = model['BACKBONE_2D']
    c_in = int(model['MAP_TO_BEV']['NUM_BEV_FEATURES'])
    s_in = int(model['VFE']['NUM_SCALE_FEATURES'][-1]) if 'SFM_LAYER_NUMS' in bb else None
    h, w = ny, nx
    total = 0.0
    up_h = up_w = None
    for i, n in enumerate(bb['LAYER_NUMS']):
        s = int(bb['LAYER_STRIDES'][i])
        f = int(bb['NUM_FILTERS'][i])
        h, w = h // s, w // s
        total += conv_flops(h, w, c_in, f, 3) + n * conv_flops(h, w, f, f, 3)
        if s_in is not None:
            sf = int(bb['NUM_SCALE_FILTERS'][i])
            rounds = int(bb['SFM_LAYER_NUMS'][i])
            total += conv_flops(h, w, s_in, sf, 3)
            total += rounds * (conv_flops(h, w, f, f, 3) + conv_flops(h, w, 2, 1, 3))
            s_in = sf
        up = int(bb['UPSAMPLE_STRIDES'][i])
        total += conv_flops(h, w, f, int(bb['NUM_UPSAMPLE_FILTERS'][i]), up)
        up_h, up_w = h * up, w * up
        c_in = f
    c_bev = sum(int(v) for v in bb['NUM_UPSAMPLE_FILTERS'])
    head = model['DENSE_HEAD']
    na = sum(len(a['anchor_sizes']) * len(a['anchor_rotations']) * len(a['anchor_bottom_heights'])
             for a in head['ANCHOR_GENERATOR_CONFIG'])
    n_cls = len(cfg['CLASS_NAMES'])
    out = na * (n_cls + 7 + (int(head['NUM_DIR_BINS']) if head.get('USE_DIRECTION_CLASSIFIER')
                             else 0))
    return total + conv_flops(up_h, up_w, c_bev, out, 1)


def vfe_and_memory_flops(cfg, points, pillars):
    """The VFE linears over ``points`` kept points and ``pillars`` pillars,
    and the memory's dense logits."""
    model = cfg['MODEL']
    vfe = model['VFE']
    c_in = 4 + 6 + (1 if vfe.get('WITH_DISTANCE', False) else 0) \
        - (0 if vfe.get('USE_ABSLOTE_XYZ', True) else 3)
    total = 0.0
    filters = [int(f) for f in vfe['NUM_FILTERS']]
    for i, f in enumerate(filters):
        out = f if i == len(filters) - 1 else f // 2
        total += 2.0 * points * c_in * out
        c_in = f
    if 'NUM_SCALE_FEATURES' in vfe:
        s_in = 5
        for f in vfe['NUM_SCALE_FEATURES']:
            total += 2.0 * pillars * s_in * int(f)
            s_in = int(f)
    bev = model['MAP_TO_BEV']
    if 'NUM_M' in bev:
        total += 2.0 * pillars * int(bev['NUM_M']) * int(bev['NUM_PT_FEATURES'])
    return total


def pipeline_flops(cfg, counts):
    """Dense FLOPs of one batch's inference; ``counts`` is [(kept points,
    pillars)] a scan."""
    fixed = backbone_and_head_flops(cfg)
    return sum(fixed + vfe_and_memory_flops(cfg, p, v) for p, v in counts)


def batch_flops(cfg, scans):
    """Dense FLOPs of one request: :func:`pipeline_flops` over the kept
    points and pillars of each of its (B, N, 4) ``scans``."""
    data = cfg['DATA_CONFIG']
    pcr = data['POINT_CLOUD_RANGE']
    vox = {p['NAME']: p for p in data['DATA_PROCESSOR']}['transform_points_to_voxels']
    vs = vox['VOXEL_SIZE']
    grid = [int(round((pcr[i + 3] - pcr[i]) / vs[i])) for i in range(3)]
    return pipeline_flops(cfg, [point_and_pillar_counts(
        s, pcr, vs, grid, int(vox['MAX_NUMBER_OF_VOXELS']['test']),
        int(vox['MAX_POINTS_PER_VOXEL'])) for s in scans])
