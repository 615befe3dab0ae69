"""Carry weights from the JAX package's flax variables to the port.

``from_flax_variables`` takes the flax variables flattened to
``{'params/...' | 'batch_stats/...': ndarray}`` and returns a ``state_dict``
under the reference OpenPCDet key names, so that the port also loads a
reference ``.pth`` directly. The key table is that of the JAX package's
``.pth`` importer (``hvpr_tpu/utils/torch_ckpt.py``), and the layout
transforms are its inverses:

  Linear         flax (in, out)            -> torch (out, in)
  Conv           HWIO / DHWIO              -> OIHW / OIDHW
  1x1 head conv  (1, 1, in, out)           -> (out, in, 1, 1)
  ConvTranspose  HWIO, applied unflipped   -> IOHW, H and W flipped (torch's
                 by flax                      transposed conv is the adjoint);
                                              DHWIO -> IODHW likewise
  sparse conv    (prod K, in, out)         -> the same array
  BatchNorm      scale/bias/mean/var       -> weight/bias/running_mean/running_var
  point-stream   Dense (in, out)           -> 1x1 conv (out, in, 1, 1)

Point-stream leaves map to ``backbone_3d.SA_modules.{i}.mlps.{j}.{3k}`` and
``backbone_3d.FP_modules.{i}.mlp.{3k}`` (BN at ``3k + 1``). Flax names the
FP modules in the order they are applied, last level first, so
``FPModule_{j}`` is the reference's ``FP_modules[len - 1 - j]``; the length
is the number of distinct ``FPModule_*`` names among the variables.

The plain ``BaseBEVBackbone`` (PointPillar) names its modules by class:
``_Block_{i}/ConvBNReLU_{j}`` is level i's conv j (``blocks.{i}``, as the
scale backbone's ``blocks_{i}``), and the upsamplings are numbered per
class in level order, ``ConvBNReLU_{j}`` for an UPSAMPLE_STRIDES below 1 and
``DeconvBNReLU_{j}`` for one of 1 or more (the last one the extra deblock,
if any). A level is coarser than the one before it, so its upsampling
stride is no smaller: the strided convs are the first levels, and
``DeconvBNReLU_{j}`` is ``deblocks.{n + j}`` where n counts the
``ConvBNReLU_*`` names directly under ``backbone_2d``.

The voxel backbones: the sparse one's ``SubMBlock_{i}`` are ``conv_input``,
``conv1.0``, then two a stage (``conv{s+2}.1`` and ``.2``), its
``SparseDownBlock_{s}`` ``conv{s+2}.0`` and the last one ``conv_out``
(``kernel`` at ``.0.weight``, ``MaskedBatchNorm_0`` at ``.1``). The dense
ones' ``Conv3DBNReLU_{i}`` are ``blocks.{i}`` (``blocks.{2i}`` beside
``_ResBlock3D_{i}`` = ``blocks.{2i+1}``: ``conv1``, ``conv2``, ``bn2``),
UNetV2's ``ConvTranspose_{j}``/``BatchNorm_{j}`` are ``ups.{j}.0``/``.1``.
AnchorHeadMulti's ``shared_conv`` and ``heads_{h}`` are ``shared_conv`` and
``rpn_heads.{h}`` (``ConvBNReLU_{k}`` -> ``head_convs.{k}``, ``Conv_{n}`` ->
``convs.{n}``).
"""

import numpy as np
import torch


def _linear(w):
    return np.transpose(w)


def _conv(w):
    nd = w.ndim - 2                     # spatial axes: 2 (HWIO) or 3 (DHWIO)
    return np.transpose(w, (nd + 1, nd, *range(nd)))


def _conv_transpose(w):
    nd = w.ndim - 2
    return np.transpose(w[(slice(None, None, -1),) * nd], (nd, nd + 1, *range(nd)))


def _identity(w):
    return np.asarray(w)


def _dense_as_conv1x1(w):
    return np.transpose(w)[:, :, None, None]


_BN = {'scale': 'weight', 'bias': 'bias', 'mean': 'running_mean',
       'var': 'running_var'}


def _idx(name):
    return int(name.rsplit('_', 1)[1])


def _conv_bn(base, p, leaf):
    """[conv, bn, relu] block: flax ``Conv_0``/``BatchNorm_0`` -> ``base.0``/``base.1``."""
    if p.startswith('Conv'):
        return f'{base}.0.weight', _conv
    return f'{base}.1.{_BN[leaf]}', _identity


def _sparse_stage(p0, num_sparse_down):
    """The sparse backbone's flax block name -> its key prefix."""
    i = _idx(p0)
    if p0.startswith('SubMBlock_'):
        if i < 2:
            return ('conv_input', 'conv1.0')[i]
        return f'conv{(i - 2) // 2 + 2}.{1 + (i - 2) % 2}'
    if i == num_sparse_down - 1:
        return 'conv_out'
    return f'conv{i + 2}.0'


def _translate_backbone_3d(p, leaf, ctx):
    if p[1].startswith('SAModuleMSG_'):
        base = f'backbone_3d.SA_modules.{_idx(p[1])}.mlps.{_idx(p[2])}'
    elif p[1].startswith('FPModule_'):
        base = f'backbone_3d.FP_modules.{ctx["fp"] - 1 - _idx(p[1])}.mlp'
    elif p[1].startswith(('SubMBlock_', 'SparseDownBlock_')):
        base = f'backbone_3d.{_sparse_stage(p[1], ctx["sparse_down"])}'
        if leaf == 'kernel':
            return f'{base}.0.weight', _identity
        return f'{base}.1.{_BN[leaf]}', _identity
    elif p[1].startswith('Conv3DBNReLU_'):
        i = _idx(p[1]) * (2 if ctx['res'] else 1)
        return _conv_bn(f'backbone_3d.blocks.{i}', p[2], leaf)
    elif p[1].startswith('_ResBlock3D_'):
        base = f'backbone_3d.blocks.{2 * _idx(p[1]) + 1}'
        if p[2].startswith('Conv3DBNReLU'):
            return _conv_bn(f'{base}.conv1', p[3], leaf)
        if p[2].startswith('Conv'):
            return f'{base}.conv2.weight', _conv
        return f'{base}.bn2.{_BN[leaf]}', _identity
    elif p[1].startswith('ConvTranspose_'):
        return f'backbone_3d.ups.{_idx(p[1])}.0.weight', _conv_transpose
    elif p[1].startswith('BatchNorm_'):
        return f'backbone_3d.ups.{_idx(p[1])}.1.{_BN[leaf]}', _identity
    else:
        return None
    k = _idx(p[3])
    if p[3].startswith('Dense'):
        return f'{base}.{3 * k}.weight', _dense_as_conv1x1
    return f'{base}.{3 * k + 1}.{_BN[leaf]}', _identity


def _translate(p, ctx):
    """flax path (collection dropped) -> (torch key, transform), or None."""
    leaf = p[-1]
    if p[0] == 'backbone_3d':
        return _translate_backbone_3d(p, leaf, ctx)
    if p[0] == 'vfe':
        if p[1].startswith('PFNLayer_'):
            i = _idx(p[1])
            if p[2].startswith('Dense'):
                return f'vfe.pfn_layers.{i}.linear.weight', _linear
            return f'vfe.pfn_layers.{i}.norm.{_BN[leaf]}', _identity
        if p[1].startswith('Dense_'):
            return f'vfe.pfn_scale_layers.{_idx(p[1])}.0.weight', _linear
        if p[1].startswith('MaskedBatchNorm_'):
            return f'vfe.pfn_scale_layers.{_idx(p[1])}.1.{_BN[leaf]}', _identity
    if p[0] == 'map_to_bev' and p[1] == 'memory':
        return 'map_to_bev_module.memory.weight', _identity
    if p[0] == 'backbone_2d':
        group, i = p[1].rsplit('_', 1) if '_' in p[1] else (p[1], None)
        if group == 'ConvBNReLU':           # a strided-conv upsampling
            if p[2].startswith('Conv'):
                return f'backbone_2d.deblocks.{i}.0.weight', _conv
            return f'backbone_2d.deblocks.{i}.1.{_BN[leaf]}', _identity
        if group == 'DeconvBNReLU':
            group, i = 'deblocks', ctx['conv_deblocks'] + int(i)
        if group in ('blocks', '_Block'):
            j = _idx(p[2])    # [pad, conv, bn, relu] + [conv, bn, relu]*
            if p[3].startswith('Conv'):
                return f'backbone_2d.blocks.{i}.{1 + 3 * j}.weight', _conv
            return f'backbone_2d.blocks.{i}.{2 + 3 * j}.{_BN[leaf]}', _identity
        if group == 'deblocks':
            if p[2].startswith('ConvTranspose'):
                return f'backbone_2d.deblocks.{i}.0.weight', _conv_transpose
            return f'backbone_2d.deblocks.{i}.1.{_BN[leaf]}', _identity
        if group == 'scale_blocks':
            if p[2].startswith('Conv'):
                return f'backbone_2d.scale_layers.{i}.1.weight', _conv
            return f'backbone_2d.scale_layers.{i}.2.{_BN[leaf]}', _identity
        if group == 'sfm_blocks':
            if p[2].startswith('Conv'):
                return f'backbone_2d.sfmblocks_down.{i}.0.weight', _conv
            return f'backbone_2d.sfmblocks_down.{i}.1.{_BN[leaf]}', _identity
        if p[1] == 'attention':
            if p[2].startswith('Conv'):
                if leaf == 'kernel':
                    return 'backbone_2d.attention.spatial.conv.weight', _conv
                return 'backbone_2d.attention.spatial.conv.bias', _identity
            return f'backbone_2d.attention.spatial.norm.{_BN[leaf]}', _identity
    if p[0] == 'dense_head':
        if p[1] == 'shared_conv':
            return _conv_bn('dense_head.shared_conv', p[2], leaf)
        if p[1].startswith('heads_'):
            base = f'dense_head.rpn_heads.{_idx(p[1])}'
            if p[2].startswith('ConvBNReLU_'):
                return _conv_bn(f'{base}.head_convs.{_idx(p[2])}', p[3], leaf)
            return (f'{base}.convs.{_idx(p[2])}.weight', _conv) if leaf == 'kernel' \
                else (f'{base}.convs.{_idx(p[2])}.bias', _identity)
        name = {'conv_dir': 'conv_dir_cls'}.get(p[1], p[1])
        if leaf == 'kernel':
            return f'dense_head.{name}.weight', _conv
        return f'dense_head.{name}.bias', _identity
    return None


def from_flax_variables(flat_numpy):
    """{'params/a/b/leaf': array, 'batch_stats/...': array} -> state_dict.

    Raises KeyError on a leaf that has no reference key.
    """
    def count(module, prefix):
        return len({path.split('/')[2] for path in flat_numpy
                    if path.split('/')[1:2] == [module]
                    and path.split('/')[2].startswith(prefix)})

    ctx = {'fp': count('backbone_3d', 'FPModule_'),
           'sparse_down': count('backbone_3d', 'SparseDownBlock_'),
           'res': count('backbone_3d', '_ResBlock3D_') > 0,
           'conv_deblocks': count('backbone_2d', 'ConvBNReLU_')}
    state = {}
    for path, value in flat_numpy.items():
        parts = path.split('/')[1:]
        mapped = _translate(parts, ctx)
        if mapped is None:
            raise KeyError(f'no reference key for flax leaf {path}')
        key, transform = mapped
        state[key] = torch.from_numpy(
            transform(np.asarray(value, np.float32)).copy(order='C'))
        if key.endswith('running_mean'):
            state[key[:-len('running_mean')] + 'num_batches_tracked'] = \
                torch.tensor(0, dtype=torch.int64)
    return state
