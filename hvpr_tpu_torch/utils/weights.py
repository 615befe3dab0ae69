"""Carry weights from the JAX package's flax variables to the port.

``from_flax_variables`` takes the flax variables flattened to
``{'params/...' | 'batch_stats/...': ndarray}`` and returns a ``state_dict``
under the reference OpenPCDet key names, so that the port also loads a
reference ``.pth`` directly. The key table is that of the JAX package's
``.pth`` importer (``hvpr_tpu/utils/torch_ckpt.py``), and the layout
transforms are its inverses:

  Linear         flax (in, out)            -> torch (out, in)
  Conv           HWIO                      -> OIHW
  1x1 head conv  (1, 1, in, out)           -> (out, in, 1, 1)
  ConvTranspose  HWIO, applied unflipped   -> IOHW, H and W flipped (torch's
                 by flax                      transposed conv is the adjoint)
  BatchNorm      scale/bias/mean/var       -> weight/bias/running_mean/running_var
  point-stream   Dense (in, out)           -> 1x1 conv (out, in, 1, 1)

Point-stream leaves map to ``backbone_3d.SA_modules.{i}.mlps.{j}.{3k}`` and
``backbone_3d.FP_modules.{i}.mlp.{3k}`` (BN at ``3k + 1``). Flax names the
FP modules in the order they are applied, last level first, so
``FPModule_{j}`` is the reference's ``FP_modules[len - 1 - j]``; the length
is the number of distinct ``FPModule_*`` names among the variables.
"""

import numpy as np
import torch


def _linear(w):
    return np.transpose(w)


def _conv(w):
    return np.transpose(w, (3, 2, 0, 1))


def _conv_transpose(w):
    return np.transpose(w[::-1, ::-1], (2, 3, 0, 1))


def _identity(w):
    return np.asarray(w)


def _dense_as_conv1x1(w):
    return np.transpose(w)[:, :, None, None]


_BN = {'scale': 'weight', 'bias': 'bias', 'mean': 'running_mean',
       'var': 'running_var'}


def _idx(name):
    return int(name.rsplit('_', 1)[1])


def _translate(p, num_fp_modules):
    """flax path (collection dropped) -> (torch key, transform), or None."""
    leaf = p[-1]
    if p[0] == 'backbone_3d':
        if p[1].startswith('SAModuleMSG_'):
            base = f'backbone_3d.SA_modules.{_idx(p[1])}.mlps.{_idx(p[2])}'
        elif p[1].startswith('FPModule_'):
            base = f'backbone_3d.FP_modules.{num_fp_modules - 1 - _idx(p[1])}.mlp'
        else:
            return None
        k = _idx(p[3])
        if p[3].startswith('Dense'):
            return f'{base}.{3 * k}.weight', _dense_as_conv1x1
        return f'{base}.{3 * k + 1}.{_BN[leaf]}', _identity
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
        if group == 'blocks':
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
        name = {'conv_dir': 'conv_dir_cls'}.get(p[1], p[1])
        if leaf == 'kernel':
            return f'dense_head.{name}.weight', _conv
        return f'dense_head.{name}.bias', _identity
    return None


def from_flax_variables(flat_numpy):
    """{'params/a/b/leaf': array, 'batch_stats/...': array} -> state_dict.

    Raises KeyError on a leaf that has no reference key.
    """
    num_fp_modules = len({path.split('/')[2] for path in flat_numpy
                          if path.split('/')[1:2] == ['backbone_3d']
                          and path.split('/')[2].startswith('FPModule_')})
    state = {}
    for path, value in flat_numpy.items():
        parts = path.split('/')[1:]
        mapped = _translate(parts, num_fp_modules)
        if mapped is None:
            raise KeyError(f'no reference key for flax leaf {path}')
        key, transform = mapped
        state[key] = torch.from_numpy(
            transform(np.asarray(value, np.float32)).copy(order='C'))
        if key.endswith('running_mean'):
            state[key[:-len('running_mean')] + 'num_batches_tracked'] = \
                torch.tensor(0, dtype=torch.int64)
    return state
