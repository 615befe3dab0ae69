"""``.pth`` checkpoints in the reference OpenPCDet format.

A checkpoint is a dict ``{'epoch', 'it', 'model_state', 'optimizer_state',
'version'}`` saved with ``torch.save``; ``model_state`` is a state dict
under the reference keys, which the port's modules use
(``utils/weights.py``). The JAX package's ``tools/test.py`` reads the same
files (``hvpr_tpu/utils/torch_ckpt.py``), so ``.pth`` is the exchange
format of the two packages.

A training checkpoint also holds the optimizer's state
(its ``state_dict``: the torch optimizer's moments and steps, and the
schedule's position) and the iteration; :func:`load_checkpoint` restores all of it for
a resumed run. :func:`load_params_from_file` is the reference's
shape-checked partial load of the weights alone: a key of the file updates
the module only where the module has it at the same shape; every other key
is reported, not loaded.
"""

import re

import torch

VERSION = 'hvpr_tpu_torch'


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def save_checkpoint(module, filename, epoch=None, it=None, optimizer=None):
    """Write ``module``'s weights and BN statistics, and the state of
    ``optimizer`` (of ``optimization.build_optimizer``) if given, on the CPU, with the
    epoch and iteration."""
    torch.save({'epoch': epoch, 'it': it,
                'model_state': _to_cpu(module.state_dict()),
                'optimizer_state': None if optimizer is None
                else _to_cpu(optimizer.state_dict()),
                'version': VERSION}, filename)


def load_checkpoint(module, filename, optimizer=None, logger=None):
    """Restore a checkpoint of :func:`save_checkpoint` for a resumed run:
    every weight and BN statistic of ``module`` (all keys must match), and
    the state of ``optimizer`` if given (the file must hold one). Returns
    (epoch, it)."""
    blob = torch.load(filename, map_location='cpu', weights_only=True)
    module.load_state_dict(blob['model_state'], strict=True)
    if optimizer is not None:
        if blob.get('optimizer_state') is None:
            raise ValueError(f'{filename} holds no optimizer state')
        optimizer.load_state_dict(blob['optimizer_state'])
    epoch, it = blob.get('epoch'), blob.get('it')
    if logger is not None:
        logger.info('==> Loaded checkpoint %s (epoch %s, it %s%s)', filename, epoch, it,
                    ', with the optimizer' if optimizer is not None else '')
    return epoch, it


def load_params_from_file(module, filename, logger=None):
    """Load the shape-matching keys of a checkpoint into ``module``.

    Returns (epoch, report): the checkpoint's epoch (from the file, else
    the ``checkpoint_epoch_N`` of its name, else None) and
    ``{'loaded', 'mismatched', 'unused', 'not_updated'}`` key lists:
    mismatched keys differ in shape, unused ones are absent from the module
    (e.g. the point stream of a training checkpoint in an eval network),
    and the module's keys that kept their values are not updated.
    """
    # weights_only: only tensors and plain containers are unpickled
    blob = torch.load(filename, map_location='cpu', weights_only=True)
    disk = blob['model_state']
    own = module.state_dict()
    update, mismatched, unused = {}, [], []
    for key, val in disk.items():
        if key not in own:
            unused.append(key)
        elif tuple(own[key].shape) != tuple(val.shape):
            mismatched.append(f'{key}: file {tuple(val.shape)} vs module '
                              f'{tuple(own[key].shape)}')
        else:
            update[key] = val
    own.update(update)
    module.load_state_dict(own)
    not_updated = [k for k in own if k not in update]
    report = {'loaded': sorted(update), 'mismatched': mismatched,
              'unused': unused, 'not_updated': not_updated}
    epoch = blob.get('epoch')
    if epoch is None:
        m = re.search(r'checkpoint_epoch_(\d+)', str(filename))
        epoch = int(m.group(1)) if m else None
    if logger is not None:
        logger.info('==> Loading parameters from checkpoint %s (epoch %s)', filename, epoch)
        for line in mismatched:
            logger.info('Shape-mismatched key, not loaded: %s', line)
        for key in not_updated:
            logger.info('Not updated weight %s: %s', key, tuple(own[key].shape))
        logger.info('==> Done (loaded %d/%d; %d keys of the file unused)',
                    len(update), len(own), len(unused))
    return epoch, report
