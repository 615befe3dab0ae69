"""PyTorch/CUDA port of ``hvpr_tpu`` for one NVIDIA H100.

Mirrors the JAX package's layout (``config``, ``ops``, ``models``, ``utils``)
and its batch-dict keys and tensor layouts, so the two can be held against
each other on the same inputs. The port imports ``torch`` and numpy/yaml
only. It runs HVPR inference and the train step (``TRAIN_ATTEND_MODE``
fused, the shipped default, and gather), evaluates ``.pth``
checkpoints on KITTI trees (``tools/test.py``, the data layer of
``datasets/``, the official AP) and trains on them (``tools/train.py``,
the augmentor of ``datasets/augmentor/``), builds every module of the JAX
package's registries (the SECOND family's sparse and dense 3D backbones,
``AnchorHeadMulti``, ATSS, ...) and runs the demo and vis entry points
(``tools/demo.py``, ``tools/vis.py``); every TPU kernel of the JAX
package is hand-written CUDA (``csrc/``: K1-K3 for inference, K4-K10 for
training, and K11, the bucketed 3-NN, which no path calls, as in the JAX
package), built with nvcc at first use and loaded with ctypes
(``ops/_kernels.py``).
"""

import torch


def resolve_device(device='cuda'):
    """``torch.device`` for an entry point; a CUDA device must exist."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch sees no CUDA "
                           "device; pass device='cpu' to run on the CPU")
    return device
