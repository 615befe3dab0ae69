"""Building blocks of the detection models, eval semantics.

Port of ``hvpr_tpu/models/model_utils/layers.py``. BatchNorm uses eps 1e-3
and its running statistics, computed in f32 whatever the activation dtype.
The classes subclass ``nn.Linear``/``nn.BatchNorm*``/``nn.Sequential`` so
that their ``state_dict`` keys are the reference OpenPCDet ones
(``*.linear.weight``, ``*.norm.running_mean``, ``blocks.i.1.weight``, ...).
Convolutions take NCHW tensors; the NHWC canvases of the port permuted to
NCHW are ``channels_last`` memory, so cuDNN reads them without a copy.
"""

import torch
from torch import nn
from torch.nn import functional as F

BN_EPS = 1e-3


class DenseT(nn.Linear):
    """Dense layer on channel-major (C_in, R) rows: ``W @ x`` -> (C_out, R).

    The matmul runs in the input dtype (the weight is cast to it)."""

    def __init__(self, in_features, out_features, bias=False):
        super().__init__(in_features, out_features, bias=bias)

    def forward(self, x_t):
        y = self.weight.to(x_t.dtype) @ x_t
        if self.bias is not None:
            y = y + self.bias.to(x_t.dtype)[:, None]
        return y


class MaskedBatchNorm(nn.BatchNorm1d):
    """BatchNorm with running statistics over channel-major (C, R) rows
    (the JAX module's ``transposed=True`` layout); eval only."""

    def __init__(self, num_features):
        super().__init__(num_features, eps=BN_EPS)

    def forward(self, x_t):
        inv = torch.rsqrt(self.running_var + self.eps)
        y = ((x_t.float() - self.running_mean[:, None])
             * (inv * self.weight)[:, None] + self.bias[:, None])
        return y.to(x_t.dtype)


class SplitBatchNorm(nn.BatchNorm2d):
    """BatchNorm over NCHW with running statistics, f32 output (eval only;
    the JAX module's ``splits`` matter only in training)."""

    def __init__(self, num_features):
        super().__init__(num_features, eps=BN_EPS)

    def forward(self, x):
        return F.batch_norm(x.float(), self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


class Conv2d(nn.Conv2d):
    """Conv2d that runs in ``dtype`` (input and weight cast to it); None
    keeps the input dtype, promoted with the weight's as JAX promotes."""

    def __init__(self, *args, dtype=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype or torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    """ConvTranspose2d that runs in ``dtype`` (see :class:`Conv2d`)."""

    def __init__(self, *args, dtype=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype or torch.promote_types(x.dtype, self.weight.dtype)
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt), None,
                                  self.stride, self.padding)


class CastReLU(nn.Module):
    """Cast to the block's compute dtype (if any), then ReLU."""

    def __init__(self, dtype=None):
        super().__init__()
        self.compute_dtype = dtype

    def forward(self, x):
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        return F.relu(x)


class ConvBNReLU(nn.Sequential):
    """conv (padding ``padding``) -> BN -> cast -> ReLU, as
    ``[conv, bn, relu]`` children (keys ``0.weight``, ``1.running_mean``).

    ``dtype=torch.bfloat16`` runs the conv in bf16 (f32 params, f32 BN) and
    emits bf16, as BACKBONE_2D.COMPUTE_DTYPE does in the JAX package."""

    def __init__(self, in_channels, features, kernel_size=3, stride=1,
                 padding=1, dtype=None):
        super().__init__(
            Conv2d(in_channels, features, kernel_size, stride=stride,
                   padding=padding, bias=False, dtype=dtype),
            SplitBatchNorm(features),
            CastReLU(dtype))


class DeconvBNReLU(nn.Sequential):
    """Transpose-conv upsampling (kernel == stride) -> BN -> cast -> ReLU."""

    def __init__(self, in_channels, features, stride, dtype=None):
        super().__init__(
            ConvTranspose2d(in_channels, features, stride, stride=stride,
                            bias=False, dtype=dtype),
            SplitBatchNorm(features),
            CastReLU(dtype))
