"""Building blocks of the detection models, eval and train semantics.

Port of ``hvpr_tpu/models/model_utils/layers.py``. BatchNorm uses eps 1e-3
and momentum 0.01 (flax 0.99), with statistics in f32 whatever the
activation dtype. Both BatchNorms are written out by hand, since torch's
``nn.BatchNorm*`` train mode matches neither:

- :class:`MaskedBatchNorm` takes its batch statistics over masked elements
  only and stores the UNBIASED variance in its running var;
- :class:`SplitBatchNorm` normalizes each of ``splits`` stacked groups by its
  own statistics and updates the running stats with the BIASED variance,
  sequentially, group 0 first.

Over several processes (a process group of more than one rank) both take
their training statistics over the global batch, as the JAX package's mesh
step does: each rank's sums are summed over the ranks (under autograd, so
that the gradient flows back to every rank's rows), in the same two passes
(mean, then the centred sum of squares), and every rank ends with the same
running statistics. In one process nothing is exchanged and nothing
changes.

The classes subclass ``nn.Linear``/``nn.BatchNorm*``/``nn.Sequential`` so
that their ``state_dict`` keys are the reference OpenPCDet ones
(``*.linear.weight``, ``*.norm.running_mean``, ``blocks.i.1.weight``, ...).
Convolutions take NCHW tensors; the NHWC canvases of the port permuted to
NCHW are ``channels_last`` memory, so cuDNN reads them without a copy.
"""

import torch
from torch import nn
from torch.nn import functional as F

from ...utils.common_utils import all_reduce_sum, get_dist_info

BN_EPS = 1e-3
BN_KEEP = 0.99          # flax momentum: running = keep * running + (1 - keep) * batch


def matmul_in(dtype, a, b):
    """``a @ b`` with both rounded to ``dtype``, f32 accumulation, the result
    rounded to ``dtype`` (the JAX package's ``preferred_element_type=f32``
    products)."""
    return (a.to(dtype).float() @ b.to(dtype).float()).to(dtype)


class DenseT(nn.Linear):
    """Dense layer on channel-major (C_in, R) rows: ``W @ x`` -> (C_out, R),
    in the input dtype (f32 accumulation)."""

    def __init__(self, in_features, out_features, bias=False):
        super().__init__(in_features, out_features, bias=bias)

    def forward(self, x_t):
        y = matmul_in(x_t.dtype, self.weight, x_t)
        if self.bias is not None:
            y = y + self.bias.to(x_t.dtype)[:, None]
        return y


def _update_running(bn, means, variances):
    """EMA of the running statistics, one (mean, var) pair after another."""
    with torch.no_grad():
        for mean, var in zip(means, variances):
            bn.running_mean.copy_(BN_KEEP * bn.running_mean + (1 - BN_KEEP) * mean)
            bn.running_var.copy_(BN_KEEP * bn.running_var + (1 - BN_KEEP) * var)


class MaskedBatchNorm(nn.BatchNorm1d):
    """BatchNorm over channel-major (C, R) rows (the JAX module's
    ``transposed=True`` layout). In training the statistics come from the
    rows where ``mask`` (R,) is set (all rows without a mask)."""

    def __init__(self, num_features):
        super().__init__(num_features, eps=BN_EPS)

    def forward(self, x_t, mask=None):
        x32 = x_t.float()
        if self.training:
            m = (torch.ones(x_t.shape[1], device=x_t.device) if mask is None
                 else mask.float())[None, :]
            if get_dist_info()[1] > 1:
                sums = all_reduce_sum(torch.cat([(x32 * m).sum(dim=1), m.sum()[None]]))
                count = torch.clamp(sums[-1].detach(), min=1.0)
                mean = sums[:-1] / count
                var = all_reduce_sum(((x32 - mean[:, None]) ** 2 * m).sum(dim=1)) / count
            else:
                count = torch.clamp(m.sum(), min=1.0)
                mean = (x32 * m).sum(dim=1) / count
                var = ((x32 - mean[:, None]) ** 2 * m).sum(dim=1) / count
            _update_running(self, [mean.detach()],
                            [(var * (count / torch.clamp(count - 1.0, min=1.0))).detach()])
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps)
        y = (x32 - mean[:, None]) * (inv * self.weight)[:, None] + self.bias[:, None]
        return y.to(x_t.dtype)


class SplitBatchNorm(nn.BatchNorm2d):
    """BatchNorm over NCHW (or NCDHW: the dense 3D backbones' volumes), f32
    output. In training the batch is ``splits`` stacked groups, each
    normalized by its own biased statistics; the running stats take the
    groups in order."""

    def __init__(self, num_features):
        super().__init__(num_features, eps=BN_EPS)

    def forward(self, x, splits=1):
        if not self.training:
            return F.batch_norm(x.float(), self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        b = x.shape[0]
        if b % splits:
            raise ValueError(f'batch {b} does not split into {splits}')
        xs = x.float().reshape(splits, b // splits, *x.shape[1:])
        red = (1, *range(3, xs.ndim))               # batch and spatial axes
        world = get_dist_info()[1]
        if world > 1:
            n = world * xs[0, :, 0].numel()
            mean = all_reduce_sum(xs.sum(dim=red, keepdim=True)) / n
            var = all_reduce_sum(((xs - mean) ** 2).sum(dim=red, keepdim=True)) / n
        else:
            mean = xs.mean(dim=red, keepdim=True)                # (s, 1, C, 1, 1)
            var = ((xs - mean) ** 2).mean(dim=red, keepdim=True)
        y = (xs - mean) * torch.rsqrt(var + self.eps)
        per_channel = (-1,) + (1,) * (x.ndim - 2)
        y = (y.reshape(x.shape) * self.weight.reshape(per_channel)
             + self.bias.reshape(per_channel))
        _update_running(self, mean.detach().reshape(splits, -1),
                        var.detach().reshape(splits, -1))
        return y


def run_sequence(seq, x, splits=1):
    """Apply the modules of ``seq`` in order, passing ``splits`` to every
    :class:`SplitBatchNorm`."""
    for module in seq:
        x = module(x, splits) if isinstance(module, SplitBatchNorm) else module(x)
    return x


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
    emits bf16, as BACKBONE_2D.COMPUTE_DTYPE does in the JAX package.
    ``splits`` (call time): per-split BN statistics in training."""

    def __init__(self, in_channels, features, kernel_size=3, stride=1,
                 padding=1, dtype=None):
        super().__init__(
            Conv2d(in_channels, features, kernel_size, stride=stride,
                   padding=padding, bias=False, dtype=dtype),
            SplitBatchNorm(features),
            CastReLU(dtype))

    def forward(self, x, splits=1):
        return run_sequence(self, x, splits)


class DeconvBNReLU(nn.Sequential):
    """Transpose-conv upsampling (kernel == stride) -> BN -> cast -> ReLU."""

    def __init__(self, in_channels, features, stride, dtype=None):
        super().__init__(
            ConvTranspose2d(in_channels, features, stride, stride=stride,
                            bias=False, dtype=dtype),
            SplitBatchNorm(features),
            CastReLU(dtype))

    def forward(self, x, splits=1):
        return run_sequence(self, x, splits)
