"""MemAE-style attentive memory.

Port of ``hvpr_tpu/models/backbones_2d/map_to_bev/memory_module.py``
``MemoryUnitAgg``. Eval (``eval_forward``): pillars address a learnable
(M, C) memory and the softmax over its top-k rows reconstructs each pillar.
Training: every point feature is reconstructed from the memory once
(:func:`ops.memory_recon.memory_recon`, kernels K6/K7 on the card), and each
pillar aggregates the reconstructions of its selected points by pillar
similarity (stop-gradient weights). ``train_forward_fused`` (the shipped
``TRAIN_ATTEND_MODE: fused``) selects by the bucket threshold and
aggregates with :func:`ops.topk_attend.masked_attend` (kernels K9/K10);
``train_forward`` (``gather``) gathers the reconstructions of each pillar's
exact top-k points by :func:`ops.gather_rows.gather_rows`, whose backward
sums in order (K12 on the card).

Modes (MAP_TO_BEV.TOPK_MODE): ``'fused'`` runs
:func:`ops.memory_lookup.memory_lookup_fused` (kernel K2 on the card) over a
superset of the exact top-k; ``'exact'`` takes ``torch.topk`` over the full
logits and is the accuracy oracle. ``'approx'`` runs the exact branch: the
JAX package's ``lax.approx_max_k`` (recall target 0.9) is a partial
reduction on the TPU only, and off the TPU it returns ``lax.top_k``'s
indices and values, which the port reproduces; the TPU's recall-0.9
candidate sets are not. Given the pillar mask, the fused mode
looks up only valid pillars and leaves zeros in empty slots, which the
canvas drops: the counterpart of the JAX package's eighth-prefix
``lax.switch``, which skips the rows past the last valid pillar.
"""

import torch
from torch import nn

from ....ops.gather_rows import gather_rows
from ....ops.memory_lookup import memory_lookup_fused
from ....ops.memory_recon import memory_recon
from ....ops.topk_attend import masked_attend


class MemoryUnitAgg(nn.Module):

    def __init__(self, mem_dim, fea_dim, shrink_thres=0.0025):
        super().__init__()
        self.shrink_thres = shrink_thres
        self.weight = nn.Parameter(torch.empty(mem_dim, fea_dim))
        stdv = 1.0 / fea_dim ** 0.5
        nn.init.uniform_(self.weight, -stdv, stdv)

    @staticmethod
    def _aggregate(candidates, pillars, valid=None):
        """Similarity-softmax aggregation of (B, V, k, C) candidates per
        pillar; ``valid`` (B, V, k) masks candidates out, and a pillar with
        none aggregates to 0. The weights carry no gradient."""
        agg_logits = (candidates * pillars[..., None, :]).sum(dim=-1)    # (B, V, k)
        if valid is not None:
            agg_logits = torch.where(valid, agg_logits, -1e9)
        agg_w = torch.softmax(agg_logits, dim=-1).detach().to(candidates.dtype)
        out = (agg_w[..., None] * candidates).sum(dim=-2)
        if valid is not None:
            out = torch.where(valid.any(dim=-1)[..., None], out, 0.0)
        return out

    def train_forward(self, pillars, points, topk_idx, topk_valid=None):
        """(B, V, C) pillars, (B, N, C) point features, (B, V, k) top-k point
        indices and validity -> dict(output=(B, V, C)). Each of the B*N
        points is reconstructed once; the results are gathered by
        ``topk_idx``."""
        b, n, c = points.shape
        recon = memory_recon(points.reshape(-1, c), self.weight,
                             shrink_thres=self.shrink_thres).reshape(b, n, c)
        v, k = topk_idx.shape[1:]
        cand = gather_rows(recon, topk_idx.reshape(b, v * k))
        return {'output': self._aggregate(cand.reshape(b, v, k, c), pillars,
                                          topk_valid)}

    def train_forward_fused(self, pillars, points, neg, thresh, vmask, selection=None):
        """(B, V, C) pillars, (B, N, C) point features, (B, N) f32 ``neg``
        (0 valid, -1e30 padded), (B, V) thresholds from
        :func:`ops.topk_attend.bucket_threshold` over (pillars, points) ->
        dict(output=(B, V, C)). Each point is reconstructed once; a pillar
        aggregates the reconstructions of the points its threshold selects,
        with logits ``pillar . reconstruction``. Rows outside ``vmask`` output
        0. ``selection``: the selection of a
        :func:`ops.topk_attend.masked_attend` call over the same pillars,
        points, neg, thresholds and vmask, reused instead of recomputed."""
        b, n, c = points.shape
        recon = memory_recon(points.reshape(-1, c), self.weight,
                             shrink_thres=self.shrink_thres).reshape(b, n, c)
        return {'output': masked_attend(pillars, points, recon, neg, thresh, vmask,
                                        selection=selection)}

    def eval_forward(self, pillars, k, mode='fused', vmask=None):
        """(B, V, C) pillars -> dict(output=(B, V, C)); ``vmask`` (B, V)
        lets the fused mode skip empty slots (their output is 0)."""
        b, v, c = pillars.shape
        if mode == 'fused':
            row_mask = None if vmask is None else vmask.reshape(b * v).contiguous()
            out = memory_lookup_fused(pillars.reshape(b * v, c).contiguous(),
                                      self.weight.contiguous(), k, row_mask)
            return {'output': out.reshape(b, v, c).to(pillars.dtype)}
        if mode not in ('exact', 'approx'):
            raise ValueError(f'TOPK_MODE {mode!r} (fused, approx, exact)')
        logits = torch.einsum('bvc,mc->bvm', pillars, self.weight)
        vals, idx = torch.topk(logits, k, dim=-1)
        cand = self.weight.to(torch.bfloat16)[idx]                     # (B, V, k, C)
        agg_w = torch.softmax(vals, dim=-1).to(torch.bfloat16)
        out = (agg_w[..., None] * cand).float().sum(dim=-2)
        return {'output': out.to(torch.bfloat16).to(pillars.dtype)}
