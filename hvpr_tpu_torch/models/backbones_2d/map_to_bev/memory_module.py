"""MemAE-style attentive memory, eval branch.

Port of ``hvpr_tpu/models/backbones_2d/map_to_bev/memory_module.py``
``MemoryUnitAgg.eval_forward``: pillars address a learnable (M, C) memory
and the softmax over its top-k rows reconstructs each pillar.

Modes (MAP_TO_BEV.TOPK_MODE): ``'fused'`` runs
:func:`ops.memory_lookup.memory_lookup_fused` (kernel K2 on the card) over a
superset of the exact top-k; ``'exact'`` takes ``torch.topk`` over the full
logits and is the accuracy oracle. Given the pillar mask, the fused mode
looks up only valid pillars and leaves zeros in empty slots, which the
canvas drops: the counterpart of the JAX package's eighth-prefix
``lax.switch``, which skips the rows past the last valid pillar.
"""

import torch
from torch import nn

from ....ops.memory_lookup import memory_lookup_fused


class MemoryUnitAgg(nn.Module):

    def __init__(self, mem_dim, fea_dim, shrink_thres=0.0025):
        super().__init__()
        self.shrink_thres = shrink_thres
        self.weight = nn.Parameter(torch.empty(mem_dim, fea_dim))
        stdv = 1.0 / fea_dim ** 0.5
        nn.init.uniform_(self.weight, -stdv, stdv)

    def eval_forward(self, pillars, k, mode='fused', vmask=None):
        """(B, V, C) pillars -> dict(output=(B, V, C)); ``vmask`` (B, V)
        lets the fused mode skip empty slots (their output is 0)."""
        b, v, c = pillars.shape
        if mode == 'fused':
            row_mask = None if vmask is None else vmask.reshape(b * v).contiguous()
            out = memory_lookup_fused(pillars.reshape(b * v, c).contiguous(),
                                      self.weight.contiguous(), k, row_mask)
            return {'output': out.reshape(b, v, c).to(pillars.dtype)}
        if mode != 'exact':
            raise ValueError(f'TOPK_MODE {mode!r} is not ported (fused, exact)')
        logits = torch.einsum('bvc,mc->bvm', pillars, self.weight)
        vals, idx = torch.topk(logits, k, dim=-1)
        cand = self.weight.to(torch.bfloat16)[idx]                     # (B, V, k, C)
        agg_w = torch.softmax(vals, dim=-1).to(torch.bfloat16)
        out = (agg_w[..., None] * cand).float().sum(dim=-2)
        return {'output': out.to(torch.bfloat16).to(pillars.dtype)}
