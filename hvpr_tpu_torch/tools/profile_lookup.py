"""Profile of the fused memory lookup on the card (port of
``tools/profile_lookup.py``).

    python -m hvpr_tpu_torch.tools.profile_lookup [--batch 16] [--iters 10]
        [--out FILE] [--device cuda]

At serving shapes, R = batch x MAX_NUMBER_OF_VOXELS rows of seeded normal
pillars against a seeded normal memory of hvpr.yaml's NUM_M x
NUM_PT_FEATURES at its NUM_K (16 x 16,000 rows, M = 2000, C = 64, k = 20):
``memory_lookup_fused`` (kernel K2, one kernel for the JAX package's three
``pallas_call``s, whose separate copies in the JAX tool are a benchmark's,
not kernels of the port), its plain version, and the yardstick of
``chip_smoke.py``: ``scaled_dot_product_attention`` (bf16, scale 1) of
each scan's rows over the memory with the columns K2 selects as its mask,
built outside the timed window; timed only, the port never calls it. Each
row has its ms, GFLOP, GB and utilization (null on the CPU); K2's also its
bound (``utils.flops.memory_lookup_work``).
"""

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..models import DatasetMeta
from ..ops.memory_lookup import memory_lookup_fused, memory_lookup_plain
from ..utils import flops
from .profile_stages import cli, counted, device_record, load_config, median_ms, region_row


def run(cfg=None, batch=16, device='cuda', iters=10, seed=0):
    """{'rows', 'm', 'c', 'k', 'stages': rows, ...}."""
    cfg = load_config() if cfg is None else cfg
    device = resolve_device(device)
    record, peaks = device_record(device)
    mb = cfg.MODEL.MAP_TO_BEV
    m, c, k = int(mb.NUM_M), int(mb.NUM_PT_FEATURES), int(mb.NUM_K)
    v = DatasetMeta(cfg.DATA_CONFIG, cfg.CLASS_NAMES).max_voxels
    rng = np.random.default_rng(seed)
    pillars = torch.from_numpy(rng.normal(size=(batch * v, c)).astype(np.float32)).to(device)
    memory = torch.from_numpy(rng.normal(size=(m, c)).astype(np.float32)).to(device)

    with torch.no_grad():
        _, thresh, selected = memory_lookup_fused(pillars, memory, k, return_stats=True)
        mem_bf = memory.to(torch.bfloat16)
        queries, masks = [], []
        for rows, th in zip(pillars.split(v), thresh.split(v)):
            q = rows.to(torch.bfloat16)
            masks.append(((q.double() @ mem_bf.double().t()).float() >= th[:, None])[None])
            queries.append(q[None])

    def yardstick():
        return [F.scaled_dot_product_attention(q, mem_bf[None], mem_bf[None], attn_mask=mask,
                                               scale=1.0)
                for q, mask in zip(queries, masks)]

    work = flops.memory_lookup_work(batch * v, batch * v, m, c, float(selected.sum()))
    bound_ms, bound_by, _ = flops.work_bound(work)
    rows = []
    with torch.no_grad():
        for name, fn in (('full fused lookup', lambda: memory_lookup_fused(pillars, memory, k)),
                         ('plain', lambda: memory_lookup_plain(pillars, memory, k)),
                         ('sdpa yardstick', yardstick)):
            _, cnt = counted(fn)
            rows.append(region_row(name, median_ms(fn, device, iters), cnt, peaks))
    rows[0].update(bound_ms=round(bound_ms, 4), bound_by=bound_by)
    return {'rows': batch * v, 'm': m, 'c': c, 'k': k,
            'selected_per_row': round(float(selected.float().mean()), 3), 'stages': rows,
            **record}


def main(argv=None):
    return cli(__doc__.splitlines()[0], run, 16, 10, argv)


if __name__ == '__main__':
    main()
