"""What a detection mode (``infer``) shares with any other that serves
scans: the set-up requests, the sample the check compares, and the check
itself (the reference's head and its NMS judge, :mod:`reference.compare`)."""

import numpy as np

from reference.compare import compare
from reference.model import Reference


def prepare(ctx):
    """One request of each of the pool's inputs, so that the window meets
    no input for the first time; the first builds the kernels on a
    checkout's first run."""
    for batch in ctx.pool:
        ctx.program.detect(batch.to(ctx.device), ctx.mask)


def sample_scans(seed, requests, batch, count):
    """``count`` (pool index, scan) pairs among the finished requests, drawn
    from the seed."""
    done = sorted(set(requests))
    pairs = [(i, s) for i in done for s in range(batch)]
    rng = np.random.default_rng([int(seed), 17])
    pick = rng.choice(len(pairs), size=min(count, len(pairs)), replace=False)
    return [pairs[k] for k in sorted(pick)]


def samples(ctx, seed):
    """The sampled scans' inputs, the program's head outputs and detections,
    taken before the program is freed."""
    chosen = sample_scans(seed, ctx.rec.requests, ctx.batch, int(ctx.cell.file['compare_scans']))
    out = []
    for idx, s in chosen:
        cls, boxes = ctx.program.captured[idx]
        det = ctx.detections[idx]
        out.append((ctx.pool_np[idx, s], cls[s, :, 0], boxes[s, :, :7],
                    {k: v[s] for k, v in det.items()}))
    return out


def check(cell, items, weights, device, say):
    reference = Reference(cell.config, weights, device)
    numbers, kept = compare(items, reference, cell.config['MODEL']['POST_PROCESSING'])
    say(f'check: {len(items)} scans compared; detections the judge keeps a scan: '
        f'min {min(kept)}, max {max(kept)}')
    return numbers
