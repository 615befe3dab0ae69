"""What a detection mode (``infer``) shares with any other that serves
scans: the set-up requests, the sample the check compares, and the check
itself (the reference that the configuration names, and the NMS judge of
:mod:`reference.compare`)."""

import numpy as np

from reference.compare import compare


def prepare(ctx):
    """One request of each of the pool's inputs, each on the weight draw
    that answers it in the window, so that the window meets no input for
    the first time; the first builds the kernels on a checkout's first
    run."""
    for idx, batch in enumerate(ctx.pool):
        ctx.program.detect(batch.to(ctx.device), ctx.mask, key=idx)


def sample_scans(seed, requests, batch, count):
    """``count`` (pool index, scan) pairs among the finished requests, drawn
    from the seed."""
    done = sorted(set(requests))
    pairs = [(i, s) for i in done for s in range(batch)]
    rng = np.random.default_rng([int(seed), 17])
    pick = rng.choice(len(pairs), size=min(count, len(pairs)), replace=False)
    return [pairs[k] for k in sorted(pick)]


def to_compare(chosen, pool_np, captured, detections, draws):
    """What the check compares of each chosen (pool index, scan): the
    weight draw that answered it (the pool index mod ``draws``), and the
    scan's points, the program's (A, C) class logits and (A, 7) boxes, and
    its detections."""
    out = []
    for idx, s in chosen:
        cls, boxes = captured[idx]
        out.append((idx % draws, (pool_np[idx, s], cls[s], boxes[s, :, :7],
                                  {k: v[s] for k, v in detections[idx].items()})))
    return out


def samples(ctx, seed):
    """The sampled scans' inputs, the program's head outputs and detections,
    taken before the program is freed."""
    chosen = sample_scans(seed, ctx.rec.requests, ctx.batch, int(ctx.cell.file['compare_scans']))
    return to_compare(chosen, ctx.pool_np, ctx.program.captured, ctx.detections,
                      len(ctx.program.weights))


def check(cell, items, weights, device, say):
    """The compared numbers, each the largest over the sampled scans, every
    scan judged by the reference with the weights of its draw
    (``weights[draw]``)."""
    numbers, kept, returned = {}, [], []
    for draw in sorted({d for d, _ in items}):
        reference = cell.reference(weights[draw], device)
        worst, k, r = compare([it for d, it in items if d == draw], reference,
                              cell.config['MODEL']['POST_PROCESSING'])
        numbers = {key: max(numbers.get(key, 0.0), v) for key, v in worst.items()}
        kept += k
        returned += r
        del reference
    say(f'check: {len(items)} scans compared; detections a scan, the judge\'s: min {min(kept)}, '
        f'max {max(kept)}; the program\'s: min {min(returned)}, max {max(returned)}')
    return numbers
