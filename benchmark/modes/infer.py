"""Closed loop of batches: the next batch is sent when the last one's
detections are on the host. The pool's batches take turns; each is copied
from pinned host memory inside its request. The window closes with the
first request that ends past ``seconds``; every request counts."""

import time

from modes.detect import check, prepare, samples  # noqa: F401  (the mode's set-up and check)


def window(ctx):
    prog, pool, rec = ctx.program, ctx.pool, ctx.rec
    latencies, order = [], []
    t0 = time.perf_counter()
    i = 0
    with ctx.range('bench.window'):
        while True:
            idx = i % len(pool)
            t_req = time.perf_counter()
            with ctx.range('bench.request'):
                points = pool[idx].to(ctx.device, non_blocking=True)
                ctx.detections[idx] = prog.detect(points, ctx.mask, key=idx)
            t = time.perf_counter()
            latencies.append((t - t_req) * 1e3)
            order.append(idx)
            i += 1
            if t - t0 >= ctx.seconds:
                break
    rec.window_s = t - t0
    rec.requests = order
    rec.latencies_ms = latencies
    rec.attempted_scans = rec.completed_scans = i * ctx.batch
