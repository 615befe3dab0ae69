"""One run of one cell: set-up, the measured window, the check, the result.

Set-up (counted in ``setup_s``, from the process start): the program and its
seeded weights, the traffic's pool of inputs in pinned host memory, and the
mode's first requests of the cell's own shape (``modes/<mode>.py``
``prepare``), which build the kernel libraries into the checkout's
``build/`` on its first run there. Then the mode's window. After it: the
memory peak, the look for JAX in ``sys.modules``, with ``--trace 1`` the
trace's reduction and the window's FLOPs by the configuration's work module
(none where it names none), then the program is freed and the reference
that the configuration names judges a sample, drawn from the seed, of what
the window finished (the mode's ``samples`` and ``check``).
The metric readers of ``metrics/`` get one record of all of it.
"""

import contextlib
import importlib
import sys
import time
import types

import torch

from harness import stats
from harness.program import Program, StageEvents
from harness.trace import Trace, profiled
from traffic.scans import pool as make_pool
from work.flops import card_rates, power_limit

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'hvpr_tpu')


def forbidden_modules():
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    return sorted(n for n in list(sys.modules) if n.split('.')[0] in FORBIDDEN)


def cli_flags():
    """The CLIs' backend flags, torch's defaults: TF32 for cuDNN's
    convolutions, not for matmuls; cuDNN picks its algorithms by heuristics."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = False
    return {'cudnn.allow_tf32': True, 'cuda.matmul.allow_tf32': False,
            'cudnn.benchmark': False, 'cudnn.deterministic': False}


class Context:
    """What a mode's window reads and writes."""

    def __init__(self, cell, program, pool, device, seconds, trace, say):
        self.cell = cell
        self.traffic = cell.traffic
        self.program = program
        self.pool = pool
        self.device = device
        self.seconds = seconds
        self.trace = trace
        self.say = say
        self.batch = int(cell.traffic['batch'])
        n = int(cell.traffic['points_per_scan'])
        self.mask = torch.ones(self.batch, n, dtype=torch.bool, device=device)
        self.detections = {}
        self.ranges = {}
        self.rec = types.SimpleNamespace()

    @contextlib.contextmanager
    def range(self, name):
        """A host range of a traced run on the trace's clock
        (``time.time_ns``): 'bench.window' or 'bench.request'."""
        if not self.trace:
            yield
            return
        start = time.time_ns()
        try:
            yield
        finally:
            self.ranges.setdefault(name, []).append((start, time.time_ns()))


def run_cell(cell, seed, seconds, trace, device, t_start, say, program_factory=None):
    """Run the cell once; returns the result dict (the last line's object)."""
    device = torch.device(device)
    on_card = device.type == 'cuda'
    flags = cli_flags()
    kind = torch.cuda.get_device_name(device) if on_card else 'cpu'
    say(f'torch {torch.__version__}, CUDA {torch.version.cuda}, device {kind}, '
        f'power limit {power_limit() if on_card else None}, flags {flags}')

    from hvpr_tpu_torch.ops import _kernels
    mode = importlib.import_module(f'modes.{cell.mode}')
    t_imported = time.perf_counter()
    program = (program_factory or Program)(cell, seed, device)
    t_program = time.perf_counter()
    cfg = cell.config
    pcr = cfg['DATA_CONFIG']['POINT_CLOUD_RANGE']
    pool_np, _ = make_pool(cell.traffic, seed, pcr)
    pool = [torch.from_numpy(b) for b in pool_np]
    if on_card:
        pool = [b.pin_memory() for b in pool]
    ctx = Context(cell, program, pool, device, seconds, trace, say)
    ctx.pool_np = pool_np
    t_first = time.perf_counter()
    say(f'setup parts: start to the program imported {t_imported - t_start:.3f} s, the '
        f'network and its weights {t_program - t_imported:.3f} s, the traffic '
        f'{t_first - t_program:.3f} s')
    mode.prepare(ctx)
    if on_card:
        torch.cuda.synchronize(device)
    rec = ctx.rec
    rec.warmup_s = time.perf_counter() - t_first
    rec.setup_s = time.perf_counter() - t_start
    say(f'setup: {rec.setup_s:.3f} s, of which the first requests (with any kernel '
        f'build) {rec.warmup_s:.3f} s')

    if trace and on_card:
        program.events = StageEvents()
    counted0 = _kernels.launch_counts()
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    with profiled(trace and on_card) as prof:
        mode.window(ctx)
        if on_card:
            torch.cuda.synchronize(device)
    say(stats_line(rec))
    counted = {k: v - counted0[k] for k, v in _kernels.launch_counts().items()}
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    rec.memory_peak_bytes = peak
    found = forbidden_modules()
    if found:
        raise SystemExit(f'forbidden modules loaded: {found}')

    rec.cell, rec.config, rec.traffic = cell, cfg, cell.traffic
    rec.batch = ctx.batch
    rec.rates = card_rates(kind) if on_card else None
    rec.spans = program.events.spans_ms() if program.events is not None else {}
    rec.trace = None
    rec.launches_counted = counted
    if prof is not None:
        rec.trace = Trace(prof, ctx.ranges['bench.window'], ctx.ranges['bench.request'],
                          program.events.host_marks if program.events is not None else ())
        launches = rec.trace.launches()
        rec.launches_match = all(launches[k] == counted.get(k, 0) for k in launches)
        say(f'trace: {len(rec.trace.device)} device records (records on the device / '
            f'not: {rec.trace.kinds}); share of the device time inside the window '
            f'{rec.trace.inside_share():.6f}')
        say('trace launches of the hand-written kernels against the program\'s count: '
            + ', '.join(f'{k} {launches[k]}/{counted.get(k, 0)}' for k in launches
                        if launches[k] or counted.get(k, 0))
            + (' -- all agree' if rec.launches_match else
               ' -- DISAGREE: the trace dropped records; idle and roofline shares left out'))
    work = cell.work()
    if trace and work is not None:
        flops = {idx: work.batch_flops(cfg, pool_np[idx]) for idx in sorted(set(rec.requests))}
        rec.flops = sum(flops[idx] for idx in rec.requests)
        say(f'work: dense FLOPs a request by pool batch {flops}; over the window {rec.flops!r}')

    # the check, with the program's state freed
    items = mode.samples(ctx, seed)
    weights = program.weights
    program.close()
    del program, ctx
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = mode.check(cell, items, weights, device, say)
    say(f'check: {time.perf_counter() - t_check:.3f} s')
    limits = cell.file['limits']
    correct = all(numbers[k] <= float(limits[k]) for k in limits)

    metrics = {}
    for entry, read in cell.readers(trace):
        value = read(rec)
        if value is None:
            say(f'metric {entry["name"]}: nothing to read in this run')
            continue
        metrics[entry['name']] = {'value': float(value), 'unit': entry['unit']}
    result = {'correct': bool(correct), 'attempted': int(rec.attempted_scans),
              'failed': int(rec.attempted_scans - rec.completed_scans),
              'metrics': metrics,
              'device': {'platform': 'gpu' if on_card else 'cpu', 'kind': kind,
                         'count': 1, 'memory_peak_bytes': int(peak)}}
    if rec.trace is not None:
        result['device']['busy_s'] = rec.trace.busy_s()
        result['device']['window_s'] = rec.trace.span_s()
        result['breakdown'] = {'device_ops': rec.trace.top_device_ops(),
                               'idle_gaps': rec.trace.idle_gaps(ranges=rec.trace.requests)}
    result['checks'] = {k: {'value': numbers[k], 'limit': float(limits[k])} for k in limits}
    return result


def stats_line(rec):
    return (f'window {rec.window_s:.3f} s, {len(rec.latencies_ms)} requests, latency ms '
            f'p50 {stats.percentile(rec.latencies_ms, 50):.3f} '
            f'p95 {stats.percentile(rec.latencies_ms, 95):.3f}')
