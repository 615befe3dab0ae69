"""The readings that the limits of a cell's check are set from.

    python3 benchmark/tools/readings.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--fault NAME --fault-seeds 1,2,3] [--out FILE]

In one process on the card, at the cell's own size:

- ``program``: for each seed, the numbers a run of that seed compares: the
  program answers the batches of the seed's pool that hold the scans a run
  samples (a run's window finishes every batch of the pool);
- ``control``: the reference computed in the nearest precision below the
  configuration's, put in the program's place (:mod:`harness.control`),
  compared the same way;
- ``fault``: a run with a fault of :mod:`harness.faults` planted underneath.

One JSON line a reading: ``{"side": ..., "seed": n, "numbers": {...}}``. The
lower reading of a number is the largest the program gives, the upper the
smallest the control gives; ``PERF.md`` records
both and the limit set between them. The benchmark's own runs never run
this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent)]

import torch  # noqa: E402

from harness.control import Control  # noqa: E402
from harness.faults import FAULTS  # noqa: E402
from harness.program import Program  # noqa: E402
from harness.run_cell import cli_flags, run_cell  # noqa: E402
from harness.spec import Cell  # noqa: E402
from modes.detect import check, sample_scans, to_compare  # noqa: E402
from traffic.scans import pool as make_pool  # noqa: E402


def _say(msg):
    print(msg, file=sys.stderr, flush=True)


def detection_readings(cell, seed, device, control):
    pool_np, _ = make_pool(cell.traffic, seed, cell.config['DATA_CONFIG']['POINT_CLOUD_RANGE'])
    batch, n = int(cell.traffic['batch']), int(cell.traffic['points_per_scan'])
    program = Program(cell, seed, device)
    weights = program.weights
    side = program
    if control:
        program.close()
        side = Control(cell, weights, device)
    chosen = sample_scans(seed, range(len(pool_np)), batch, int(cell.file['compare_scans']))
    mask = torch.ones(batch, n, dtype=torch.bool, device=device)
    dets = {idx: side.detect(torch.from_numpy(pool_np[idx]).to(device), mask, key=idx)
            for idx in sorted({i for i, _ in chosen})}
    items = to_compare(chosen, pool_np, side.captured, dets, len(weights))
    side.close()
    return check(cell, items, weights, device, _say)


def readings(cell, seed, device, side, fault=None):
    if side in ('control', 'program'):
        return detection_readings(cell, seed, device, side == 'control')
    result = run_cell(cell, seed, 0.0, False, device, time.perf_counter(), _say,
                      program_factory=FAULTS[fault] if fault else None)
    return {k: v['value'] for k, v in result['checks'].items()}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', default='')
    parser.add_argument('--control-seeds', default='')
    parser.add_argument('--fault', default=None, choices=sorted(FAULTS))
    parser.add_argument('--fault-seeds', default='')
    parser.add_argument('--out', default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print('no CUDA device', file=sys.stderr)
        return 3
    cli_flags()
    cell = Cell(args.workload)

    def seeds(text):
        return [int(s) for s in text.split(',') if s]

    plan = ([('program', s) for s in seeds(args.seeds)]
            + [('control', s) for s in seeds(args.control_seeds)]
            + [(f'fault:{args.fault}', s) for s in seeds(args.fault_seeds)])
    out = open(args.out, 'a') if args.out else None
    try:
        for side, seed in plan:
            t = time.perf_counter()
            kind = side.split(':')[0]
            numbers = readings(cell, seed, 'cuda', kind, args.fault if kind == 'fault' else None)
            line = json.dumps({'cell': cell.name, 'side': side, 'seed': seed,
                               'numbers': numbers, 'seconds': time.perf_counter() - t})
            print(line, flush=True)
            if out:
                out.write(line + '\n')
                out.flush()
            torch.cuda.empty_cache()
    finally:
        if out:
            out.close()
    return 0


if __name__ == '__main__':
    sys.exit(main())
