"""Run one cell of the benchmark once, on the card this process is started on.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result's JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
compared number with its limit); the compared numbers are also the last
lines of standard error. Without a CUDA device, with fewer than the cell's
chips, without the program beside it, or with JAX loaded once the window has
closed, it exits non-zero and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def say(msg):
    print(msg, file=sys.stderr, flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    # one process with few threads loads the host: intra-op thread pools
    # spinning beside the program's own host work only add jitter
    os.environ['OMP_NUM_THREADS'] = os.environ['MKL_NUM_THREADS'] = '1'
    # every cache the program or torch writes stays at a fixed place in the checkout
    cache = ROOT / 'build' / 'cache'
    os.environ['TORCH_EXTENSIONS_DIR'] = str(cache / 'torch_extensions')
    os.environ['TRITON_CACHE_DIR'] = str(cache / 'triton')
    os.environ['USE_FLAX'] = '0'
    sys.path[:0] = [str(BENCH_DIR), str(ROOT)]

    from harness.spec import Cell
    cell = Cell(args.workload)
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        say('no CUDA device: the benchmark runs only on the card')
        return 3
    if torch.cuda.device_count() < cell.chips:
        say(f'cell {cell.name} needs {cell.chips} cards, this machine has '
            f'{torch.cuda.device_count()}')
        return 3
    try:
        import hvpr_tpu_torch  # noqa: F401
    except ImportError as e:
        say(f'the program (hvpr_tpu_torch) is not beside the benchmark: {e}')
        return 3

    from harness.run_cell import run_cell
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), 'cuda', T_START, say)
    for name, c in result['checks'].items():
        say(f'check {name} {c["value"]!r} limit {c["limit"]!r}')
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
