"""The program's own spans beside the benchmark's stage events, in one traced
run of a cell on the card.

    python3 benchmark/tools/span_pairs.py --workload <cell> --seed <n> --seconds <s>

Runs the cell once as ``--trace 1`` does and prints one JSON line: whether
``torch.profiler``'s flag, the program's recorder switch, is set under the
harness's device-only profile (``harness/trace.py`` ``profiled``); the
run's ``correct`` and metrics; for each span name the device ms a request
(summed over the request's spans of that name, mean over the window's
requests); and the pairs of a stage's or post-processing's program span
with the hook metric that reads the same stage. The benchmark's own runs
never run this.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
BENCH_DIR = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent)]
# the kernels' build directory of benchmark/run.py, shared with its runs
os.environ['TORCH_EXTENSIONS_DIR'] = str(BENCH_DIR.parent / 'build' / 'cache' / 'torch_extensions')

import torch  # noqa: E402

from harness.run_cell import run_cell  # noqa: E402
from harness.spans import program_spans, request_device_ms  # noqa: E402
from harness.spec import Cell  # noqa: E402
from harness.trace import profiled  # noqa: E402

PAIRS = {'vfe': 'vfe_ms.infer', 'map_to_bev_module': 'map_to_bev_ms.infer',
         'backbone_2d': 'backbone_2d_ms.infer', 'dense_head': 'head_ms.infer',
         'post': 'post_ms.infer'}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, default=51.0)
    args = parser.parse_args()
    torch.set_num_threads(1)
    from hvpr_tpu_torch.utils import profiler
    with profiled(True):
        flag = profiler.recording()
    profiler.clear()
    result = run_cell(Cell(args.workload), args.seed, args.seconds, True, 'cuda', T_START,
                      lambda m: print(m, file=sys.stderr, flush=True))
    spans = program_spans() or []
    metrics = {k: v['value'] for k, v in result['metrics'].items()}
    span_ms = {}
    for name in sorted({s['name'] for s in spans}):
        ms = request_device_ms(spans, name)
        span_ms[name] = sum(ms) / len(ms) if ms else None
    pairs = {name: {'span_ms': span_ms.get(name), 'hook_ms': metrics.get(metric),
                    'ratio': (span_ms[name] / metrics[metric]
                              if span_ms.get(name) and metrics.get(metric) else None)}
             for name, metric in PAIRS.items()}
    print(json.dumps({'workload': args.workload, 'seed': args.seed,
                      'device': torch.cuda.get_device_name(), 'flag_under_cuda_profile': flag,
                      'correct': result['correct'], 'metrics': metrics, 'span_ms': span_ms,
                      'pairs': pairs, 'breakdown': result.get('breakdown')}), flush=True)


if __name__ == '__main__':
    main()
