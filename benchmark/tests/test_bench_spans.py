"""The metrics that read the program's own spans and counters
(``harness/spans.py``): their values on a synthetic record of two requests
and a small trace; nothing to read without the recorder, with an empty
record, or (the idle shares) where the trace's launches disagree with the
program's count. On the card (``-m cuda``), a short traced run of each
cell at its own size: the program's stage and post-processing spans read
within 5% of the benchmark's own CUDA events on the stages' boundaries (at
a toy size the events' few microseconds of host work between a hook and
the span around it are a share of stages that are launch overhead)."""

import json
import time
from types import SimpleNamespace

import pytest

from harness.spec import BENCH_DIR, REPO_ROOT, load_reader
from harness.trace import Trace
from test_bench_stats import _Event

CELLS = [w['name'] for w in json.loads((REPO_ROOT / 'BENCHMARK.json').read_text())['workloads']]
SPAN_METRICS = ('nms_iou_ms.infer', 'nms_suppress_ms.infer', 'nms_rounds.infer',
                'nms_live.infer', 'host_syncs.infer', 'post_idle.infer', 'forward_idle.infer')


def _request(first_id, request, t0, rounds):
    """A request of two scans (``rounds`` a scan) starting at ``t0`` ns."""
    spans = []

    def add(name, parent, start, end, device_ms=None, counters=None, attrs=None):
        spans.append({'name': name, 'id': first_id + len(spans), 'parent': parent,
                      'request': request, 'start_ns': t0 + start, 'end_ns': t0 + end,
                      'device_ms': device_ms, 'attrs': attrs or {},
                      'counters': counters or {}})
        return spans[-1]['id']

    root = add('pipeline', None, 0, 1000, 50.0)
    add('voxelize', root, 0, 100, 1.0)
    add('vfe', root, 100, 200, 1.0)
    post = add('post', root, 300, 900, 40.0)
    for scan, r in enumerate(rounds):
        nms = add('nms', post, 300 + 300 * scan, 600 + 300 * scan, 20.0,
                  {'nms.live': 4096, 'host_syncs': 3}, {'scan': scan})
        add('nms.iou', nms, 310 + 300 * scan, 400 + 300 * scan, 15.0)
        add('nms.suppress', nms, 400 + 300 * scan, 550 + 300 * scan, 2.0 + scan,
            {'nms.rounds': r, 'host_syncs': r})
    return spans


RECORD = _request(0, 0, 0, (10, 20)) + _request(100, 1, 2000, (30, 40))


def _trace():
    # device busy: 0-150 and 2000-2150 (the forward), 320-420 and 2400-2700 (post)
    events = [_Event('void k(float*)', s, e - s)
              for s, e in [(0, 150), (320, 420), (2000, 2150), (2400, 2700)]]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    return Trace(prof, windows=[(0, 3000)], requests=[(0, 1000), (2000, 3000)])


def _read(name, rec):
    return load_reader(name, [BENCH_DIR])(rec)


@pytest.fixture
def recorded(monkeypatch):
    from hvpr_tpu_torch.utils import profiler
    monkeypatch.setattr(profiler, 'record', lambda: [dict(s) for s in RECORD])
    return SimpleNamespace(trace=_trace(), launches_match=True)


def test_the_readers_on_a_synthetic_record(recorded):
    got = {name: _read(name, recorded) for name in SPAN_METRICS}
    assert got['nms_iou_ms.infer'] == pytest.approx(30.0)          # 2 scans x 15
    assert got['nms_suppress_ms.infer'] == pytest.approx(5.0)      # 2 + 3 a request
    assert got['nms_rounds.infer'] == pytest.approx(25.0)          # (10+20+30+40) / 4
    assert got['nms_live.infer'] == pytest.approx(4096)
    assert got['host_syncs.infer'] == pytest.approx(25.0 * 2 + 3 * 2)   # rounds + 3 a scan
    # post: 300-900 and 2300-2900, busy 100 and 300 of 1200
    assert got['post_idle.infer'] == pytest.approx(100.0 * (1 - 400 / 1200))
    # forward: 0-200 and 2000-2200, busy 150 and 150 of 400
    assert got['forward_idle.infer'] == pytest.approx(100.0 * (1 - 300 / 400))


def test_nothing_to_read_without_the_recorder_or_its_record(recorded, monkeypatch):
    from hvpr_tpu_torch.utils import profiler
    monkeypatch.setattr(profiler, 'record', lambda: [])
    assert all(_read(name, recorded) is None for name in SPAN_METRICS)
    monkeypatch.delattr(profiler, 'record')                         # an older program
    assert all(_read(name, recorded) is None for name in SPAN_METRICS)


def test_idle_shares_are_left_out_where_the_launches_disagree(recorded):
    recorded.launches_match = False
    assert _read('post_idle.infer', recorded) is None
    assert _read('forward_idle.infer', recorded) is None
    assert _read('nms_rounds.infer', recorded) == pytest.approx(25.0)
    recorded.trace = None
    assert _read('post_idle.infer', recorded) is None


def test_device_times_are_left_out_off_the_card(monkeypatch):
    from hvpr_tpu_torch.utils import profiler
    monkeypatch.setattr(profiler, 'record',
                        lambda: [dict(s, device_ms=None) for s in RECORD])
    rec = SimpleNamespace(trace=None, launches_match=False)
    assert _read('nms_iou_ms.infer', rec) is None
    assert _read('nms_live.infer', rec) == pytest.approx(4096)


@pytest.mark.cuda
@pytest.mark.parametrize('name', CELLS)
def test_the_programs_spans_agree_with_the_stage_events(card, name):
    from harness.run_cell import run_cell
    from harness.spans import program_spans, request_device_ms
    from harness.spec import Cell
    from harness.trace import profiled
    from hvpr_tpu_torch.utils import profiler
    with profiled(True):                 # the harness's device-only profile
        assert profiler.recording()
    profiler.clear()
    result = run_cell(Cell(name), 2 ** 31 + 11, 5.0, True, 'cuda', time.perf_counter(),
                      lambda m: None)
    assert result['correct'], result['checks']
    metrics = {k: v['value'] for k, v in result['metrics'].items()}
    assert set(SPAN_METRICS) <= set(metrics), sorted(metrics)
    spans = program_spans()
    for span, metric in [('vfe', 'vfe_ms.infer'), ('map_to_bev_module', 'map_to_bev_ms.infer'),
                         ('backbone_2d', 'backbone_2d_ms.infer'), ('dense_head', 'head_ms.infer'),
                         ('post', 'post_ms.infer')]:
        ms = request_device_ms(spans, span)
        program = sum(ms) / len(ms)
        assert abs(program - metrics[metric]) <= 0.05 * metrics[metric], (span, program,
                                                                          metrics[metric])
    batch = int(Cell(name).traffic['batch'])
    assert metrics['host_syncs.infer'] == pytest.approx(
        batch * (metrics['nms_rounds.infer'] + 3))
