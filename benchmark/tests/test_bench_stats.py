"""Statistics over a window: every request counts, and busy time is a union."""

import pytest

from harness.stats import mean, percentile, rate
from harness.trace import covered, union


def test_tail_is_taken_over_all_requests():
    values = list(range(1, 201))                  # 200 requests, ms
    assert percentile(values, 95) == 190          # 10 requests beyond it
    assert percentile(values[::-1], 95) == 190    # order does not matter
    assert percentile([7.0], 95) == 7.0
    assert percentile([], 95) is None
    slow = values[:-1] + [10_000]                 # one stall moves the max, not p95
    assert percentile(slow, 95) == 190
    assert percentile(values + [10_000] * 11, 95) == 10_000


def test_rate_is_over_the_whole_window():
    assert rate(80, 4.0) == 20.0
    assert rate(80, 0.0) is None
    assert mean([1.0, 2.0, 3.0]) == 2.0


@pytest.mark.parametrize('intervals', [
    [(0, 10), (5, 15), (12, 20)],                 # chained overlaps
    [(0, 10), (2, 3), (4, 5)],                    # nested
    [(0, 10)] * 5,                                # the same record five times
    [(8, 9), (0, 2), (1, 4)],                     # out of order
])
def test_idle_from_a_union_cannot_go_negative(intervals):
    window = (0, 10)
    merged = union(intervals)
    busy = covered(merged, *window)
    summed = sum(min(e, 10) - max(s, 0) for s, e in intervals if e > 0 and s < 10)
    assert 0 <= busy <= window[1] - window[0]
    assert busy <= summed
    assert 1 - busy / (window[1] - window[0]) >= 0
    assert all(a[1] < b[0] for a, b in zip(merged, merged[1:]))


def test_union_matches_a_sweep():
    merged = union([(0, 4), (3, 6), (10, 12), (11, 11)])
    assert merged == [(0, 6), (10, 12)]
    assert covered(merged, 2, 11) == 5


def test_the_traces_bisection_equals_the_plain_union():
    import numpy as np
    from harness.trace import Trace
    rng = np.random.default_rng(0)
    starts = rng.integers(0, 10_000, 400)
    intervals = [(int(s), int(s + d)) for s, d in zip(starts, rng.integers(0, 60, 400))]
    trace = Trace.__new__(Trace)
    trace.merged = union(intervals)
    trace._starts = np.array([s for s, _ in trace.merged])
    trace._ends = np.array([e for _, e in trace.merged])
    trace._cum = np.concatenate([[0], np.cumsum(trace._ends - trace._starts)])
    for lo, hi in [(0, 10_100), (-5, 3), (500, 600), (1234, 1234), (9_990, 20_000)]:
        assert trace._covered(lo, hi) == covered(trace.merged, lo, hi)


class _Event:
    def __init__(self, name, start, dur, device='DeviceType.CUDA'):
        self._n, self._s, self._d, self._dev = name, start, dur, device

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._dev


def test_trace_reduction_from_overlapping_records():
    from types import SimpleNamespace

    from harness.trace import Trace
    events = [_Event('void segment_sweep_kernel<2, true>(float*)', 100, 50),
              _Event('void segment_sweep_kernel<2, true>(float*)', 120, 50),   # overlaps
              _Event('memory_lookup_kernel(float*)', 300, 100),
              _Event('cudaLaunchKernel', 90, 5, device='DeviceType.CPU'),     # host record
              _Event('void at::native::fill(float*)', 900, 200)]              # past the window
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    trace = Trace(prof, windows=[(0, 1000)], requests=[(50, 450), (600, 1000)],
                  marks=[(50, 'begin'), (200, 'vfe:start'), (420, 'dense_head:end'),
                         (450, 'end')])
    assert trace.busy_s() * 1e9 == pytest.approx(70 + 100 + 100)   # union, clipped
    assert 0 <= 1 - trace.busy_s() / trace.span_s() <= 1
    assert trace.launches()['segment_sweep'] == 2 and trace.launches()['memory_lookup'] == 1
    assert trace.inside_share() < 1
    gaps = dict(trace.idle_gaps(ranges=trace.requests))
    assert gaps['host: voxelize'] * 1e9 == pytest.approx(50)                 # 50-100
    assert gaps['host: vfe'] * 1e9 == pytest.approx(130)                     # 170-300
    assert gaps['host: after dense_head'] * 1e9 == pytest.approx(50)  # 400-450
    assert gaps['host: between requests'] * 1e9 == pytest.approx(300)        # 600-900
