"""The device trace of a traced run, reduced to what the metrics read.

``torch.profiler`` records the window's device activity only (CUDA: kernels,
copies, memsets; no host operations, whose recording would slow the
host-bound paths several times over). The benchmark keeps its own host
ranges on the same clock as the trace's (``time.time_ns``, the Unix epoch
in nanoseconds): the window, each request, and each stage boundary of the
program's hooks. Busy time is the union of the device intervals, never a
sum of durations, so overlapping records cannot push the idle share below
0. Each hand-written kernel is found in the trace by the name of the CUDA
function that its wrapper launches exactly once a call
(``KERNEL_MARKERS``), and its launches are held against the program's own
count (``ops/_kernels.launch_counts``): the shares read from the trace are
reported only where the two agree, so dropped records are caught rather
than read as idle time.
"""

import bisect
import contextlib

import numpy as np

# the port's launch-count name -> the CUDA function its wrapper launches
# once a call (csrc/*.cu)
KERNEL_MARKERS = {
    'segment_sweep': 'segment_sweep_kernel',
    'memory_lookup': 'memory_lookup_kernel',
    'bev_canvas': 'canvas_kernel',
    'ball_query': 'ball_query_kernel',
    'fps_chunks': 'fps_',
    'memory_recon_fwd': 'recon_fwd_kernel',
    'memory_recon_bwd': 'bwd_chain_kernel',
    'bucket_threshold': 'bucket_threshold_kernel',
    'masked_attend_fwd': 'masked_attend_fwd_kernel',
    'masked_attend_pairs': 'masked_attend_pairs_kernel',
    'masked_attend_bwd': 'pair_reduce_kernel',
    'three_nn_bucket': 'three_nn_kernel',
    'gather_grad': 'k12_setup',
}
DEVICE_KINDS = ('kernel', 'gpu_memcpy', 'gpu_memset')


def union(intervals):
    """Merged, sorted [(start, end)] of possibly overlapping intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def covered(merged, lo, hi):
    """Length of ``merged`` (from :func:`union`) inside [lo, hi]."""
    return sum(max(0, min(e, hi) - max(s, lo)) for s, e in merged if e > lo and s < hi)


def kernel_family(name):
    """The counted kernel a device function belongs to, or None."""
    for counted, marker in KERNEL_MARKERS.items():
        if name.startswith(marker) or f' {marker}' in name or f'::{marker}' in name:
            return counted
    return None


@contextlib.contextmanager
def profiled(enabled):
    """A ``torch.profiler`` of the device's activity over the block when
    ``enabled``; yields the profiler or None."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield prof


def _on_device(e):
    kind = e.activity_type() if hasattr(e, 'activity_type') else None
    if kind is not None:
        return str(kind) in DEVICE_KINDS
    return 'CUDA' in str(e.device_type())


def _host_label(label):
    """What the host was doing after a stage mark."""
    if label == 'begin':
        return 'host: voxelize'
    if label == 'end':
        return 'host: between requests'
    stage, edge = label.rsplit(':', 1)
    return f'host: {stage}' if edge == 'start' else f'host: after {stage}'


class Trace:
    """Device intervals of one window, with the benchmark's host ranges:
    ``windows`` and ``requests`` [(start_ns, end_ns)], ``marks`` [(ns,
    stage label)] of the hooks."""

    def __init__(self, prof, windows, requests, marks=()):
        self.device = []            # (start_ns, end_ns, name)
        self.kinds = {}
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            on_device = _on_device(e)
            self.kinds[on_device] = self.kinds.get(on_device, 0) + 1
            if on_device:
                start = int(e.start_ns())
                self.device.append((start, start + int(e.duration_ns()), name))
        self.windows, self.requests = list(windows), list(requests)
        self.marks = sorted(marks)
        self.device.sort()
        self.merged = union([(s, e) for s, e, _ in self.device])
        self._starts = np.array([s for s, _ in self.merged], dtype=np.int64)
        self._ends = np.array([e for _, e in self.merged], dtype=np.int64)
        self._cum = np.concatenate([[0], np.cumsum(self._ends - self._starts)])

    def _covered(self, lo, hi):
        """:func:`covered` of the merged device intervals, by bisection."""
        i = int(np.searchsorted(self._ends, lo, side='right'))
        j = int(np.searchsorted(self._starts, hi, side='left'))
        if i >= j:
            return 0
        total = int(self._cum[j] - self._cum[i])
        total -= max(0, lo - int(self._starts[i]))
        total -= max(0, int(self._ends[j - 1]) - hi)
        return total

    def window_ns(self):
        return (min(s for s, _ in self.windows), max(e for _, e in self.windows))

    def inside_share(self):
        """Share of the traced device time that lies inside the window: near
        1 when the trace's clock and the host's agree."""
        total = float(self._cum[-1])
        return self._covered(*self.window_ns()) / total if total else 0.0

    def busy_s(self, ranges=None):
        """Device-busy seconds inside the window (or inside ``ranges``)."""
        ranges = ranges if ranges is not None else [self.window_ns()]
        return sum(self._covered(lo, hi) for lo, hi in union(ranges)) * 1e-9

    def span_s(self, ranges=None):
        ranges = ranges if ranges is not None else [self.window_ns()]
        return sum(e - s for s, e in union(ranges)) * 1e-9

    def launches(self):
        """{counted kernel: launches in the window}."""
        lo, hi = self.window_ns()
        out = dict.fromkeys(KERNEL_MARKERS, 0)
        for s, _, name in self.device:
            fam = kernel_family(name)
            if fam is not None and lo <= s <= hi:
                out[fam] += 1
        return out

    def top_device_ops(self, n=10):
        lo, hi = self.window_ns()
        by = {}
        for s, e, name in self.device:
            if lo <= s <= hi:
                by[name] = by.get(name, 0) + (e - s)
        return [[k, v * 1e-9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n=10, ranges=None):
        """The idle time of the device inside the window (or ``ranges``, such
        as the requests' spans), by what the host was doing at each gap's
        middle (the stage its hooks had last entered or left):
        [[name, seconds]] for the ``n`` names with most idle time."""
        ranges = union(ranges if ranges is not None else [self.window_ns()])
        gaps = []
        for lo, hi in ranges:
            cur = lo
            i = int(np.searchsorted(self._ends, lo, side='right'))
            j = int(np.searchsorted(self._starts, hi, side='left'))
            for s, e in self.merged[i:j]:
                if s > cur:
                    gaps.append((cur, s))
                cur = max(cur, e)
            if cur < hi:
                gaps.append((cur, hi))
        times = [t for t, _ in self.marks]
        by = {}
        for lo, hi in gaps:
            k = bisect.bisect_right(times, (lo + hi) // 2) - 1
            name = _host_label(self.marks[k][1]) if k >= 0 else 'host: before the first mark'
            by[name] = by.get(name, 0) + (hi - lo)
        return [[k, v * 1e-9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
