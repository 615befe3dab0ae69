"""The port's spans and counters, and a trace capture (port of
``hvpr_tpu/utils/profiler.py`` ``trace``).

The recorder is on while a ``torch.profiler`` session is active, and at no
other time: each site reads PyTorch's own flag
(``torch.autograd.profiler._is_profiler_enabled``, set by every profile,
whatever its activities). With it off a site costs that one read, and
nothing is allocated.

A span (:func:`span`, :func:`child_span`) holds its name, an id, its
parent's id, the request (one per root span, such as a
``Network.pipeline`` call), the host's start and end from
``time.time_ns`` (the clock of a kineto trace's records) and a few integer
attributes. On a CUDA device it also records a pair of CUDA events on the
current stream; their device ms is read when the record is drained
(:func:`record`), after one ``synchronize``, so recording adds no host read
of a device value. A counter (:func:`count`) adds to the innermost open
span and to a process-wide total (:func:`counters`); :func:`count_device`
does so with a 0-d device tensor, read when the record is drained, after
its ``synchronize``; :func:`host_read` makes a read of a device value on
the host and counts it as ``host_syncs``.

:func:`trace` captures a ``torch.profiler`` trace of a block into
``trace.json`` and the block's spans and counters into ``spans.json``.
"""

import contextlib
import itertools
import json
import os
import time

import torch
from torch.autograd import profiler as _torch_profiler

_OFF = contextlib.nullcontext()
_open = []          # the stack of open spans
_closed = []        # closed spans whose device ms is not read yet
_record = []        # drained spans, as dicts
_deferred = []      # (span or None, counter, 0-d tensor) not read yet
_totals = {}
_span_ids = itertools.count()
_request_ids = itertools.count()


def recording():
    """Whether spans and counters are recorded now."""
    return _torch_profiler._is_profiler_enabled


def _device(like):
    """The CUDA device of a tensor or of a module's first parameter, or None."""
    if isinstance(like, torch.nn.Module):
        like = next(like.parameters(), None)
    if isinstance(like, torch.Tensor) and like.is_cuda:
        return like.device
    return None


class _Span:
    __slots__ = ('name', 'id', 'parent', 'request', 'attrs', 'counters', 'device',
                 'events', 'start_ns', 'end_ns')

    def __init__(self, name, like, attrs):
        self.name = name
        self.attrs = attrs
        self.counters = {}
        self.device = _device(like)
        self.events = None

    def __enter__(self):
        parent = _open[-1] if _open else None
        self.id = next(_span_ids)
        self.parent = parent.id if parent is not None else None
        self.request = parent.request if parent is not None else next(_request_ids)
        self.start_ns = time.time_ns()
        if self.device is not None:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(torch.cuda.current_stream(self.device))
        _open.append(self)
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(self.device))
        self.end_ns = time.time_ns()
        _open.remove(self)
        _closed.append(self)
        return False

    def drained(self):
        return {'name': self.name, 'id': self.id, 'parent': self.parent,
                'request': self.request, 'start_ns': self.start_ns, 'end_ns': self.end_ns,
                'device_ms': (self.events[0].elapsed_time(self.events[1])
                              if self.events is not None else None),
                'attrs': self.attrs, 'counters': self.counters}


def span(name, like=None, **attrs):
    """A span named ``name`` over a ``with`` block, timed on the device of
    ``like`` (a tensor or a module) where that is a CUDA device; keyword
    arguments (``scan``, ``cls``, a sparse conv's widths) are integer
    attributes where given."""
    if not _torch_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, like, {k: int(v) for k, v in attrs.items() if v is not None})


def child_span(parent, module):
    """A :func:`span` over a call of ``module``, named after its attribute in
    the module ``parent`` (``'vfe'``, ``'dense_head'``), timed on
    ``parent``'s device: a stage without weights (MeanVFE,
    HeightCompression) has none of its own."""
    if not _torch_profiler._is_profiler_enabled:
        return _OFF
    name = next(n for n, m in parent.named_children() if m is module)
    return _Span(name, parent, {})


def count(name, n=1):
    """Add ``n`` to the counter ``name`` of the innermost open span and to
    its process-wide total."""
    if not _torch_profiler._is_profiler_enabled:
        return
    if _open:
        own = _open[-1].counters
        own[name] = own.get(name, 0) + n
    _totals[name] = _totals.get(name, 0) + n


def count_device(name, value):
    """:func:`count` of a 0-d integer tensor ``value``, on the device, into
    the innermost open span and the total; it is read when the record is
    drained (:func:`record`), after that one ``synchronize``, so it adds no
    host read. The totals hold it from that drain on."""
    if not _torch_profiler._is_profiler_enabled:
        return
    _deferred.append((_open[-1] if _open else None, name, value))


def host_read(fn, *args):
    """``fn(*args)``, a read of a device value on the host (a sync when the
    value is on the card), counted as ``host_syncs``. Every such read on
    the inference path goes through here."""
    value = fn(*args)
    count('host_syncs')
    return value


def record():
    """The spans closed since :func:`clear`, as dicts in the order they
    were opened (``name``, ``id``, ``parent``, ``request``, ``start_ns``,
    ``end_ns``, ``device_ms`` or None off the card, ``attrs``,
    ``counters``). Drains the closed spans first: one ``synchronize`` of
    each device they were timed on or counted on (:func:`count_device`).
    Calling it again returns the same."""
    if _closed or _deferred:
        devices = {s.device for s in _closed if s.device is not None}
        for dev in devices | {v.device for _, _, v in _deferred if v.is_cuda}:
            torch.cuda.synchronize(dev)
        for owner, name, value in _deferred:
            n = int(value)
            if owner is not None:
                owner.counters[name] = owner.counters.get(name, 0) + n
            _totals[name] = _totals.get(name, 0) + n
        _deferred.clear()
        _record.extend(s.drained() for s in _closed)
        _closed.clear()
        _record.sort(key=lambda s: s['id'])
    return list(_record)


def counters():
    """{counter: total since :func:`clear`}."""
    return dict(_totals)


def clear():
    """Forget the recorded spans and the counters' totals."""
    _closed.clear()
    _record.clear()
    _deferred.clear()
    _totals.clear()


@contextlib.contextmanager
def trace(log_dir):
    """Capture a ``torch.profiler`` trace around a block into
    ``log_dir/trace.json`` (view in Perfetto or chrome://tracing), and the
    block's spans and counters into ``log_dir/spans.json``. The record is
    cleared at the entry. Yields the profiler (``key_averages()`` for a
    table)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    clear()
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(str(log_dir), 'trace.json'))
    with open(os.path.join(str(log_dir), 'spans.json'), 'w') as f:
        json.dump({'spans': record(), 'counters': counters()}, f)
