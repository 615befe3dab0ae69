"""The program's own spans and counters of a traced run, reduced to what the
metrics read.

The program records them while a ``torch.profiler`` session is active
(``hvpr_tpu_torch/utils/profiler.py`` ``record``): the set-up runs outside
the profiler, so the record holds the window's requests alone. A span is a
dict (``name``, ``id``, ``parent``, ``request``, ``start_ns`` and ``end_ns``
on the trace's clock, ``device_ms``, ``attrs``, ``counters``); a request is
the tree under a root ``pipeline`` span. Where the program has no recorder
(an older commit) or recorded nothing, :func:`program_spans` gives None and
so does every metric that reads it.
"""


def program_spans():
    """The program's drained record, or None."""
    try:
        from hvpr_tpu_torch.utils import profiler
    except ImportError:
        return None
    record = getattr(profiler, 'record', None)
    return (record() or None) if record is not None else None


def subtree_counts(spans, name, counter):
    """[``counter`` summed over each span named ``name`` and its descendants]."""
    total = {s['id']: s['counters'].get(counter, 0) for s in spans if s['name'] == name}
    owner = {i: i for i in total}
    for s in spans:                  # in the order they opened: a parent first
        if s['id'] not in owner and s['parent'] in owner:
            owner[s['id']] = owner[s['parent']]
            total[owner[s['id']]] += s['counters'].get(counter, 0)
    return list(total.values())


def request_device_ms(spans, name):
    """[device ms of each request's spans named ``name``, summed], one a
    ``pipeline`` request; None where a span has no device time."""
    by = {s['request']: 0.0 for s in spans if s['name'] == 'pipeline' and s['parent'] is None}
    for s in spans:
        if s['name'] == name and s['request'] in by:
            if s['device_ms'] is None:
                return None
            by[s['request']] += s['device_ms']
    return list(by.values()) if by else None


def idle_share(rec, ranges):
    """Percent of the host ranges ``ranges`` in which the device ran nothing;
    None without a trace, or where its launches disagree with the program's
    count (dropped records)."""
    if rec.trace is None or not rec.launches_match or not ranges:
        return None
    window = rec.trace.span_s(ranges)
    return 100.0 * (1.0 - rec.trace.busy_s(ranges) / window) if window > 0 else None


def ranges_of(spans, keep):
    """[(start_ns, end_ns)] of the spans for which ``keep(span, parent)``."""
    by_id = {s['id']: s for s in spans}
    return [(s['start_ns'], s['end_ns']) for s in spans if keep(s, by_id.get(s['parent']))]
