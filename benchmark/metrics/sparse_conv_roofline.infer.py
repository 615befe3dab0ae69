"""The sparse backbone's share of its roofline, in percent: for each
``sparse.conv`` span of the window, the least time the card could take
for it (``work/second.py`` ``conv_work`` and ``bound_s``: operations from
its ``sparse.pairs`` counter and its widths at the f32 peak, the
products being float32 with TF32 off, or its bytes from its sites at the
memory rate), summed, over the summed ``backbone_3d`` hook spans. A conv's
input sites are the sites of the conv before it in its request (the
first conv is submanifold: its own)."""

from harness.spans import program_spans
from work.second import bound_s, conv_work


def read(rec):
    spans = program_spans()
    backbone_ms = sum(rec.spans.get('backbone_3d', []))
    if not spans or rec.rates is None or not backbone_ms:
        return None
    total_s, last_sites = 0.0, {}
    for s in spans:                     # in the order they opened
        if s['name'] != 'sparse.conv':
            continue
        a, c = s['attrs'], s['counters']
        sites = c.get('sparse.sites', 0)
        in_sites = last_sites.get(s['request'], sites)
        last_sites[s['request']] = sites
        total_s += bound_s(*conv_work(c.get('sparse.pairs', 0), in_sites, sites, a['taps'],
                                      a['c_in'], a['c_out']), rec.rates)
    if not last_sites:
        return None
    return 100.0 * total_s * 1e3 / backbone_ms
