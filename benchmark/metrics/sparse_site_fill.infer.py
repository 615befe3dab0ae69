"""The share of the sparse convs' fixed-shape work that is real: valid
output sites over output site slots, the program's ``sparse.sites`` and
``sparse.slots`` counters summed over every ``sparse.conv`` span of the
window, in percent."""

from harness.spans import program_spans


def read(rec):
    spans = program_spans()
    convs = [s['counters'] for s in spans or () if s['name'] == 'sparse.conv']
    slots = sum(c.get('sparse.slots', 0) for c in convs)
    if not slots:
        return None
    return 100.0 * sum(c.get('sparse.sites', 0) for c in convs) / slots
