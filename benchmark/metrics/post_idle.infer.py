"""Share of post-processing in which no kernel, copy or memset ran on the
device: 1 - (union of the device intervals inside the program's ``post``
spans) / (their host time), on the trace's clock, in percent. Left out
where the trace's launches of a hand-written kernel disagree with the
program's count (dropped records)."""

from harness.spans import idle_share, program_spans, ranges_of


def read(rec):
    spans = program_spans()
    if not spans:
        return None
    return idle_share(rec, ranges_of(spans, lambda s, parent: s['name'] == 'post'))
