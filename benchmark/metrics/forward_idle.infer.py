"""Share of the voxelizer and the forward's stages in which no kernel, copy
or memset ran on the device: 1 - (union of the device intervals inside the
program's spans under ``pipeline`` other than ``post``) / (their host time),
on the trace's clock, in percent. Left out where the trace's launches of a
hand-written kernel disagree with the program's count (dropped records)."""

from harness.spans import idle_share, program_spans, ranges_of


def forward(span, parent):
    return parent is not None and parent['name'] == 'pipeline' and span['name'] != 'post'


def read(rec):
    spans = program_spans()
    return idle_share(rec, ranges_of(spans, forward)) if spans else None
