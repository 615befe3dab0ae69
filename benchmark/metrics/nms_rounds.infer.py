"""Rounds of the NMS's fixed-point suppression loop a scan: the program's
``nms.rounds`` counter, mean over the window's ``nms`` spans."""

from harness.spans import program_spans, subtree_counts
from harness.stats import mean


def read(rec):
    spans = program_spans()
    return mean(subtree_counts(spans, 'nms', 'nms.rounds')) if spans else None
