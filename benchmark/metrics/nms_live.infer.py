"""Live candidates entering the NMS's rotated IoU a scan: the program's
``nms.live`` counter, mean over the window's ``nms`` spans."""

from harness.spans import program_spans, subtree_counts
from harness.stats import mean


def read(rec):
    spans = program_spans()
    return mean(subtree_counts(spans, 'nms', 'nms.live')) if spans else None
