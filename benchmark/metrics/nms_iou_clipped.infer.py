"""Share of the NMS's box pairs that the rotated IoU kernel clipped in full,
in %: 100 x the program's ``nms.iou_clipped`` counter over its
``nms.iou_pairs`` counter, each summed over the window's ``nms`` spans.
None where the program counts no pairs (no such counters, or no kernel)."""

from harness.spans import program_spans, subtree_counts


def read(rec):
    spans = program_spans()
    if not spans:
        return None
    pairs = sum(subtree_counts(spans, 'nms', 'nms.iou_pairs'))
    if pairs <= 0:
        return None
    return 100.0 * sum(subtree_counts(spans, 'nms', 'nms.iou_clipped')) / pairs
