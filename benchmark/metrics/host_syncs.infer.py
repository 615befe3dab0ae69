"""Reads of device values on the host a request: the program's
``host_syncs`` counter over a ``pipeline`` span and its descendants, mean
over the window's requests."""

from harness.spans import program_spans, subtree_counts
from harness.stats import mean


def read(rec):
    spans = program_spans()
    return mean(subtree_counts(spans, 'pipeline', 'host_syncs')) if spans else None
