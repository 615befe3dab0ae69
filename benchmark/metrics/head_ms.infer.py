"""Device ms a request of the dense head stage (with the decode): CUDA events at the
stage boundaries, mean over the window's requests."""

from harness.stats import mean


def read(rec):
    return mean(rec.spans.get('dense_head', []))
