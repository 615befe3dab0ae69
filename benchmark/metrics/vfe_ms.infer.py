"""Device ms a request of the VFE stage: CUDA events at the
stage boundaries, mean over the window's requests."""

from harness.stats import mean


def read(rec):
    return mean(rec.spans.get('vfe', []))
