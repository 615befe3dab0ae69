"""Device ms a request of the BEV backbone stage: CUDA events at the
stage boundaries, mean over the window's requests."""

from harness.stats import mean


def read(rec):
    return mean(rec.spans.get('backbone_2d', []))
