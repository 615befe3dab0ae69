"""Device ms a request of the scatter and memory stage: CUDA events at the
stage boundaries, mean over the window's requests."""

from harness.stats import mean


def read(rec):
    return mean(rec.spans.get('map_to_bev_module', []))
