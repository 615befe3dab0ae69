"""Device ms a request of post-processing (the last stage to the detections
on the host): CUDA events at the stage boundaries, mean over the window's
requests."""

from harness.stats import mean


def read(rec):
    return mean(rec.spans.get('post', []))
