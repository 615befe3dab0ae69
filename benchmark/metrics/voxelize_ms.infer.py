"""Device ms a request of the voxelizer (the call to the first stage): CUDA events at the
stage boundaries, mean over the window's requests."""

from harness.stats import mean


def read(rec):
    return mean(rec.spans.get('voxelize', []))
