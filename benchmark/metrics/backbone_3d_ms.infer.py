"""Device ms a request of the 3D backbone stage (SECOND's sparse
VoxelBackBone8x): CUDA events at the stage boundaries, mean over the
window's requests."""

from harness.stats import mean


def read(rec):
    return mean(rec.spans.get('backbone_3d', []))
