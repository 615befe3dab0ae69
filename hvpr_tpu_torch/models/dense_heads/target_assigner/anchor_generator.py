"""Dense anchor-grid generation (numpy, computed once at build time).

The port's copy of
``hvpr_tpu/models/dense_heads/target_assigner/anchor_generator.py``:
meshgrid x/y/z x sizes x rotations -> (z, y, x, Nsz, Nrot, 7) float32 with
the bottom-to-center z shift.
"""

import numpy as np


class AnchorGenerator:
    def __init__(self, anchor_range, anchor_generator_config):
        self.anchor_generator_cfg = anchor_generator_config
        self.anchor_range = anchor_range
        self.anchor_sizes = [c['anchor_sizes'] for c in anchor_generator_config]
        self.anchor_rotations = [c['anchor_rotations'] for c in anchor_generator_config]
        self.anchor_heights = [c['anchor_bottom_heights'] for c in anchor_generator_config]
        self.align_center = [c.get('align_center', False) for c in anchor_generator_config]

    def generate_anchors(self, grid_sizes):
        """grid_sizes: per-class [nx_feat, ny_feat].

        Returns a list of (1, ny, nx, num_sizes, num_rots, 7) float32 arrays
        and the list of anchors per location.
        """
        all_anchors = []
        num_anchors_per_location = []
        for grid_size, sizes, rotations, heights, align_center in zip(
                grid_sizes, self.anchor_sizes, self.anchor_rotations,
                self.anchor_heights, self.align_center):
            num_anchors_per_location.append(len(rotations) * len(sizes) * len(heights))
            if align_center:
                x_stride = (self.anchor_range[3] - self.anchor_range[0]) / grid_size[0]
                y_stride = (self.anchor_range[4] - self.anchor_range[1]) / grid_size[1]
                x_offset, y_offset = x_stride / 2, y_stride / 2
            else:
                x_stride = (self.anchor_range[3] - self.anchor_range[0]) / (grid_size[0] - 1)
                y_stride = (self.anchor_range[4] - self.anchor_range[1]) / (grid_size[1] - 1)
                x_offset, y_offset = 0, 0

            x_shifts = np.arange(self.anchor_range[0] + x_offset,
                                 self.anchor_range[3] + 1e-5, x_stride, dtype=np.float32)
            y_shifts = np.arange(self.anchor_range[1] + y_offset,
                                 self.anchor_range[4] + 1e-5, y_stride, dtype=np.float32)
            z_shifts = np.asarray(heights, dtype=np.float32)
            sizes_np = np.asarray(sizes, dtype=np.float32)
            rots_np = np.asarray(rotations, dtype=np.float32)

            nx, ny, nz = len(x_shifts), len(y_shifts), len(z_shifts)
            ns, nr = len(sizes_np), len(rots_np)
            anchors = np.zeros((nz, ny, nx, ns, nr, 7), dtype=np.float32)
            anchors[..., 0] = x_shifts[None, None, :, None, None]
            anchors[..., 1] = y_shifts[None, :, None, None, None]
            anchors[..., 2] = z_shifts[:, None, None, None, None]
            anchors[..., 3:6] = sizes_np[None, None, None, :, None, :]
            anchors[..., 6] = rots_np[None, None, None, None, :]
            anchors[..., 2] += anchors[..., 5] / 2
            all_anchors.append(anchors)
        return all_anchors, num_anchors_per_location
