"""Batched point-cloud voxelization (pillarization) on the device.

Port of ``hvpr_tpu/ops/voxelizer.py`` ``voxelize_batch_flat`` (with its
``_voxelize_batch_core``): one stable sort over (batch, pillar id), then a
segment compaction into flat sorted rows plus per-row pillar slots. Points
keep input order inside a pillar (stable sort), the first
``max_points_per_voxel`` of them are kept, and pillars take slots in
pillar-linear-index order per sample; integer outputs equal the JAX
package's exactly.

The JAX version sorts on two int32 keys to stay clear of int32 overflow; an
int64 key ``batch * (num_cells + 1) + pid`` has no such limit, so one sort
suffices. ``index_add_``/``index_copy_`` into an extra dump row stand in for
``.at[...]`` with ``mode='drop'``.

:class:`VoxelGeneratorNumpy` is the host voxelizer of the data layer
(``tools/test.py``'s padded batches), the port of the JAX package's.
"""

import numpy as np
import torch


def voxelize_batch_flat(points, point_mask, point_cloud_range, voxel_size,
                        max_voxels, max_points_per_voxel, grid_size_static):
    """Voxelize a (B, N, C) batch without materializing (B, V, P, C).

    Args:
        points: (B, N, C) float, xyz in the first three channels.
        point_mask: (B, N) bool validity of each point row.
        point_cloud_range: 6 floats [x0, y0, z0, x1, y1, z1].
        voxel_size: 3 floats.
        max_voxels: V, pillar slots per sample.
        max_points_per_voxel: P, points kept per pillar.
        grid_size_static: (nx, ny, nz).
    Returns dict:
        flat_points (C, B*N) sorted rows, channel-major;
        flat_slot (B*N,) int32 b*V + v (meaningless where not flat_write);
        flat_write (B*N,) bool; voxel_coords (B, V, 3) int32 (z, y, x);
        voxel_num_points (B, V) int32; voxel_mask (B, V) bool.
    """
    b, n, c = points.shape
    dev = points.device
    nx, ny, nz = (int(g) for g in grid_size_static)
    pcr = torch.tensor(point_cloud_range[0:3], dtype=points.dtype, device=dev)
    vsz = torch.tensor(voxel_size, dtype=points.dtype, device=dev)

    gi = torch.floor((points[..., 0:3] - pcr) / vsz).to(torch.int32)   # (B, N, 3)
    in_range = ((gi[..., 0] >= 0) & (gi[..., 0] < nx)
                & (gi[..., 1] >= 0) & (gi[..., 1] < ny)
                & (gi[..., 2] >= 0) & (gi[..., 2] < nz))
    valid = in_range & point_mask

    num_cells = nx * ny * nz
    pid = (gi[..., 2].long() * (ny * nx) + gi[..., 1].long() * nx
           + gi[..., 0].long())
    pid = torch.where(valid, pid, num_cells)                      # invalid last
    batch_ids = torch.arange(b, device=dev, dtype=torch.int64)[:, None]
    key = (batch_ids * (num_cells + 1) + pid).reshape(-1)
    _, order = torch.sort(key, stable=True)

    total = b * n
    sbatch = batch_ids.expand(b, n).reshape(-1)[order]
    spid = pid.reshape(-1)[order]
    svalid = valid.reshape(-1)[order]
    spoints_t = points.reshape(-1, c)[order].t().contiguous()     # (C, B*N)

    first = torch.ones(1, dtype=torch.bool, device=dev)
    new_batch = torch.cat([first, sbatch[1:] != sbatch[:-1]])
    head = svalid & (new_batch | torch.cat([first, spid[1:] != spid[:-1]]))
    head_cum = torch.cumsum(head.long(), 0)                        # global rank + 1
    batch_head_base = torch.where(new_batch, head_cum - head.long(), 0)
    batch_base = torch.cummax(batch_head_base, 0).values
    voxel_idx = head_cum - 1 - batch_base                          # per-sample slot

    iota = torch.arange(total, device=dev)
    seg_start = torch.cummax(torch.where(head, iota, -1), 0).values
    pos_in_voxel = iota - seg_start

    write = svalid & (pos_in_voxel < max_points_per_voxel) & (voxel_idx < max_voxels)
    slot = sbatch * max_voxels + voxel_idx
    dump = b * max_voxels
    vslot = torch.where(write, slot, dump)
    counts = torch.zeros(dump + 1, dtype=torch.int32, device=dev)
    counts.index_add_(0, vslot, write.to(torch.int32))
    counts = counts[:-1].reshape(b, max_voxels)

    head_write = head & (voxel_idx < max_voxels)
    hslot = torch.where(head_write, slot, dump)
    szyx = torch.stack([spid // (ny * nx), (spid // nx) % ny, spid % nx],
                       dim=-1).to(torch.int32)
    # the dump row collects every non-head row; only head rows carry a
    # unique slot, so the kept rows are deterministic
    coords = torch.zeros(dump + 1, 3, dtype=torch.int32, device=dev)
    coords.index_copy_(0, hslot, szyx)
    coords = coords[:-1].reshape(b, max_voxels, 3)

    return {
        'flat_points': spoints_t,
        'flat_slot': slot.to(torch.int32),
        'flat_write': write,
        'voxel_coords': coords,
        'voxel_num_points': counts,
        'voxel_mask': counts > 0,
    }


class VoxelGeneratorNumpy:
    """Host voxelizer with spconv ``VoxelGenerator`` semantics (numpy).

    Voxels in first-seen order, the first ``max_num_points`` points of each
    voxel in point order, and a voxel cap that keeps the earliest voxels.
    The data layer's ``transform_points_to_voxels`` runs it per scan.
    """

    def __init__(self, voxel_size, point_cloud_range, max_num_points, max_voxels):
        self.voxel_size = np.asarray(voxel_size, dtype=np.float32)
        self.point_cloud_range = np.asarray(point_cloud_range, dtype=np.float32)
        self.max_num_points = max_num_points
        self.max_voxels = max_voxels
        grid_size = (self.point_cloud_range[3:6] - self.point_cloud_range[0:3]) / self.voxel_size
        self.grid_size = np.round(grid_size).astype(np.int64)  # (nx, ny, nz)

    def generate(self, points):
        """points (N, C) -> (voxels (V', P, C), coords (V', 3) zyx, num_points (V',))."""
        nx, ny, nz = self.grid_size
        gi = np.floor((points[:, 0:3] - self.point_cloud_range[0:3]) / self.voxel_size).astype(np.int64)
        valid = ((gi[:, 0] >= 0) & (gi[:, 0] < nx)
                 & (gi[:, 1] >= 0) & (gi[:, 1] < ny)
                 & (gi[:, 2] >= 0) & (gi[:, 2] < nz))
        points = points[valid]
        gi = gi[valid]
        pid = gi[:, 2] * (ny * nx) + gi[:, 1] * nx + gi[:, 0]

        uniq, first_index, inverse = np.unique(pid, return_index=True, return_inverse=True)
        # first-occurrence ordering of voxels
        occ_order = np.argsort(first_index, kind='stable')
        rank_of_uniq = np.empty_like(occ_order)
        rank_of_uniq[occ_order] = np.arange(len(uniq))
        voxel_rank = rank_of_uniq[inverse]  # (N,) voxel slot per point

        num_voxels = min(len(uniq), self.max_voxels)
        voxels = np.zeros((num_voxels, self.max_num_points, points.shape[1]), dtype=points.dtype)
        coords = np.zeros((num_voxels, 3), dtype=np.int32)
        num_points = np.zeros((num_voxels,), dtype=np.int32)

        kept_uniq = uniq[occ_order[:num_voxels]]
        coords[:, 0] = kept_uniq // (ny * nx)
        coords[:, 1] = (kept_uniq // nx) % ny
        coords[:, 2] = kept_uniq % nx

        # vectorized segment compaction (as in voxelize_batch_flat)
        order = np.argsort(voxel_rank, kind='stable')
        sr = voxel_rank[order]
        head = np.concatenate([[True], sr[1:] != sr[:-1]]) if len(sr) else np.zeros(0, bool)
        seg_start = np.maximum.accumulate(np.where(head, np.arange(len(sr)), -1)) if len(sr) else sr
        pos = np.arange(len(sr)) - seg_start
        write = (pos < self.max_num_points) & (sr < num_voxels)
        voxels[sr[write], pos[write]] = points[order][write]
        if write.any():
            num_points = np.bincount(sr[write], minlength=num_voxels).astype(np.int32)
        return voxels, coords, num_points
