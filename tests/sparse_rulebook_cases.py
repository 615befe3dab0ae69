"""Inputs of a sparse conv's rulebook (``ops/sparse_conv.tap_rulebook``):
the CPU test of its plain version and the card test of kernel K14 take the
same cases. No JAX here, so that the card's tests can import it.

A case is (in_lin, query_coords, query_ok, kernel, centered, grid): the
input sites' sorted linear ids (B, V) int64, the queries' zyx coordinates
(B, M, 3) and validity (B, M), as ``subm_conv3d`` (the input sites, int32)
and ``sparse_conv3d`` (its output sites' window origins, int64, M the
``max_out`` cap) hand them over.
"""

import numpy as np
import torch

from hvpr_tpu_torch.ops import sparse_conv as tsc

GRID = (6, 14, 11)      # nz, ny, nx
JUNK = (-3, 10 ** 6, 7)  # the coordinates of an invalid slot in the junk case

# name -> (active sites a sample, slots V, conv); conv: ('subm', kernel) or
# ('strided', kernel, stride, padding, max_out)
CASES = {
    'submanifold 3x3x3': ([80, 41], 96, ('subm', (3, 3, 3))),
    'submanifold (1, 3, 5)': ([70, 12], 80, ('subm', (1, 3, 5))),
    'stage conv 3/2/1': ([50, 33], 64, ('strided', (3, 3, 3), (2, 2, 2), (1, 1, 1), 128)),
    "conv4's padding (0, 1, 1)": ([50, 33], 64,
                                  ('strided', (3, 3, 3), (2, 2, 2), (0, 1, 1), 128)),
    'conv_out (3, 1, 1) / (2, 1, 1) / 0': ([60, 24], 64,
                                           ('strided', (3, 1, 1), (2, 1, 1), (0, 0, 0), 128)),
    'strided 2/2/0': ([60, 24], 64, ('strided', (2, 2, 2), (2, 2, 2), (0, 0, 0), 96)),
    'sites on every grid face': (['faces', 'faces'], 100, ('subm', (3, 3, 3))),
    'invalid slots with junk coordinates': ([30, 5], 64, ('subm', (3, 3, 3))),
    'an empty sample and a full one': ([0, 60], 60, ('subm', (3, 3, 3))),
    'an empty sample and a full one, strided': ([0, 60], 60,
                                                ('strided', (3, 3, 3), (2, 2, 2), (1, 1, 1),
                                                 120)),
}


def _face_cells(rng, grid, keep_all):
    """Linear ids of the cells on the grid's six faces (all, or a random
    half), sorted."""
    nz, ny, nx = grid
    z, y, x = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx), indexing='ij')
    face = ((z == 0) | (z == nz - 1) | (y == 0) | (y == ny - 1) | (x == 0)
            | (x == nx - 1)).ravel()
    cells = np.flatnonzero(face)
    return cells if keep_all else np.sort(rng.choice(cells, len(cells) // 2, replace=False))


def sites(name):
    """(coords (B, V, 3) int32, valid (B, V) bool, grid) of case ``name``:
    each sample's active cells sorted by linear id, the invalid slots after
    them."""
    counts, v, conv = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    grid = (4, 6, 5) if counts[0] == 'faces' else GRID   # 96 face cells
    nz, ny, nx = grid
    coords = np.zeros((len(counts), v, 3), np.int32)
    valid = np.zeros((len(counts), v), bool)
    for b, n in enumerate(counts):
        cells = (_face_cells(rng, grid, b == 0) if n == 'faces'
                 else np.sort(rng.choice(nz * ny * nx, n, replace=False)))
        coords[b, :len(cells)] = np.stack([cells // (ny * nx), (cells // nx) % ny, cells % nx],
                                          -1)
        valid[b, :len(cells)] = True
    if name == 'invalid slots with junk coordinates':
        coords[~valid] = JUNK
    return torch.from_numpy(coords), torch.from_numpy(valid), grid


def rulebook_case(name, device='cpu'):
    """(in_lin, query_coords, query_ok, kernel, centered, grid) of case
    ``name`` on ``device``, built as the convs build them."""
    coords, valid, grid = sites(name)
    conv = CASES[name][2]
    in_lin = tsc._linear_ids(coords, grid, valid)
    if conv[0] == 'subm':
        query, ok, kernel, centered = coords, valid, conv[1], True
    else:
        _, kernel, stride, padding, max_out = conv
        og = tsc.sparse_conv3d_out_grid(grid, kernel, stride, padding)
        out_lin, _ = tsc._output_sites(coords, valid, kernel, stride, padding, og, max_out)
        onz, ony, onx = og
        ok = out_lin < onz * ony * onx
        oyx = out_lin % (ony * onx)
        out_coords = torch.stack([out_lin // (ony * onx), oyx // onx, oyx % onx], dim=-1)
        query = out_coords * out_coords.new_tensor(stride) - out_coords.new_tensor(padding)
        centered = False
    return (in_lin.to(device), query.to(device), ok.to(device), kernel, centered, grid)
