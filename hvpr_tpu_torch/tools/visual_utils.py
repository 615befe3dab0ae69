"""Visualization helpers of the demo and vis entry points.

The port's copy of ``tools/visual_utils/visual_utils.py``: numpy only at
import. ``points_to_bev_image`` rasterizes points into a BEV height image;
``draw_bev_scene`` (a BEV PNG with predicted boxes in green and gt boxes in
red) and ``draw_scenes`` (a matplotlib-3D render) import matplotlib when
called, and :func:`matplotlib_available` tells a caller whether they can
run; ``export_scene_ply`` writes an ASCII ``.ply`` (the points and the
boxes' wireframe edges) with numpy alone, so it always works.
"""

import importlib.util

import numpy as np

from ..utils import box_utils

# the 12 wireframe edges of a box, as corner-index pairs (corners ordered
# as box_utils.boxes_to_corners_3d gives them: bottom 0-3, top 4-7)
_BOX_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0),
              (4, 5), (5, 6), (6, 7), (7, 4),
              (0, 4), (1, 5), (2, 6), (3, 7)]


def matplotlib_available():
    return importlib.util.find_spec('matplotlib') is not None


def _pyplot():
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    return plt


def points_to_bev_image(points, point_cloud_range, resolution=0.1):
    """Rasterize points into a BEV image of the highest point a cell (height
    above the range's floor)."""
    pcr = np.asarray(point_cloud_range, dtype=np.float32)
    nx = int(round((pcr[3] - pcr[0]) / resolution))
    ny = int(round((pcr[4] - pcr[1]) / resolution))
    xi = ((points[:, 0] - pcr[0]) / resolution).astype(np.int64)
    yi = ((points[:, 1] - pcr[1]) / resolution).astype(np.int64)
    valid = (xi >= 0) & (xi < nx) & (yi >= 0) & (yi < ny)
    img = np.zeros((ny, nx), dtype=np.float32)
    np.maximum.at(img, (yi[valid], xi[valid]), points[valid, 2] - pcr[2])
    return img


def draw_bev_scene(points, pred_boxes=None, gt_boxes=None, save_path=None,
                   point_cloud_range=(0, -40, -3, 70.4, 40, 1), resolution=0.1):
    """A BEV PNG with predicted (green) and gt (red) boxes; returns the path
    (or the figure without ``save_path``)."""
    plt = _pyplot()
    pcr = np.asarray(point_cloud_range, dtype=np.float32)
    img = points_to_bev_image(points, pcr, resolution)
    fig, ax = plt.subplots(figsize=(12, 12 * img.shape[0] / img.shape[1]))
    ax.imshow(img, origin='lower', cmap='gray', extent=[pcr[0], pcr[3], pcr[1], pcr[4]])

    def draw_boxes(boxes, color):
        if boxes is None or len(boxes) == 0:
            return
        corners = box_utils.boxes_to_corners_3d(np.asarray(boxes[:, :7]))[:, :4, :2]
        for c in corners:
            poly = np.concatenate([c, c[:1]], axis=0)
            ax.plot(poly[:, 0], poly[:, 1], color=color, linewidth=1.2)

    draw_boxes(pred_boxes, 'lime')
    draw_boxes(gt_boxes, 'red')
    ax.set_xlabel('x (m)')
    ax.set_ylabel('y (m)')
    if save_path is not None:
        fig.savefig(save_path, bbox_inches='tight', dpi=120)
        plt.close(fig)
        return save_path
    return fig


def draw_scenes(points, gt_boxes=None, ref_boxes=None, save_path=None,
                max_points=20000, elev=25, azim=-60):
    """A 3D render of the points (coloured by height), gt boxes in red and
    predicted boxes in green wireframes."""
    plt = _pyplot()
    points = np.asarray(points)
    if points.shape[0] > max_points:
        sel = np.random.default_rng(0).choice(points.shape[0], max_points, replace=False)
        points = points[sel]
    fig = plt.figure(figsize=(14, 10))
    ax = fig.add_subplot(projection='3d')
    ax.scatter(points[:, 0], points[:, 1], points[:, 2], c=points[:, 2], cmap='viridis',
               s=0.4, linewidths=0)

    def draw_wireframes(boxes, color):
        if boxes is None or len(boxes) == 0:
            return
        for c in box_utils.boxes_to_corners_3d(np.asarray(boxes)[:, :7]):
            for i, j in _BOX_EDGES:
                ax.plot([c[i, 0], c[j, 0]], [c[i, 1], c[j, 1]], [c[i, 2], c[j, 2]],
                        color=color, linewidth=1.0)

    draw_wireframes(ref_boxes, 'lime')
    draw_wireframes(gt_boxes, 'red')
    ax.set_xlabel('x (m)')
    ax.set_ylabel('y (m)')
    ax.set_zlabel('z (m)')
    # equal aspect, so that boxes are not sheared
    spans = points[:, :3].max(axis=0) - points[:, :3].min(axis=0)
    ax.set_box_aspect(tuple(np.maximum(spans, 1e-3)))
    ax.view_init(elev=elev, azim=azim)
    if save_path is not None:
        fig.savefig(save_path, bbox_inches='tight', dpi=110)
        plt.close(fig)
        return save_path
    return fig


def export_scene_ply(points, boxes=None, save_path='scene.ply'):
    """Write the scene as an ASCII ``.ply``: the points and, for each box,
    its 8 corners and 12 wireframe edges."""
    points = np.asarray(points, dtype=np.float32)
    verts = [points[:, :3]]
    edges = []
    if boxes is not None and len(boxes):
        corners = box_utils.boxes_to_corners_3d(np.asarray(boxes, dtype=np.float32)[:, :7])
        base = points.shape[0]
        for k, c in enumerate(corners):
            verts.append(c)
            edges.extend((base + 8 * k + i, base + 8 * k + j) for i, j in _BOX_EDGES)
    verts = np.concatenate(verts, axis=0)
    with open(save_path, 'w') as f:
        f.write('ply\nformat ascii 1.0\n'
                f'element vertex {verts.shape[0]}\n'
                'property float x\nproperty float y\nproperty float z\n'
                f'element edge {len(edges)}\n'
                'property int vertex1\nproperty int vertex2\n'
                'end_header\n')
        np.savetxt(f, verts, fmt='%.4f')
        if edges:
            np.savetxt(f, np.asarray(edges, dtype=np.int64), fmt='%d')
    return save_path
