from .detector3d_template import Detector3DTemplate
from .pointpillar import MixAnchorMemory, PointPillar, SECONDNet

__all__ = {
    'PointPillar': PointPillar,
    'MixAnchor_Memory': MixAnchorMemory,
    'SECONDNet': SECONDNet,
}


def build_detector(model_cfg, num_class, dataset, point_stream=True):
    """Instantiate a detector module from its config NAME; ``point_stream``
    builds a point-based ``backbone_3d`` (HVPR's training-only stream); a
    voxel backbone is built either way."""
    name = model_cfg['NAME']
    if name not in __all__:
        raise NotImplementedError(f'detector {name!r} is not ported yet')
    return __all__[name](
        model_cfg=model_cfg,
        num_class=num_class,
        class_names=dataset.class_names,
        grid_size=tuple(int(g) for g in dataset.grid_size),
        point_cloud_range=tuple(float(v) for v in dataset.point_cloud_range),
        voxel_size=tuple(float(v) for v in dataset.voxel_size),
        num_point_features=int(dataset.num_point_features),
        max_points_per_voxel=int(dataset.max_points_per_voxel),
        point_stream=point_stream,
    )
