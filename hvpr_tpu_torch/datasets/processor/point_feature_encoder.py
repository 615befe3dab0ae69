"""Point feature encoding (host-side channel selection).

The port's copy of ``hvpr_tpu/datasets/processor/point_feature_encoder.py``:
the config's ``encoding_type`` names the encoder method;
``absolute_coordinates_encoding`` keeps xyz plus every extra channel listed
in ``used_feature_list``, each located by its position in
``src_feature_list``. Calling an encoder with no points returns the channel
count, which sizes the model.
"""

import numpy as np


class PointFeatureEncoder:
    def __init__(self, config, point_cloud_range=None):
        self.point_encoding_config = config
        self.point_cloud_range = point_cloud_range
        src = list(config['src_feature_list'])
        used = list(config['used_feature_list'])
        if src[:3] != ['x', 'y', 'z']:
            raise ValueError(f'src_feature_list must lead with x,y,z; got {src}')
        self.src_feature_list = src
        self.used_feature_list = used
        # source column of every requested non-coordinate channel, in order
        self._extra_cols = [src.index(name) for name in used
                            if name not in ('x', 'y', 'z')]

    @property
    def num_point_features(self):
        encode = getattr(self, self.point_encoding_config['encoding_type'])
        return encode(points=None)

    def forward(self, data_dict):
        encode = getattr(self, self.point_encoding_config['encoding_type'])
        data_dict['points'], data_dict['use_lead_xyz'] = encode(data_dict['points'])
        return data_dict

    def absolute_coordinates_encoding(self, points=None):
        if points is None:                     # channel-count query
            return 3 + len(self._extra_cols)
        cols = [points[:, :3]] + [points[:, i:i + 1] for i in self._extra_cols]
        return np.concatenate(cols, axis=1), True
