"""KITTI label txt <-> annotation dict IO (the port's copy of
``hvpr_tpu/datasets/kitti/kitti_object_eval_python/kitti_common.py``).
"""

import pathlib

import numpy as np


def get_image_index_str(img_idx):
    return f'{img_idx:06d}'


def get_label_anno(label_path):
    annotations = {k: [] for k in
                   ['name', 'truncated', 'occluded', 'alpha', 'bbox',
                    'dimensions', 'location', 'rotation_y']}
    with open(label_path, 'r') as f:
        lines = f.readlines()
    content = [line.strip().split(' ') for line in lines if line.strip()]
    num_objects = len([x[0] for x in content if x[0] != 'DontCare'])
    annotations['name'] = np.array([x[0] for x in content])
    num_gt = len(annotations['name'])
    annotations['truncated'] = np.array([float(x[1]) for x in content])
    annotations['occluded'] = np.array([int(float(x[2])) for x in content])
    annotations['alpha'] = np.array([float(x[3]) for x in content])
    annotations['bbox'] = np.array([[float(v) for v in x[4:8]]
                                    for x in content]).reshape(-1, 4)
    # dimensions: stored h, w, l -> standard l, h, w
    annotations['dimensions'] = np.array(
        [[float(v) for v in x[8:11]] for x in content]).reshape(-1, 3)[:, [2, 0, 1]]
    annotations['location'] = np.array(
        [[float(v) for v in x[11:14]] for x in content]).reshape(-1, 3)
    annotations['rotation_y'] = np.array([float(x[14]) for x in content]).reshape(-1)
    if len(content) != 0 and len(content[0]) == 16:
        annotations['score'] = np.array([float(x[15]) for x in content])
    else:
        annotations['score'] = np.zeros((num_gt,))
    index = list(range(num_objects)) + [-1] * (num_gt - num_objects)
    annotations['index'] = np.array(index, dtype=np.int32)
    annotations['group_ids'] = np.arange(num_gt, dtype=np.int32)
    return annotations


def get_label_annos(label_folder, image_ids=None):
    if image_ids is None:
        filepaths = sorted(pathlib.Path(label_folder).glob('*.txt'))
        image_ids = [int(p.stem) for p in filepaths]
    annos = []
    label_folder = pathlib.Path(label_folder)
    for idx in image_ids:
        image_idx = get_image_index_str(idx) if isinstance(idx, int) else idx
        annos.append(get_label_anno(label_folder / (image_idx + '.txt')))
    return annos


def kitti_result_line(result_dict, precision=4):
    prec_float = '{' + ':.{}f'.format(precision) + '}'
    res_line = []
    all_field_default = {
        'name': None, 'truncated': -1, 'occluded': -1, 'alpha': -10,
        'bbox': None, 'dimensions': [-1, -1, -1], 'location': [-1000, -1000, -1000],
        'rotation_y': -10, 'score': 0.0,
    }
    res_dict = dict(all_field_default)
    res_dict.update(result_dict)
    for key, val in res_dict.items():
        if key == 'name':
            res_line.append(val)
        elif key in ['truncated', 'alpha', 'rotation_y', 'score']:
            res_line.append(prec_float.format(val))
        elif key == 'occluded':
            res_line.append(f'{val}')
        elif key == 'bbox':
            res_line += [prec_float.format(v) for v in val]
        elif key == 'dimensions':
            # standard l, h, w -> stored h, w, l
            res_line += [prec_float.format(v) for v in [val[1], val[2], val[0]]]
        elif key == 'location':
            res_line += [prec_float.format(v) for v in val]
    return ' '.join(res_line)
