"""nuScenes geometry: quaternions, poses and frame changes (numpy only).

The port's copy of ``hvpr_tpu/datasets/nuscenes/nuscenes_utils.py``:
quaternion poses, frame composition (lidar -> ego -> global and back),
sweep-to-reference transforms, global-frame boxes in the reference lidar
frame, and :func:`fill_infos`, the walk over a devkit ``NuScenes`` database
(any object with its ``get(table, token)``) that builds the info dicts
from this geometry. :func:`hvpr_tpu_torch.utils.scans.build_nuscenes_root`
writes info pickles of the same schema for a synthetic tree.

Frames, following the nuScenes convention:
  global   world frame of the map
  car      ego vehicle frame at some timestamp (ego_pose record)
  lidar    sensor frame (calibrated_sensor record, mounted on car)

A pose record {'translation': t, 'rotation': q (w,x,y,z)} means
``x_parent = R(q) @ x_child + t`` — i.e. it is the child->parent transform.
"""

import numpy as np

# Official nuScenes detection-task mapping from the raw database taxonomy
# (category_name, e.g. 'vehicle.car') to the 10 detection classes the
# benchmark scores; non-benchmark categories map to 'ignore'. Configs name
# the detection classes, so infos must store detection names or no gt ever
# matches CLASS_NAMES.
MAP_NAME_FROM_GENERAL_TO_DETECTION = {
    'human.pedestrian.adult': 'pedestrian',
    'human.pedestrian.child': 'pedestrian',
    'human.pedestrian.wheelchair': 'ignore',
    'human.pedestrian.stroller': 'ignore',
    'human.pedestrian.personal_mobility': 'ignore',
    'human.pedestrian.police_officer': 'pedestrian',
    'human.pedestrian.construction_worker': 'pedestrian',
    'animal': 'ignore',
    'vehicle.car': 'car',
    'vehicle.motorcycle': 'motorcycle',
    'vehicle.bicycle': 'bicycle',
    'vehicle.bus.bendy': 'bus',
    'vehicle.bus.rigid': 'bus',
    'vehicle.truck': 'truck',
    'vehicle.construction': 'construction_vehicle',
    'vehicle.emergency.ambulance': 'ignore',
    'vehicle.emergency.police': 'ignore',
    'vehicle.trailer': 'trailer',
    'movable_object.barrier': 'barrier',
    'movable_object.trafficcone': 'traffic_cone',
    'movable_object.pushable_pullable': 'ignore',
    'movable_object.debris': 'ignore',
    'static_object.bicycle_rack': 'ignore',
}


def quaternion_to_rotation(q):
    """(w, x, y, z) unit quaternion -> 3x3 rotation matrix."""
    w, x, y, z = [float(v) for v in q]
    n = w * w + x * x + y * y + z * z
    if n < 1e-12:
        return np.eye(3, dtype=np.float64)
    s = 2.0 / n
    return np.array([
        [1 - s * (y * y + z * z), s * (x * y - w * z), s * (x * z + w * y)],
        [s * (x * y + w * z), 1 - s * (x * x + z * z), s * (y * z - w * x)],
        [s * (x * z - w * y), s * (y * z + w * x), 1 - s * (x * x + y * y)],
    ], dtype=np.float64)


def quaternion_yaw(q):
    """Yaw (rotation around +z) of a quaternion, nuScenes convention:
    the angle of the rotated +x axis projected to the ground plane."""
    rot = quaternion_to_rotation(q)
    fwd = rot @ np.array([1.0, 0.0, 0.0])
    return float(np.arctan2(fwd[1], fwd[0]))


def pose_to_matrix(pose, inverse=False):
    """{'translation', 'rotation'} record -> 4x4 child->parent transform
    (or parent->child when ``inverse``)."""
    rot = quaternion_to_rotation(pose['rotation'])
    t = np.asarray(pose['translation'], np.float64)
    tm = np.eye(4, dtype=np.float64)
    if inverse:
        tm[:3, :3] = rot.T
        tm[:3, 3] = -rot.T @ t
    else:
        tm[:3, :3] = rot
        tm[:3, 3] = t
    return tm


def sweep_to_ref_transform(ref_cs, ref_pose, sweep_cs, sweep_pose):
    """4x4 mapping sweep-lidar-frame points into the reference lidar frame.

    Chain: sweep lidar -> sweep car (sweep_cs) -> global (sweep_pose)
           -> ref car (ref_pose^-1) -> ref lidar (ref_cs^-1).
    """
    return (pose_to_matrix(ref_cs, inverse=True)
            @ pose_to_matrix(ref_pose, inverse=True)
            @ pose_to_matrix(sweep_pose)
            @ pose_to_matrix(sweep_cs))


def ref_to_global_transform(ref_cs, ref_pose):
    """4x4 mapping reference lidar-frame points into the global frame."""
    return pose_to_matrix(ref_pose) @ pose_to_matrix(ref_cs)


def global_boxes_to_lidar(centers, sizes_wlh, yaw_global, ref_cs, ref_pose):
    """Global-frame box annotations -> (N, 7) lidar-frame [x y z l w h yaw].

    nuScenes annotations store size as (w, l, h) and orientation as a global
    yaw; the detection box parametrization is (l, w, h) with heading in the
    lidar frame.
    """
    centers = np.asarray(centers, np.float64).reshape(-1, 3)
    sizes_wlh = np.asarray(sizes_wlh, np.float64).reshape(-1, 3)
    yaw_global = np.asarray(yaw_global, np.float64).reshape(-1)
    global_from_ref = ref_to_global_transform(ref_cs, ref_pose)
    ref_from_global = np.linalg.inv(global_from_ref)
    centers_l = centers @ ref_from_global[:3, :3].T + ref_from_global[:3, 3]
    yaw_tm = np.arctan2(ref_from_global[1, 0], ref_from_global[0, 0])
    boxes = np.zeros((len(centers), 7), np.float32)
    boxes[:, :3] = centers_l
    boxes[:, 3] = sizes_wlh[:, 1]   # l
    boxes[:, 4] = sizes_wlh[:, 0]   # w
    boxes[:, 5] = sizes_wlh[:, 2]   # h
    boxes[:, 6] = yaw_global + yaw_tm
    return boxes


def fill_infos(nusc, sample_tokens, max_sweeps=10):
    """The info dicts of ``sample_tokens`` (the schema of
    ``NuScenesDataset.include_nuscenes_data``) from a devkit ``NuScenes``
    database: the LIDAR_TOP sample data, up to ``max_sweeps - 1`` previous
    sweeps with their transforms into the reference lidar frame and time
    lags, and the annotations as lidar-frame boxes with detection class
    names and lidar point counts."""
    infos = []
    for token in sample_tokens:
        sample = nusc.get('sample', token)
        sd = nusc.get('sample_data', sample['data']['LIDAR_TOP'])
        ref_cs = nusc.get('calibrated_sensor', sd['calibrated_sensor_token'])
        ref_pose = nusc.get('ego_pose', sd['ego_pose_token'])
        ref_time = sd['timestamp'] * 1e-6

        sweeps = []
        cur = sd
        while len(sweeps) < max_sweeps - 1 and cur['prev']:
            cur = nusc.get('sample_data', cur['prev'])
            cs = nusc.get('calibrated_sensor', cur['calibrated_sensor_token'])
            pose = nusc.get('ego_pose', cur['ego_pose_token'])
            sweeps.append({
                'lidar_path': cur['filename'],
                'transform_matrix': sweep_to_ref_transform(
                    ref_cs, ref_pose, cs, pose).astype(np.float32),
                'time_lag': ref_time - cur['timestamp'] * 1e-6,
            })

        anns = [nusc.get('sample_annotation', t) for t in sample['anns']]
        if anns:
            gt_boxes = global_boxes_to_lidar(
                np.array([a['translation'] for a in anns]),
                np.array([a['size'] for a in anns]),
                np.array([quaternion_yaw(a['rotation']) for a in anns]),
                ref_cs, ref_pose)
            gt_names = np.array([MAP_NAME_FROM_GENERAL_TO_DETECTION.get(
                a['category_name'], 'ignore') for a in anns])
            num_pts = np.array([a['num_lidar_pts'] for a in anns])
        else:
            gt_boxes = np.zeros((0, 7), np.float32)
            gt_names = np.zeros(0, dtype='<U32')
            num_pts = np.zeros(0, np.int64)

        infos.append({
            'lidar_path': sd['filename'],
            'token': token,
            'timestamp': ref_time,
            'ref_to_global': ref_to_global_transform(ref_cs, ref_pose).astype(np.float32),
            'sweeps': sweeps,
            'gt_boxes': gt_boxes,
            'gt_names': gt_names,
            'num_lidar_pts': num_pts,
        })
    return infos
