"""The port's train-mode data layer against the JAX package's, on the
synthetic tree of ``tests/kitti_fixture.py`` (4 scenes, 2 in train; 49
cars a scene): the gt database, the gt sampler, the augmentor, train-mode
items and batches, the DataLoader's seeding, and the stop of the process
its workers fork from.

Tolerance: none. The gt database, the sampler's draws and pastes, the
world maps and the processor queue are the same numpy arithmetic in both
packages, drawing the same numbers from numpy's global RNG once it is
seeded alike, so every array must be equal in dtype, shape and value, and
the crop files byte for byte.
"""

import copy
import filecmp
import os
import pickle
import shutil
from multiprocessing import forkserver, resource_tracker

import numpy as np
import pytest
import torch

from kitti_fixture import build_kitti_root
from torch_port_helpers import load_cfg, mini_cfg

from hvpr_tpu.datasets.augmentor.data_augmentor import DataAugmentor as JaxDataAugmentor
from hvpr_tpu.datasets.augmentor.database_sampler import DataBaseSampler as JaxSampler
from hvpr_tpu.datasets.kitti.kitti_dataset import KittiDataset as JaxKittiDataset
from hvpr_tpu.datasets.kitti.kitti_dataset import create_kitti_infos as jax_create_infos
from hvpr_tpu.datasets.kitti.kitti_io import KittiSplitIO as JaxSplitIO

from hvpr_tpu_torch.datasets import build_dataloader, stop_worker_server
from hvpr_tpu_torch.datasets.augmentor.data_augmentor import DataAugmentor
from hvpr_tpu_torch.datasets.augmentor.database_sampler import DataBaseSampler, _ClassDb
from hvpr_tpu_torch.datasets.kitti.kitti_dataset import KittiDataset, create_kitti_infos
from hvpr_tpu_torch.utils import box_utils

from test_torch_port_data import assert_same


@pytest.fixture(scope='module')
def trees(tmp_path_factory):
    """The fixture tree with the port's infos and gt database in it, the
    JAX package's under ``jax/`` and the port's again under ``port/``."""
    base = tmp_path_factory.mktemp('kitti_port_train_data')
    root, _ = build_kitti_root(base / 'kitti', n_scenes=4)
    jax_dir, port_dir = base / 'jax', base / 'port'
    jax_dir.mkdir()
    port_dir.mkdir()
    jax_create_infos(None, ['Car'], root, jax_dir, workers=2)
    create_kitti_infos(root, port_dir, workers=2)
    create_kitti_infos(root, root, workers=2)
    return root, jax_dir, port_dir


def sampler_cfg(limit_whole_scene, groups=('Car:15',)):
    return {'NAME': 'gt_sampling', 'USE_ROAD_PLANE': True,
            'DB_INFO_PATH': ['kitti_dbinfos_train.pkl'],
            'PREPARE': {'filter_by_min_points': ['Car:5', 'Pedestrian:5'],
                        'filter_by_difficulty': [-1]},
            'SAMPLE_GROUPS': list(groups), 'NUM_POINT_FEATURES': 4,
            'DATABASE_WITH_FAKELIDAR': False, 'REMOVE_EXTRA_WIDTH': [0.0, 0.0, 0.0],
            'LIMIT_WHOLE_SCENE': limit_whole_scene}


def scene(root, k=5):
    """A train scene cut to its first ``k`` cars (its points kept), with its
    calibration and road plane, as the dataset hands it to the augmentor."""
    io = JaxSplitIO(root, 'train')
    with open(root / 'kitti_infos_train.pkl', 'rb') as f:
        info = pickle.load(f)[0]
    fid = info['point_cloud']['lidar_idx']
    annos = info['annos']
    return {'points': io.lidar(fid), 'gt_boxes': annos['gt_boxes_lidar'][:k].copy(),
            'gt_names': annos['name'][:k].copy(), 'gt_boxes_mask': np.ones(k, bool),
            'calib': io.calib(fid), 'road_plane': io.road_plane(fid)}


def test_gt_database_equal(trees):
    """Both packages' gt databases: the crop files byte for byte and
    ``kitti_dbinfos_train.pkl``."""
    _, jax_dir, port_dir = trees
    names = sorted(p.name for p in (jax_dir / 'gt_database').iterdir())
    assert len(names) == 2 * 49
    assert names == sorted(p.name for p in (port_dir / 'gt_database').iterdir())
    _, mismatch, errors = filecmp.cmpfiles(jax_dir / 'gt_database', port_dir / 'gt_database',
                                           names, shallow=False)
    assert not mismatch and not errors
    db = {}
    for name, d in (('jax', jax_dir), ('port', port_dir)):
        with open(d / 'kitti_dbinfos_train.pkl', 'rb') as f:
            db[name] = pickle.load(f)
    assert len(db['port']['Car']) == 98
    assert_same(db['port'], db['jax'], 'dbinfos')


@pytest.mark.parametrize('limit_whole_scene', [False, True])
def test_sampler_pastes_as_jax(trees, limit_whole_scene):
    """Eight scenes through each sampler (the port reading the JAX
    package's database) from one numpy seed: points, boxes, names, the
    drawn order and the cursor equal; cars are pasted, some candidates are
    rejected by the collision rule, and the pasted boxes sit on the road
    plane."""
    root, jax_dir, _ = trees
    cfg = sampler_cfg(limit_whole_scene)
    samplers = {'jax': JaxSampler(jax_dir, cfg, ['Car']),
                'port': DataBaseSampler(jax_dir, cfg, ['Car'])}
    assert len(samplers['port'].db['Car']) == len(samplers['jax'].db['Car']) > 0
    outs = {}
    for name, sampler in samplers.items():
        np.random.seed(11)
        outs[name] = [sampler(scene(root)) for _ in range(8)]
    assert_same(outs['port'], outs['jax'], 'scenes')
    for attr in ('_order', '_cursor'):
        assert_same(getattr(samplers['port'].db['Car'], attr),
                    getattr(samplers['jax'].db['Car'], attr), attr)
    pasted = [len(o['gt_boxes']) - 5 for o in outs['port']]
    want = 10 if limit_whole_scene else 15
    assert 0 < max(pasted) and min(pasted) < want, pasted
    assert all('calib' not in o and 'gt_boxes_mask' not in o for o in outs['port'])


def test_sampler_with_an_empty_class(trees):
    """A class that the database lacks (Pedestrian) is an empty column
    store, as on the JAX side (``tests/test_data_edge_cases.py``). Drawing
    from it takes no candidates: the JAX sampler raises there (the maximum
    over an empty axis in ``_collision_free``), the port's pastes the other
    class alone, equal to the JAX sampler without the empty class's group
    from the same seed (an empty draw takes no random numbers)."""
    root, jax_dir, _ = trees
    db = _ClassDb([])
    assert len(db) == 0 and db.boxes.shape == (0, 7) and db.draw(3).size == 0
    assert len(db.keep(np.zeros(0, bool))) == 0
    with_empty = sampler_cfg(False, groups=('Car:6', 'Pedestrian:4'))
    jax_sampler = JaxSampler(jax_dir, with_empty, ['Car', 'Pedestrian'])
    assert len(jax_sampler.db['Pedestrian']) == 0
    with pytest.raises(ValueError, match='zero-size array'):
        jax_sampler(scene(root))

    port = DataBaseSampler(jax_dir, with_empty, ['Car', 'Pedestrian'])
    jax = JaxSampler(jax_dir, sampler_cfg(False, groups=('Car:6',)), ['Car', 'Pedestrian'])
    assert len(port.db['Pedestrian']) == 0 and port.quota == {'Car': 6, 'Pedestrian': 4}
    outs = {}
    for name, sampler in (('jax', jax), ('port', port)):
        np.random.seed(2)
        outs[name] = [sampler(scene(root)) for _ in range(3)]
    assert_same(outs['port'], outs['jax'], 'scenes')
    assert all(set(o['gt_names']) == {'Car'} for o in outs['port'])
    assert max(len(o['gt_boxes']) for o in outs['port']) > 5


def test_fakelidar_boxes_convert_as_the_reference():
    """``boxes3d_kitti_fakelidar_to_lidar`` (the sampler calls it under
    DATABASE_WITH_FAKELIDAR): [x, y, z_bottom, w, l, h, r] ->
    [x, y, z_bottom + h/2, l, w, h, -(r + pi/2)]."""
    boxes = np.array([[1.0, 2.0, -1.5, 1.6, 3.9, 1.56, 0.3],
                      [-4.0, 0.5, -2.0, 0.6, 0.8, 1.7, -2.0]], np.float32)
    got = box_utils.boxes3d_kitti_fakelidar_to_lidar(boxes.copy())
    want = np.stack([boxes[:, 0], boxes[:, 1], boxes[:, 2] + boxes[:, 5] / 2,
                     boxes[:, 4], boxes[:, 3], boxes[:, 5],
                     -(boxes[:, 6] + np.pi / 2)], axis=1)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def augmentor_cfg(which):
    """The augmentor list of ``which``: one world step, hvpr.yaml's list
    (gt sampling of Pedestrian and Cyclist only, so nothing is pasted for
    Car), or the KITTI base list (Car:20 with LIMIT_WHOLE_SCENE)."""
    if which in ('hvpr', 'kitti_base'):
        name = 'hvpr.yaml' if which == 'hvpr' else 'pointpillar.yaml'
        return copy.deepcopy(load_cfg(name).DATA_CONFIG.DATA_AUGMENTOR)
    steps = {'flip': {'NAME': 'random_world_flip', 'ALONG_AXIS_LIST': ['x', 'y']},
             'rotation': {'NAME': 'random_world_rotation',
                          'WORLD_ROT_ANGLE': [-0.78539816, 0.78539816]},
             'scaling': {'NAME': 'random_world_scaling', 'WORLD_SCALE_RANGE': [0.95, 1.05]}}
    return {'DISABLE_AUG_LIST': ['placeholder'], 'AUG_CONFIG_LIST': [steps[which]]}


@pytest.mark.parametrize('which', ['flip', 'rotation', 'scaling', 'hvpr', 'kitti_base'])
def test_augmentor_forward_equals_jax(trees, which):
    root, _, _ = trees
    cfg = augmentor_cfg(which)
    if which == 'kitti_base':
        assert cfg['AUG_CONFIG_LIST'][0]['SAMPLE_GROUPS'][0] == 'Car:20'
    outs = {}
    for name, cls in (('jax', JaxDataAugmentor), ('port', DataAugmentor)):
        aug = cls(root, cfg, ['Car'])
        np.random.seed(5)
        outs[name] = [aug.forward(scene(root)) for _ in range(4)]
    assert_same(outs['port'], outs['jax'], which)
    first = scene(root)['gt_boxes']
    out = outs['port'][0]
    assert 'calib' not in out and 'road_plane' not in out and 'gt_boxes_mask' not in out
    assert np.all((out['gt_boxes'][:, 6] >= -np.pi) & (out['gt_boxes'][:, 6] < np.pi))
    n_boxes = [len(o['gt_boxes']) for o in outs['port']]
    if which == 'kitti_base':
        assert max(n_boxes) > 5                     # cars pasted
    else:
        assert n_boxes == [5] * 4                   # nothing to paste
        assert any(not np.array_equal(o['gt_boxes'], first) for o in outs['port'])


def train_data_cfg(root):
    """hvpr_mini.yaml with the KITTI base list's gt sampling of cars (no
    scene limit, so cars are pasted into the fixture's full scenes)."""
    cfg = mini_cfg()
    cfg.DATA_CONFIG.DATA_PATH = str(root)
    gt = sampler_cfg(False)
    cfg.DATA_CONFIG.DATA_AUGMENTOR.AUG_CONFIG_LIST.insert(0, gt)
    return cfg


@pytest.mark.parametrize('merge', [False, True])
def test_train_items_and_batches_equal(trees, tmp_path, merge):
    """Train-mode items (gt paste, flip, rotation, scaling, shuffled and
    sampled points, host voxels) and the collated batch equal the JAX
    package's, both reading the port's infos and database. The first scene
    has its boxes removed from its info, so its item is the resample of a
    random other scene, as in the JAX package; the second keeps 5 of its
    boxes in its info, so that pasted cars find room. With
    ``merge_all_iters_to_one_epoch`` over 3 epochs the dataset is 3 times
    as long and index i reads scene i mod 2."""
    root, _, _ = trees
    data_root = tmp_path / 'kitti'
    shutil.copytree(root, data_root, symlinks=True)
    with open(data_root / 'kitti_infos_train.pkl', 'rb') as f:
        infos = pickle.load(f)
    infos[0]['annos'] = {k: v[:0] for k, v in infos[0]['annos'].items()}
    infos[1]['annos'] = {k: v[:5] for k, v in infos[1]['annos'].items()}
    with open(data_root / 'kitti_infos_train.pkl', 'wb') as f:
        pickle.dump(infos, f)

    dc = train_data_cfg(data_root).DATA_CONFIG
    datasets = {'jax': JaxKittiDataset(dc, ['Car'], training=True, root_path=data_root),
                'port': KittiDataset(dc, ['Car'], training=True, root_path=data_root)}
    if merge:
        for ds in datasets.values():
            ds.merge_all_iters_to_one_epoch(merge=True, epochs=3)
    assert len(datasets['port']) == len(datasets['jax']) == (6 if merge else 2)
    items = {}
    for name, ds in datasets.items():
        np.random.seed(7)
        items[name] = [ds[i] for i in range(len(ds))]
    for i, (want, got) in enumerate(zip(items['jax'], items['port'])):
        assert_same(got, want, f'item {i}')
        assert len(got['gt_boxes']) > 0
        assert got['voxels'].shape[1:] == (8, 4)
    assert max(len(it['gt_boxes']) for it in items['port']) > 5       # cars pasted
    assert_same(datasets['port'].collate_batch(items['port']),
                datasets['jax'].collate_batch(items['jax']), 'batch')


def _epoch_boxes(loader):
    """{frame id: gt_boxes} of one epoch of a batch-1 loader, in order."""
    out = {}
    for batch in loader:
        out[batch['frame_id'][0]] = batch['gt_boxes'][0]
    return out


def test_loader_seeding_differs_by_epoch_and_follows_torch_seed(trees):
    """Two workers: the two epochs of a train loader draw other
    augmentations (each frame's boxes differ, and so do the world scales
    drawn, whatever frame a worker got), and two loaders started after the
    same ``torch.manual_seed`` read the same batches. The augmentor is
    hvpr_mini's world scaling alone, so that every box stays in range and
    the first box's scale is the scale drawn."""
    root, _, _ = trees
    cfg = mini_cfg()
    cfg.DATA_CONFIG.DATA_PATH = str(root)
    cfg.DATA_CONFIG.DATA_AUGMENTOR.AUG_CONFIG_LIST = [
        s for s in cfg.DATA_CONFIG.DATA_AUGMENTOR.AUG_CONFIG_LIST
        if s['NAME'] == 'random_world_scaling']
    with open(root / 'kitti_infos_train.pkl', 'rb') as f:
        dx = {i['point_cloud']['lidar_idx']: i['annos']['gt_boxes_lidar'][0, 3]
              for i in pickle.load(f)}
    runs = []
    for _ in range(2):
        torch.manual_seed(3)
        _, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 1,
                                        root_path=root, workers=2, training=True)
        runs.append([_epoch_boxes(loader) for _ in range(2)])
    (a1, a2), (b1, b2) = runs
    assert set(a1) == set(a2) == set(dx)
    for fid in a1:
        assert not np.array_equal(a1[fid], a2[fid]), fid

    def scales(epoch):
        # the world scale each worker drew (to 1e-5: the f32 boxes of two
        # frames give the same scale to a few ulps)
        return sorted(round(float(boxes[0, 3] / dx[fid]), 5) for fid, boxes in epoch.items())
    assert scales(a1) != scales(a2), scales(a1)
    for x, y in ((a1, b1), (a2, b2)):
        assert list(x) == list(y)
        for fid in x:
            np.testing.assert_array_equal(x[fid], y[fid])


def test_stop_worker_server_leaves_no_process(trees):
    """A loader's workers fork from a server process, which starts a
    resource tracker; ``stop_worker_server`` ends and reaps both, so a
    process that calls it leaves neither running, and a later loader
    starts them anew."""
    root, _, _ = trees
    cfg = mini_cfg()
    cfg.DATA_CONFIG.DATA_PATH = str(root)
    for _ in range(2):
        _, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 1,
                                        root_path=root, workers=2, training=True)
        assert len(list(loader)) == 2
        pids = [forkserver._forkserver._forkserver_pid, resource_tracker._resource_tracker._pid]
        assert None not in pids
        stop_worker_server()
        for pid in pids:
            assert not os.path.exists(f'/proc/{pid}'), pid
