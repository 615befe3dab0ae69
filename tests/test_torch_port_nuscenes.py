"""The port's nuScenes data layer and its CLIs against the JAX package's, on
the synthetic v1.0-mini tree of ``tests/test_nuscenes_e2e.py`` (8 samples of
256 points with one past sweep each, a car and a truck a sample) and its
``MINI_NUSC`` config (a 2-class PointPillar, per-class NMS).

Tolerance: none for the data layer. Sweep loading, ego-motion compensation,
the time-lag channel, the balanced resampling, the augmentor and the
processor queue are the same numpy arithmetic in both packages, drawing the
same numbers from numpy's global RNG once it is seeded alike, so every array
must be equal in dtype, shape and value. The predictions' annos, submission
rows and the devkit-free centre-distance evaluation are numpy on the same
detections: equal too, result string included.

The CLIs: the port's train CLI for 1 epoch on the CPU, then its test CLI
with ``--save_to_file``: checkpoints, the post-train evaluation, the
centre-distance AP string and one submission file a frame, as the JAX
package's test of its CLIs (marked slow there) requires.
"""

import copy
import json
import pickle

import numpy as np
import pytest
import torch
import yaml

from test_nuscenes_e2e import MINI_NUSC, _build_nusc_root
from test_torch_port_data import assert_same
from torch_port_helpers import REPO, torch_threads

from hvpr_tpu.config import ConfigDict as JaxConfigDict
from hvpr_tpu.datasets.nuscenes.nuscenes_dataset import NuScenesDataset as JaxNuScenes

from hvpr_tpu_torch import config as port_config
from hvpr_tpu_torch.config import ConfigDict
from hvpr_tpu_torch.datasets.nuscenes import nuscenes_utils
from hvpr_tpu_torch.datasets.nuscenes.nuscenes_dataset import (
    NuScenesDataset, create_nuscenes_infos)
from hvpr_tpu_torch.tools import test as test_cli, train as train_cli
from hvpr_tpu_torch.utils.scans import build_nuscenes_root

CLASSES = MINI_NUSC['CLASS_NAMES']


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope='module')
def data_root(tmp_path_factory):
    return _build_nusc_root(tmp_path_factory.mktemp('nusc'))


def datasets(data_root, training):
    dc = copy.deepcopy(MINI_NUSC['DATA_CONFIG'])
    dc['DATA_PATH'] = str(data_root)
    out = {}
    for name, cls, cfg_cls in (('jax', JaxNuScenes, JaxConfigDict),
                               ('port', NuScenesDataset, ConfigDict)):
        np.random.seed(5)               # the balanced resampling's draws
        out[name] = cls(cfg_cls(copy.deepcopy(dc)), CLASSES, training=training,
                        root_path=data_root)
    return out


@pytest.mark.parametrize('training', [False, True], ids=['test', 'train'])
def test_items_and_batches_match_jax(data_root, training):
    ds = datasets(data_root, training)
    assert [i['token'] for i in ds['port'].infos] == [i['token'] for i in ds['jax'].infos]
    assert len(ds['port']) == (16 if training else 8)       # resampled: 8 a class
    items = {}
    for name, d in ds.items():
        np.random.seed(7)
        items[name] = [d[i] for i in range(4)]
    for i, (want, got) in enumerate(zip(items['jax'], items['port'])):
        assert_same(got, want, f'item {i}')
    pts = items['port'][0]['points']
    assert pts.shape[1] == 5 and set(np.unique(pts[:, 4])) == {0.0, np.float32(0.05)}
    assert items['port'][0]['voxels'].shape[1:] == (8, 5)
    assert_same(ds['port'].collate_batch(items['port']),
                ds['jax'].collate_batch(items['jax']), 'batch')


def test_train_items_without_an_augmentor(data_root):
    """A config without DATA_AUGMENTOR trains on the scenes as they are
    (hvpr_multiclass.yaml's own section names none): the train item's gt
    boxes are the info's, in range, with their class column."""
    dc = copy.deepcopy(MINI_NUSC['DATA_CONFIG'])
    dc['DATA_PATH'] = str(data_root)
    del dc['DATA_AUGMENTOR']
    dc['BALANCED_RESAMPLING'] = False
    d = NuScenesDataset(ConfigDict(dc), CLASSES, training=True, root_path=data_root)
    item = d[0]
    np.testing.assert_array_equal(item['gt_boxes'][:, :7], d.infos[0]['gt_boxes'][:, :7])
    np.testing.assert_array_equal(item['gt_boxes'][:, 7], [1, 2])


def test_sweeps_are_compensated_into_the_reference_frame(data_root):
    """The fixture's sweep transform is a translation by (1, -2, 0.1): the
    sweep's points come back shifted by it, with their time lag."""
    d = datasets(data_root, False)['port']
    info = d.infos[0]
    raw = np.fromfile(str(d.root_path / info['sweeps'][0]['lidar_path']),
                      np.float32).reshape(-1, 5)
    pts, times = d.get_sweep(info['sweeps'][0])
    keep = ~((np.abs(raw[:, 0]) < 1.0) & (np.abs(raw[:, 1]) < 1.0))
    np.testing.assert_allclose(pts[:, :3], raw[keep, :3] + [1.0, -2.0, 0.1], rtol=0,
                               atol=1e-6)
    assert np.all(times == np.float32(0.05))


def fixed_detections(ds, rng):
    """Per frame: each gt box jittered by up to 1.5 m and a false positive,
    with scores; class labels 1-based."""
    preds = []
    for info in ds.infos[:4]:
        boxes = np.asarray(info['gt_boxes'], np.float32)[:, :7].copy()
        boxes[:, :2] += rng.uniform(-1.5, 1.5, (len(boxes), 2))
        fp = boxes[:1].copy()
        fp[:, :2] += 5.0
        labels = np.array([CLASSES.index(n) + 1 for n in info['gt_names']] + [1], np.int32)
        preds.append({'pred_boxes': np.concatenate([boxes, fp]),
                      'pred_scores': rng.uniform(0.2, 1.0, len(labels)).astype(np.float32),
                      'pred_labels': labels})
    return preds


def test_predictions_and_center_distance_evaluation_match_jax(data_root, tmp_path):
    ds = datasets(data_root, False)
    preds = fixed_detections(ds['port'], np.random.default_rng(3))
    batch = {'metadata': [{'token': i['token']} for i in ds['port'].infos[:4]]}
    annos, results = {}, {}
    for name, d in ds.items():
        out = tmp_path / name
        out.mkdir()
        annos[name] = d.generate_prediction_dicts(batch, copy.deepcopy(preds), CLASSES,
                                                  output_path=out)
        results[name] = d.evaluation(annos[name], CLASSES)
        files = sorted(p.name for p in out.glob('*.json'))
        assert files == sorted(f"{m['token']}.json" for m in batch['metadata'])
    assert_same(annos['port'], annos['jax'], 'annos')
    for f in (tmp_path / 'jax').glob('*.json'):
        assert json.loads((tmp_path / 'port' / f.name).read_text()) == json.loads(f.read_text())
    assert results['port'][0] == results['jax'][0]
    assert results['port'][1] == results['jax'][1]
    assert 'center-distance AP' in results['port'][0]
    assert 0 < results['port'][1]['mAP'] < 1
    assert ds['port'].annos_to_nusc_results(annos['port']) == \
        ds['jax'].annos_to_nusc_results(annos['jax'])


def test_create_nuscenes_infos_needs_the_devkit(tmp_path):
    with pytest.raises(ImportError, match='nuscenes devkit'):
        create_nuscenes_infos('v1.0-mini', tmp_path, tmp_path)


def test_pose_math_matches_jax():
    from hvpr_tpu.datasets.nuscenes import nuscenes_utils as jax_utils
    rng = np.random.default_rng(2)
    poses = []
    for _ in range(4):
        q = rng.normal(size=4)
        poses.append({'rotation': q / np.linalg.norm(q),
                      'translation': rng.uniform(-50, 50, 3)})
    np.testing.assert_array_equal(nuscenes_utils.sweep_to_ref_transform(*poses),
                                  jax_utils.sweep_to_ref_transform(*poses))
    args = (rng.uniform(-40, 40, (5, 3)), rng.uniform(0.5, 5, (5, 3)),
            rng.uniform(-3, 3, 5), poses[0], poses[1])
    np.testing.assert_array_equal(nuscenes_utils.global_boxes_to_lidar(*args),
                                  jax_utils.global_boxes_to_lidar(*args))
    assert nuscenes_utils.quaternion_yaw(poses[2]['rotation']) == \
        jax_utils.quaternion_yaw(poses[2]['rotation'])


def test_build_nuscenes_root_is_read_by_both_packages(tmp_path):
    """The port's writer of a synthetic tree (as ``chip_smoke.py`` writes it,
    at a few hundred points a sweep here): 10 sweeps a sample, the five
    nuScenes classes, items equal in both packages."""
    root = build_nuscenes_root(tmp_path, n_train=1, n_val=2, n_points=400)
    cfg = yaml.safe_load(open(f'{REPO}/tools/cfgs/dataset_configs/nuscenes_dataset.yaml'))
    d = {}
    for name, cls, cfg_cls in (('jax', JaxNuScenes, JaxConfigDict),
                               ('port', NuScenesDataset, ConfigDict)):
        d[name] = cls(cfg_cls(copy.deepcopy(cfg)), ['car', 'truck', 'bus', 'pedestrian',
                                                    'traffic_cone'],
                      training=False, root_path=root)
    assert len(d['port']) == 2 and len(d['port'].infos[0]['sweeps']) == 9
    for i in range(2):
        assert_same(d['port'][i], d['jax'][i], f'item {i}')
    item = d['port'][0]
    assert item['points'].shape[1] == 5 and len(np.unique(item['points'][:, 4])) == 10
    assert set(item['gt_boxes'][:, 7].astype(int)) == {1, 2, 3, 4, 5}


def test_cli_train_then_test(data_root, tmp_path, monkeypatch):
    cfg = copy.deepcopy(MINI_NUSC)
    cfg['DATA_CONFIG']['DATA_PATH'] = str(data_root)
    cfg_file = tmp_path / 'cfgs' / 'nuscenes_models' / 'mini_nusc.yaml'
    cfg_file.parent.mkdir(parents=True)
    cfg_file.write_text(yaml.safe_dump(cfg))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(port_config.cfg, 'ROOT_DIR', tmp_path)
    common = ['--cfg_file', 'cfgs/nuscenes_models/mini_nusc.yaml', '--workers', '0',
              '--device', 'cpu', '--extra_tag', 'e2e']
    ret = train_cli.main(common + ['--batch_size', '8', '--epochs', '1'])
    out = tmp_path / 'output' / 'nuscenes_models' / 'mini_nusc' / 'e2e'
    ckpt = out / 'ckpt' / 'checkpoint_epoch_1.pth'
    assert ckpt.exists() and ret['end_it'] == 2          # 16 resampled infos, batch 8
    assert 'car/mAP' in ret['eval'] and 'mAP' in ret['eval']
    logs = ''.join(p.read_text() for p in out.glob('log_train_*.txt'))
    assert 'center-distance AP' in logs

    ret = test_cli.main(common + ['--batch_size', '2', '--ckpt', str(ckpt),
                                  '--save_to_file'])
    assert {'car/mAP', 'truck/mAP', 'mAP'} <= set(ret)
    eval_dir = out / 'eval' / 'epoch_1' / 'val' / 'default'
    with open(eval_dir / 'result.pkl', 'rb') as f:
        annos = pickle.load(f)
    assert len(annos) == 8 and all('metadata' in a for a in annos)
    rows = sorted((eval_dir / 'final_result' / 'data').glob('tok*.json'))
    assert len(rows) == 8
    frame = json.loads(rows[0].read_text())
    assert all(r['detection_name'] in CLASSES for r in frame)
    logs = ''.join(p.read_text() for p in eval_dir.glob('log_eval_*.txt'))
    assert 'center-distance AP' in logs and 'Evaluation done' in logs
    assert torch.load(ckpt, weights_only=True)['epoch'] == 1
