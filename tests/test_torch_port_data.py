"""The port's KITTI data layer against the JAX package's, on the synthetic
tree of ``tests/kitti_fixture.py`` (4 scenes, 2 in val).

Tolerance: none. Info building, the test-mode items and the collated
batches are the same numpy arithmetic in both packages, and both draw the
same numbers from numpy's global RNG (``sample_points``) once it is seeded
alike, so every array must be equal in dtype, shape and value. The same
holds for the host voxelizer and the synthetic KITTI writer (byte for
byte).
"""

import filecmp
import pickle
import shutil

import numpy as np
import pytest
import torch

from kitti_fixture import build_kitti_root

from hvpr_tpu.datasets.kitti.kitti_dataset import KittiDataset as JaxKittiDataset
from hvpr_tpu.datasets.kitti.kitti_dataset import create_kitti_infos as jax_create_infos
from hvpr_tpu.datasets.processor.point_feature_encoder import (
    PointFeatureEncoder as JaxPointFeatureEncoder)
from hvpr_tpu.ops.voxelizer import VoxelGeneratorNumpy as JaxVoxelGenerator

from hvpr_tpu_torch.datasets import StridedEvalSampler, build_dataloader
from hvpr_tpu_torch.datasets.kitti.kitti_dataset import KittiDataset, create_kitti_infos
from hvpr_tpu_torch.datasets.kitti.kitti_io import png_shape
from hvpr_tpu_torch.models import DatasetMeta, build_network
from hvpr_tpu_torch.ops.voxelizer import VoxelGeneratorNumpy
from hvpr_tpu_torch.utils.scans import build_kitti_root as port_build_kitti_root
from torch_port_helpers import mini_cfg

SPLITS = ('train', 'val', 'test', 'trainval')


@pytest.fixture(scope='module')
def trees(tmp_path_factory):
    """The fixture tree with the JAX package's infos under ``jax/`` and the
    port's under ``port/``."""
    base = tmp_path_factory.mktemp('kitti_port_data')
    root, _ = build_kitti_root(base / 'kitti', n_scenes=4)
    jax_dir, port_dir = base / 'jax', base / 'port'
    jax_dir.mkdir()
    port_dir.mkdir()
    jax_create_infos(None, ['Car'], root, jax_dir, workers=2)
    create_kitti_infos(root, port_dir, workers=2)
    return root, jax_dir, port_dir


def data_cfg(root):
    cfg = mini_cfg()
    cfg.DATA_CONFIG.DATA_PATH = str(root)
    return cfg


def assert_same(a, b, where=''):
    """Deep equality of nested dicts / lists / arrays, dtypes included."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (where, a.keys(), b.keys())
        for k in a:
            assert_same(a[k], b[k], f'{where}.{k}')
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f'{where}[{i}]')
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype, b.dtype,
                                                           a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif hasattr(a, 'P2'):                                 # Calibration
        for attr in ('P2', 'R0', 'V2C'):
            assert_same(getattr(a, attr), getattr(b, attr), f'{where}.{attr}')
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


@pytest.mark.parametrize('split', SPLITS)
def test_info_pickles_equal(trees, split):
    _, jax_dir, port_dir = trees
    with open(jax_dir / f'kitti_infos_{split}.pkl', 'rb') as f:
        want = pickle.load(f)
    with open(port_dir / f'kitti_infos_{split}.pkl', 'rb') as f:
        got = pickle.load(f)
    assert len(got) == {'train': 2, 'val': 2, 'test': 0, 'trainval': 4}[split]
    assert_same(got, want, split)


@pytest.mark.parametrize('infos_of', ['jax', 'port'])
def test_test_mode_items_and_batches_equal(trees, infos_of):
    """Both packages read one package's val infos (so each reads the
    other's once); the items and the collated batch are equal key by key."""
    root, jax_dir, port_dir = trees
    info_dir = jax_dir if infos_of == 'jax' else port_dir
    shutil.copy(info_dir / 'kitti_infos_val.pkl', root / 'kitti_infos_val.pkl')
    dc = data_cfg(root).DATA_CONFIG
    jds = JaxKittiDataset(dc, ['Car'], training=False, root_path=root)
    pds = KittiDataset(dc, ['Car'], training=False, root_path=root)
    assert len(jds) == len(pds) == 2

    items = {}
    for name, ds in (('jax', jds), ('port', pds)):
        np.random.seed(3)
        items[name] = [ds[i] for i in range(len(ds))]
    for i, (want, got) in enumerate(zip(items['jax'], items['port'])):
        assert_same(got, want, f'item {i}')
        assert got['voxels'].shape[1:] == (8, 4)          # hvpr_mini P, C
    assert_same(pds.collate_batch(items['port']), jds.collate_batch(items['jax']),
                'batch')


def test_png_shape_matches_pil(trees):
    from PIL import Image
    root, _, _ = trees
    for png in sorted((root / 'training' / 'image_2').glob('*.png')):
        with Image.open(png) as im:
            assert png_shape(png).tolist() == [im.size[1], im.size[0]]
        assert png_shape(png).dtype == np.int32


def test_voxel_generator_equal_on_overflow():
    """A scan with more occupied voxels than the cap and more points than
    the per-voxel cap: voxels, coords and counts equal the JAX package's."""
    rng = np.random.default_rng(5)
    pts = np.concatenate([
        rng.uniform([0, -4, -2.5, 0], [8, 4, 0.5, 1], (3000, 4)),
        rng.normal([2, 1, -1, 0.5], 0.05, (200, 4)),           # one dense pillar
    ]).astype(np.float32)
    rng.shuffle(pts)
    args = dict(voxel_size=[0.16, 0.16, 3], point_cloud_range=[0, -4, -2.5, 8, 4, 0.5],
                max_num_points=32, max_voxels=600)
    want = JaxVoxelGenerator(**args).generate(pts)
    got = VoxelGeneratorNumpy(**args).generate(pts)
    assert len(got[0]) == 600 and got[2].max() == 32
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_kitti_writer_matches_fixture(tmp_path):
    """The port's PIL-free writer gives the fixture's files byte for byte
    (velodyne, calib, labels, planes, ImageSets) and images of its size."""
    a, scenes_a = build_kitti_root(tmp_path / 'fixture', n_scenes=3)
    b, scenes_b = port_build_kitti_root(tmp_path / 'port', n_scenes=3)
    for sub in ('training/velodyne', 'training/calib', 'training/label_2',
                'training/planes', 'ImageSets'):
        names = sorted(p.name for p in (a / sub).iterdir())
        assert names == sorted(p.name for p in (b / sub).iterdir()), sub
        match, mismatch, errors = filecmp.cmpfiles(a / sub, b / sub, names, shallow=False)
        assert not mismatch and not errors, (sub, mismatch, errors)
    for png in sorted((a / 'training' / 'image_2').glob('*.png')):
        assert png_shape(png).tolist() == png_shape(b / 'training' / 'image_2' / png.name).tolist()
    for sid in scenes_a:
        np.testing.assert_array_equal(scenes_a[sid], scenes_b[sid])


def test_train_mode_and_dist_samplers(trees):
    """The train mode builds its augmentor (hvpr_mini's flip, rotation and
    scaling; it raised before the augmentor was ported, and
    tests/test_torch_port_train_data.py holds it to the JAX package's);
    loading over processes (``dist=True``) takes this rank's sampler, at
    world size 1 (no process group) every scene: a DistributedSampler in
    training, the strided eval sampler in evaluation
    (tests/test_torch_port_ddp.py checks both at world sizes 2 and 3)."""
    root, _, port_dir = trees
    dc = data_cfg(root).DATA_CONFIG
    ds = KittiDataset(dc, ['Car'], training=True, root_path=port_dir)
    assert [kind for kind, _ in ds.data_augmentor.steps] == ['world'] * 3
    assert ds.mode == 'train' and len(ds) == 2
    _, loader, sampler = build_dataloader(dc, ['Car'], 2, dist=True, root_path=port_dir,
                                          workers=0, training=True)
    assert isinstance(sampler, torch.utils.data.distributed.DistributedSampler)
    assert loader.sampler is sampler and (sampler.num_replicas, sampler.rank) == (1, 0)
    assert sorted(sampler) == [0, 1]
    test_set, loader, sampler = build_dataloader(dc, ['Car'], 2, dist=True,
                                                 root_path=port_dir, workers=0)
    assert isinstance(sampler, StridedEvalSampler) and loader.sampler is sampler
    assert list(sampler) == list(range(len(test_set)))


def test_five_feature_encoding_sizes_the_network():
    """DatasetMeta takes the point feature count from POINT_FEATURE_ENCODING
    (as the JAX dataset's encoder does): 5 features make an 11-channel PFN
    input, and a 5-channel padded batch runs through the network."""
    cfg = mini_cfg()
    enc = {'encoding_type': 'absolute_coordinates_encoding',
           'used_feature_list': ['x', 'y', 'z', 'intensity', 'elongation'],
           'src_feature_list': ['x', 'y', 'z', 'intensity', 'elongation']}
    cfg.DATA_CONFIG.POINT_FEATURE_ENCODING = enc
    meta = DatasetMeta(cfg.DATA_CONFIG, cfg.CLASS_NAMES)
    assert meta.num_point_features == 5 == JaxPointFeatureEncoder(enc).num_point_features
    net = build_network(cfg.MODEL, 1, meta, device='cpu')
    assert net.module.vfe.pfn_layers[0].linear.in_features == 11

    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.uniform(meta.point_cloud_range[:3],
                                      meta.point_cloud_range[3:], (300, 3)),
                          rng.uniform(0, 1, (300, 2))], axis=1).astype(np.float32)
    vox, coords, cnt = VoxelGeneratorNumpy(meta.voxel_size, meta.point_cloud_range,
                                           meta.max_points_per_voxel,
                                           meta.max_voxels).generate(pts)
    v = meta.max_voxels
    batch = {'voxels': np.zeros((1, v, meta.max_points_per_voxel, 5), np.float32),
             'voxel_coords': np.zeros((1, v, 3), np.int32),
             'voxel_num_points': np.zeros((1, v), np.int32)}
    batch['voxels'][0, :len(vox)] = vox
    batch['voxel_coords'][0, :len(vox)] = coords
    batch['voxel_num_points'][0, :len(vox)] = cnt
    batch['voxel_mask'] = batch['voxel_num_points'] > 0
    out = net.eval_forward({k: torch.from_numpy(a) for k, a in batch.items()})
    assert torch.isfinite(out['pred_scores']).all()


def test_port_dataset_meta_and_yaml_agree(trees):
    """The attributes the network reads of a dataset are the same on the
    port's KittiDataset and on DatasetMeta."""
    root, _, port_dir = trees
    dc = data_cfg(root).DATA_CONFIG
    ds = KittiDataset(dc, ['Car'], training=False, root_path=port_dir)
    meta = DatasetMeta(dc, ['Car'])
    for attr in ('point_cloud_range', 'voxel_size', 'grid_size'):
        np.testing.assert_array_equal(getattr(ds, attr), getattr(meta, attr))
    for attr in ('num_point_features', 'max_points_per_voxel', 'max_voxels'):
        assert getattr(ds, attr) == getattr(meta, attr), attr
