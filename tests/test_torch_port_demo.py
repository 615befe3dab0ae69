"""The port's demo and vis entry points (``hvpr_tpu_torch.tools.demo`` and
``.vis``) with ``--device cpu``, against the JAX demo's forward.

A seeded JAX network of hvpr_mini.yaml is carried to the port with
``from_flax_variables`` and saved as a ``.pth``; the demo reads 2 ``.bin``
scans of ``tests/kitti_fixture.py``'s tree. The JAX side runs its own
``DemoDataset`` (``tools/demo.py``) and ``Network.eval_forward`` with the
``.pth`` loaded through ``load_pth_into_variables``, scene i's host draws
seeded with i as the port's demo seeds them. Tolerances, as in
``test_torch_port_cli.py``: the same number of detections and labels a
scene, boxes within 1e-4 (f32, summation order), scores within 1e-5.
Then vis writes a PNG and a ``.ply`` a scene of the tree's val split, and
without matplotlib the demo skips its PNGs and still writes the
``.ply``. Torch runs on one intra-op thread (the plain NMS's
small ops on a host whose cores the test workers share).
"""

import shutil

import numpy as np
import pytest

from kitti_fixture import build_kitti_root
from torch_port_helpers import Pair, mini_cfg, torch_threads

from hvpr_tpu.models import load_data_to_gpu as jax_load_data_to_gpu
from hvpr_tpu.utils.torch_ckpt import load_pth_into_variables
from tools.demo import DemoDataset as JaxDemoDataset

from hvpr_tpu_torch.datasets.kitti.kitti_dataset import create_kitti_infos
from hvpr_tpu_torch.tools import demo, vis, visual_utils
from hvpr_tpu_torch.utils.checkpoint import save_checkpoint

CFG = 'tools/cfgs/kitti_models/hvpr_mini.yaml'


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    base = tmp_path_factory.mktemp('port_demo')
    root, _ = build_kitti_root(base / 'kitti', n_scenes=4)
    create_kitti_infos(root, root, workers=2)
    scans = base / 'scans'
    scans.mkdir()
    for f in sorted((root / 'training' / 'velodyne').glob('*.bin'))[:2]:
        shutil.copy(f, scans / f.name)
    pair = Pair(mini_cfg(), batch=2, n_points=256)
    ckpt = base / 'demo.pth'
    save_checkpoint(pair.tnet.module, ckpt, epoch=1)
    return base, root, scans, pair, ckpt


def jax_demo(pair, scans, ckpt):
    jnet = pair.jnet
    jnet.variables, report = load_pth_into_variables(str(ckpt), jnet.variables)
    assert not report['mismatched'] and not report['missing'], report
    dataset = JaxDemoDataset(pair.cfg.DATA_CONFIG, pair.cfg.CLASS_NAMES, training=False,
                             root_path=scans, ext='.bin')
    out = []
    for i in range(len(dataset)):
        np.random.seed(i)
        batch = dataset.collate_batch([dataset[i]])
        det = jnet.eval_forward(jax_load_data_to_gpu(
            {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}))
        mask = np.asarray(det['pred_mask'][0])
        out.append({'boxes': np.asarray(det['pred_boxes'][0])[mask],
                    'scores': np.asarray(det['pred_scores'][0])[mask],
                    'labels': np.asarray(det['pred_labels'][0])[mask]})
    return out


def test_demo_matches_jax_demo_forward(setup):
    base, _, scans, pair, ckpt = setup
    out = base / 'demo_out'
    got = demo.main(['--cfg_file', CFG, '--data_path', str(scans), '--ckpt', str(ckpt),
                     '--device', 'cpu', '--save_bev', str(out / 'bev'),
                     '--save_3d', str(out / '3d')])
    want = jax_demo(pair, scans, ckpt)
    assert len(got) == len(want) == 2
    assert sum(len(w['boxes']) for w in want) > 0
    for g, w in zip(got, want):
        assert len(g['boxes']) == len(w['boxes'])
        np.testing.assert_array_equal(g['labels'], w['labels'])
        np.testing.assert_allclose(g['boxes'], w['boxes'], rtol=0, atol=1e-4)
        np.testing.assert_allclose(g['scores'], w['scores'], rtol=0, atol=1e-5)
    for i, g in enumerate(got):
        assert (out / 'bev' / f'demo_{i:04d}.png').stat().st_size > 0
        assert (out / '3d' / f'demo_{i:04d}_3d.png').stat().st_size > 0
        ply = (out / '3d' / f'demo_{i:04d}.ply').read_text().splitlines()
        assert f'element edge {12 * len(g["boxes"])}' in ply


def test_demo_without_matplotlib_writes_ply_and_npz(setup, monkeypatch):
    base, _, scans, _, ckpt = setup
    monkeypatch.setattr(visual_utils, 'matplotlib_available', lambda: False)
    out = base / 'demo_nompl'
    demo.main(['--cfg_file', CFG, '--data_path', str(scans / '000000.bin'),
               '--ckpt', str(ckpt), '--device', 'cpu', '--save_bev', str(out),
               '--save_3d', str(out)])
    assert sorted(p.name for p in out.iterdir()) == ['demo_0000.ply']


def test_vis_writes_pictures(setup):
    base, root, _, _, ckpt = setup
    out = base / 'vis_out'
    written = vis.main(['--cfg_file', CFG, '--ckpt', str(ckpt), '--out_dir', str(out),
                        '--max_samples', '2', '--workers', '0', '--device', 'cpu',
                        '--set', 'DATA_CONFIG.DATA_PATH', str(root)])
    names = sorted(p.name for p in out.iterdir())
    assert len(written) == 4 and len(names) == 4
    assert {n.rsplit('.', 1)[1] for n in names} == {'png', 'ply'}
    assert all((out / n).stat().st_size > 0 for n in names)
