"""The port's evaluation entry point against the JAX package's, from one
``.pth`` file, on the synthetic fixture tree (4 scenes, 2 in val) with
hvpr_mini.yaml.

A seeded JAX network is carried to the port with ``from_flax_variables``;
the port writes the ``.pth``; the JAX ``eval_one_epoch`` runs the JAX
network with that file loaded through ``load_pth_into_variables``, and the
port's ``eval_one_epoch`` runs the port's network (device ``cpu``) with it
loaded through ``load_params_from_file``. Both read the same host batches
(numpy's RNG seeded alike before each run).

Tolerances: boxes within 1e-4 (f32, the two forwards differ in summation
order only, as in ``test_torch_port_mini.py``), scores within 1e-5; the
number of detections a frame and the names are equal; so are the recall
counts and the AP and recall keys of the result dict (to 1e-9): they
depend only on which detections match, the detections agree to 1e-4 and
none of them sits that close to an IoU threshold of the evaluator on this
fixture, so the matches are the same. The AOS keys (``*_aos/*``) are not
discrete: AOS sums (1 + cos dtheta) / 2 over the matched boxes, so it moves
with the headings, which are held to 1e-4 only (summation order on the
CPU, which differs between a lone run and a pytest-xdist worker, moves a
heading in its last bits). Their bound follows from the heading
tolerance: |d/dtheta (1 + cos dtheta) / 2| <= 1/2, times 100 for percent,
times 1e-4.
"""

import logging
import pickle

import numpy as np
import pytest
import torch

from kitti_fixture import build_kitti_root
from torch_port_helpers import Pair, mini_cfg

from hvpr_tpu.datasets import build_dataloader as jax_build_dataloader
from hvpr_tpu.utils.torch_ckpt import load_pth_into_variables
from tools.eval_utils import eval_utils as jax_eval_utils

from hvpr_tpu_torch import config as port_config
from hvpr_tpu_torch.datasets import build_dataloader
from hvpr_tpu_torch.datasets.kitti.kitti_dataset import create_kitti_infos
from hvpr_tpu_torch.models import build_network
from hvpr_tpu_torch.tools import eval_utils, test as test_cli
from hvpr_tpu_torch.utils.checkpoint import load_params_from_file, save_checkpoint

EPOCH = 3
BOX_ATOL = 1e-4                      # the boxes' tolerance, the headings' too
AOS_ATOL = 0.5 * 100 * BOX_ATOL      # max |d AOS / d heading| in percent, times it: 5e-3


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    base = tmp_path_factory.mktemp('port_cli')
    root, _ = build_kitti_root(base / 'kitti', n_scenes=4)
    create_kitti_infos(root, root, workers=2)
    pair = Pair(mini_cfg(), batch=2, n_points=256)
    cfg = pair.cfg
    cfg.DATA_CONFIG.DATA_PATH = str(root)
    ckpt = base / 'ckpt' / f'checkpoint_epoch_{EPOCH}.pth'
    ckpt.parent.mkdir()
    save_checkpoint(pair.tnet.module, ckpt, epoch=EPOCH)
    return base, root, pair, cfg, ckpt


def logger():
    log = logging.getLogger('test_torch_port_cli')
    log.setLevel(logging.WARNING)
    return log


@pytest.fixture(scope='module')
def results(setup):
    base, root, pair, cfg, ckpt = setup
    jnet = pair.jnet
    jnet.variables, report = load_pth_into_variables(str(ckpt), jnet.variables)
    assert not report['mismatched'] and not report['missing'], report
    _, jloader, _ = jax_build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size=2,
                                         root_path=root, workers=0, training=False)
    np.random.seed(0)
    jret = jax_eval_utils.eval_one_epoch(cfg, jnet, jloader, EPOCH, logger(),
                                         result_dir=base / 'jax')

    test_set, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 2,
                                           root_path=root, workers=0)
    net = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), test_set, device='cpu')
    epoch, _ = load_params_from_file(net.module, ckpt)
    assert epoch == EPOCH
    np.random.seed(0)
    pret = eval_utils.eval_one_epoch(cfg, net, loader, epoch, logger(),
                                     result_dir=base / 'port')
    annos = {}
    for name in ('jax', 'port'):
        with open(base / name / 'result.pkl', 'rb') as f:
            annos[name] = pickle.load(f)
    return jret, pret, annos


def test_detections_match_jax(results):
    _, _, annos = results
    want, got = annos['jax'], annos['port']
    assert len(got) == len(want) == 2
    assert sum(len(a['name']) for a in got) > 0
    for w, g in zip(want, got):
        assert g['frame_id'] == w['frame_id']
        assert len(g['name']) == len(w['name'])
        np.testing.assert_array_equal(g['name'], w['name'])
        np.testing.assert_allclose(g['boxes_lidar'], w['boxes_lidar'], rtol=0, atol=BOX_ATOL)
        np.testing.assert_allclose(g['score'], w['score'], rtol=0, atol=1e-5)


def test_recall_and_ap_match_jax(results):
    jret, pret, _ = results
    assert {k for k in pret if not k.startswith('eval_time/')} == set(jret)
    assert 'Car_3d/moderate_R40' in jret and 'recall/roi_0.3' in jret
    assert any('_aos/' in k for k in jret)
    for k, v in jret.items():
        atol = AOS_ATOL if '_aos/' in k else 1e-9
        np.testing.assert_allclose(float(pret[k]), float(v), rtol=0, atol=atol, err_msg=k)
    assert pret['eval_time/scans_per_s'] > 0


def test_cli_main_single_and_eval_all(setup, monkeypatch):
    """``main`` on the CPU: a single checkpoint with --save_to_file, then
    --eval_all over the checkpoint directory (no waiting)."""
    base, root, _, _, ckpt = setup
    monkeypatch.setattr(port_config.cfg, 'ROOT_DIR', base / 'out')
    common = ['--cfg_file', 'tools/cfgs/kitti_models/hvpr_mini.yaml', '--batch_size', '2',
              '--workers', '0', '--device', 'cpu']
    ret = test_cli.main(common + ['--ckpt', str(ckpt), '--save_to_file',
                                  '--set', 'DATA_CONFIG.DATA_PATH', str(root)])
    assert 'Car_3d/moderate' in ret
    eval_dir = base / 'out' / 'output' / 'cfgs' / 'kitti_models' / 'hvpr_mini' / 'default' / 'eval'
    single = eval_dir / f'epoch_{EPOCH}' / 'val' / 'default'
    assert (single / 'result.pkl').exists()
    assert len(list((single / 'final_result' / 'data').glob('*.txt'))) == 2

    assert test_cli.main(common + ['--eval_all', '--ckpt_dir', str(ckpt.parent),
                                   '--max_waiting_mins', '0',
                                   '--set', 'DATA_CONFIG.DATA_PATH', str(root)]) is None
    all_dir = eval_dir / 'eval_all_default' / 'default'
    lines = (all_dir / 'eval_all.jsonl').read_text().splitlines()
    assert len(lines) == 1 and f'"epoch": "{EPOCH}"' in lines[0]
    assert (all_dir / f'epoch_{EPOCH}' / 'val' / 'result.pkl').exists()
    assert (all_dir / 'eval_list_val.txt').read_text().split() == [str(EPOCH)]


def test_checkpoint_round_trip_and_partial_load(setup, tmp_path):
    _, _, pair, cfg, _ = setup
    src = pair.tnet.module
    path = tmp_path / 'checkpoint_epoch_7.pth'
    save_checkpoint(src, path, epoch=7)
    fresh = build_network(cfg.MODEL, 1, pair.meta, device='cpu').module
    epoch, report = load_params_from_file(fresh, path)
    assert epoch == 7 and not report['mismatched'] and not report['not_updated']
    want = src.state_dict()
    assert fresh.state_dict().keys() == want.keys()
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, want[k]), k

    # a shape-mismatched key is reported and not loaded; a key the module
    # lacks (a training checkpoint's point stream) is reported as unused
    state = {k: v.clone() for k, v in want.items()}
    state['dense_head.conv_cls.bias'] = torch.zeros(5)
    state['backbone_3d.SA_modules.0.mlps.0.0.weight'] = torch.zeros(8, 4, 1, 1)
    state['vfe.pfn_layers.0.linear.weight'] += 1.0
    torch.save({'model_state': state}, tmp_path / 'odd.pth')
    before = fresh.state_dict()['dense_head.conv_cls.bias'].clone()
    epoch, report = load_params_from_file(fresh, tmp_path / 'odd.pth')
    assert epoch is None
    assert [m.split(':')[0] for m in report['mismatched']] == ['dense_head.conv_cls.bias']
    assert report['unused'] == ['backbone_3d.SA_modules.0.mlps.0.0.weight']
    assert report['not_updated'] == ['dense_head.conv_cls.bias']
    assert torch.equal(fresh.state_dict()['dense_head.conv_cls.bias'], before)
    assert torch.equal(fresh.state_dict()['vfe.pfn_layers.0.linear.weight'],
                       state['vfe.pfn_layers.0.linear.weight'])
