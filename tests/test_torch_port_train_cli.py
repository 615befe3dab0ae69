"""The port's training entry point against the JAX package, on the CPU, with
hvpr_mini.yaml at batch 2 on the synthetic fixture tree (4 scenes, 2 in
train, 2 in val).

- Padded step: one port train step on a padded batch of the port's train
  loader (host-voxelized (B, V, P, C) pillars, augmented) against the JAX
  ``make_train_step`` on the same batch, from the same flax-initialized
  weights (``from_flax_variables``), TRAIN_ATTEND_MODE gather as in
  ``tests/test_torch_port_train_step.py``, with its one-step tolerances:
  loss terms and grad norm rtol 1e-4, and 99% of the updated parameters
  within 1e-6 relative (the arithmetic is the JAX package's, summed in
  another order; see that file for why a few weights may step the other
  way).
- Padded = flat in the port: the same step (the shipped fused mode) on the
  same points through the device voxelizer's flat layout. The pillar
  features and everything after them are the same numbers, but the
  VFE's BatchNorms sum their masked statistics over the rows in another
  order (B*V*P pillar slots against B*N sorted points): loss terms and
  grad norm rtol 1e-5 (f32 rounding of those sums, carried through one
  forward and backward).
- Resume: a save, load and step equals the uninterrupted second step bit
  for bit (losses, grad norm, every weight and statistic), with the
  optimizer's count and lr restored.
- CLI: ``train.main`` for 1 epoch (``--workers 0 --fix_random_seed``, from
  a ``--pretrained_model``) writes the checkpoint, ``train_log.jsonl`` and
  the post-train ``result.pkl``; a second call with ``--epochs 2`` resumes
  from it. The JAX ``tools/test.py`` reads the checkpoint
  (``load_params_into_network``) and its ``eval_one_epoch`` gives the port's
  detections: boxes within 1e-4 and scores within 1e-5, as in
  ``tests/test_torch_port_cli.py``.
- Schedule: the port's OneCycle length is ``tools/train.py``'s, with and
  without ``--merge_all_iters_to_one_epoch``, and its lr that of the JAX
  schedule (rtol 1e-6: the same formula in f64 against f32).
"""

import importlib.util
import json
import logging
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from kitti_fixture import build_kitti_root
from test_torch_port_train_step import TrainPair, check_steps, train_cfg
from torch_port_helpers import REPO, Pair, mini_cfg

from hvpr_tpu.datasets import build_dataloader as jax_build_dataloader
from hvpr_tpu.optimization import build_optimizer as jax_build_optimizer
from tools.eval_utils import eval_utils as jax_eval_utils

from hvpr_tpu_torch import config as port_config
from hvpr_tpu_torch.datasets import build_dataloader
from hvpr_tpu_torch.datasets.kitti.kitti_dataset import KittiDataset, create_kitti_infos
from hvpr_tpu_torch.models import build_network, load_data_to_gpu
from hvpr_tpu_torch.optimization import one_cycle_schedules
from hvpr_tpu_torch.tools import eval_utils, train
from hvpr_tpu_torch.utils.checkpoint import (load_checkpoint, load_params_from_file,
                                             save_checkpoint)

CFG_FILE = 'tools/cfgs/kitti_models/hvpr_mini.yaml'


def logger():
    log = logging.getLogger('test_torch_port_train_cli')
    log.setLevel(logging.WARNING)
    return log


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    base = tmp_path_factory.mktemp('port_train_cli')
    root, _ = build_kitti_root(base / 'kitti', n_scenes=4)
    create_kitti_infos(root, root, workers=2)
    return base, root


def padded_batch(root, cfg):
    """The first train batch of the port's data layer (both scenes,
    augmented, host-voxelized), numpy's RNG seeded with 0."""
    ds = KittiDataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES, training=True, root_path=root)
    np.random.seed(0)
    batch = ds.collate_batch([ds[0], ds[1]])
    assert batch['voxels'].shape == (2, 256, 8, 4) and batch['voxel_mask'].any()
    return batch


def test_padded_train_step_matches_jax(tree):
    _, root = tree
    cfg = train_cfg()
    cfg.DATA_CONFIG.DATA_PATH = str(root)
    pair = TrainPair(cfg, host_batch=padded_batch(root, cfg))
    assert 'flat_points' not in pair.tbatch()
    check_steps(pair, 1)


def train_net(cfg, meta_ds, state):
    net = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), meta_ds, device='cpu', train=True)
    net.module.load_state_dict(state)
    net.init_training(cfg.OPTIMIZATION, 50)
    return net


@pytest.fixture(scope='module')
def port_step_setup(tree):
    """hvpr_mini as shipped (fused), its data layer's first train batch on
    the CPU, and seeded weights."""
    _, root = tree
    cfg = mini_cfg()
    cfg.DATA_CONFIG.DATA_PATH = str(root)
    host = padded_batch(root, cfg)
    ds = KittiDataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES, training=True, root_path=root)
    torch.manual_seed(0)
    net = build_network(cfg.MODEL, 1, ds, device='cpu', train=True)
    state = {k: v.clone() for k, v in net.module.state_dict().items()}
    batch = load_data_to_gpu({k: v for k, v in host.items() if isinstance(v, np.ndarray)},
                             'cpu')
    return cfg, ds, state, batch


def test_padded_step_equals_flat_step_in_the_port(port_step_setup):
    cfg, ds, state, batch = port_step_setup
    assert train_net(cfg, ds, state).module.map_to_bev_module.train_attend_mode == 'fused'
    padded = train_net(cfg, ds, state)
    flat = train_net(cfg, ds, state)
    flat_batch = dict(flat.voxelize(batch['points'], batch['point_valid_mask']),
                      gt_boxes=batch['gt_boxes'])
    assert int(flat_batch['voxel_mask'].sum()) == int(batch['voxel_mask'].sum())
    mp = {k: float(v) for k, v in padded.train_step(batch).items()}
    mf = {k: float(v) for k, v in flat.train_step(flat_batch).items()}
    assert mp.keys() == mf.keys() and mp['loss'] > 0
    for k in mp:
        np.testing.assert_allclose(mp[k], mf[k], rtol=1e-5, atol=1e-8, err_msg=k)
    stepped = dict(padded.module.named_parameters())['vfe.pfn_layers.0.linear.weight']
    assert not torch.equal(stepped, state['vfe.pfn_layers.0.linear.weight'])


def test_resume_round_trip_is_bit_exact(port_step_setup, tmp_path):
    cfg, ds, state, batch = port_step_setup
    net = train_net(cfg, ds, state)
    net.train_step(batch)
    ckpt = tmp_path / 'checkpoint_epoch_1.pth'
    save_checkpoint(net.module, ckpt, epoch=1, it=1, optimizer=net.train_state.optimizer)
    want = {k: float(v) for k, v in net.train_step(batch).items()}

    resumed = train_net(cfg, ds, state)
    epoch, it = load_checkpoint(resumed.module, ckpt, optimizer=resumed.train_state.optimizer)
    assert (epoch, it) == (1, 1)
    opt = resumed.train_state.optimizer
    assert opt.count == 1
    assert [g['lr'] for g in opt.adamw.param_groups] == \
        [opt.lr_fn(0)] * len(opt.adamw.param_groups)
    got = {k: float(v) for k, v in resumed.train_step(batch).items()}
    assert got == want
    assert opt.count == net.train_state.optimizer.count == 2
    want_state = net.module.state_dict()
    for k, v in resumed.module.state_dict().items():
        assert torch.equal(v, want_state[k]), k


def _jax_test_cli():
    """The JAX package's ``tools/test.py`` as a module (it imports its
    siblings from ``tools/``)."""
    tools = os.path.join(REPO, 'tools')
    sys.path.insert(0, tools)
    try:
        spec = importlib.util.spec_from_file_location('jax_tools_test',
                                                      os.path.join(tools, 'test.py'))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(tools)
    return mod


@pytest.fixture(scope='module')
def cli_runs(tree):
    """``train.main`` on the CPU: 1 epoch from a pretrained ``.pth`` (the
    seeded weights of ``torch_port_helpers.Pair``), then ``--epochs 2`` with
    the same tag, which resumes."""
    base, root = tree
    pair = Pair(mini_cfg(), batch=2, n_points=256)
    pretrained = base / 'pretrained.pth'
    save_checkpoint(pair.tnet.module, pretrained)
    saved_root = port_config.cfg.ROOT_DIR
    port_config.cfg.ROOT_DIR = base / 'out'
    try:
        common = ['--cfg_file', CFG_FILE, '--batch_size', '2', '--workers', '0',
                  '--fix_random_seed', '--num_epochs_to_eval', '1', '--device', 'cpu',
                  '--extra_tag', 'cli', '--set', 'DATA_CONFIG.DATA_PATH', str(root)]
        first = train.main(['--epochs', '1', '--pretrained_model', str(pretrained)] + common)
        assert not torch.are_deterministic_algorithms_enabled()
        second = train.main(['--epochs', '2'] + common)
    finally:
        port_config.cfg.ROOT_DIR = saved_root
    out = base / 'out' / 'output' / 'cfgs' / 'kitti_models' / 'hvpr_mini' / 'cli'
    return pair, root, out, first, second


def test_cli_trains_checkpoints_resumes_and_evaluates(cli_runs):
    _, _, out, first, second = cli_runs
    ckpts = sorted(p.name for p in (out / 'ckpt').glob('*.pth'))
    assert ckpts == ['checkpoint_epoch_1.pth', 'checkpoint_epoch_2.pth']
    for n in (1, 2):
        blob = torch.load(out / 'ckpt' / f'checkpoint_epoch_{n}.pth', weights_only=True)
        assert blob['epoch'] == n and blob['it'] == n
        assert blob['optimizer_state']['count'] == n
        assert any(k.startswith('backbone_3d.') for k in blob['model_state'])
    assert (first['start_epoch'], first['start_it'], first['end_it']) == (0, 0, 1)
    assert (second['start_epoch'], second['start_it'], second['end_it']) == (1, 1, 2)
    lr_fn, _ = one_cycle_schedules(0.003, 2)
    assert second['first_lr'] == lr_fn(1) and first['first_lr'] == lr_fn(0)
    assert first['train_time/steps'] == second['train_time/steps'] == 1

    lines = [json.loads(x) for x in (out / 'train_log.jsonl').read_text().splitlines()]
    assert [(x['epoch'], x['it']) for x in lines] == [(0, 1)]
    assert {'loss', 'lr', 'grad_norm', 'rpn_loss'} <= set(lines[0])
    assert lines[0]['lr'] == lr_fn(0) and np.isfinite(lines[0]['loss'])

    eval_dir = out / 'eval' / 'eval_with_train'
    for n in (1, 2):
        with open(eval_dir / f'epoch_{n}' / 'val' / 'result.pkl', 'rb') as f:
            assert len(pickle.load(f)) == 2
    assert (eval_dir / 'eval_list_val.txt').read_text().split() == ['1', '2']
    assert 'Car_3d/moderate' in first['eval'] and 'Car_3d/moderate' in second['eval']
    logs = ''.join(p.read_text() for p in out.glob('log_train_*.txt'))
    assert 'Resumed from' in logs and 'seeds: fixed' in logs


def test_cli_merge_all_iters_to_one_epoch(tree, tmp_path):
    """``--merge_all_iters_to_one_epoch``: one loader over both epochs (its
    iterator carried from one epoch into the next), OneCycle over the merged
    loader's length, a checkpoint an epoch, of which ``--max_ckpt_save_num
    1`` keeps the newest."""
    _, root = tree
    saved_root = port_config.cfg.ROOT_DIR
    port_config.cfg.ROOT_DIR = tmp_path
    try:
        ret = train.main(['--cfg_file', CFG_FILE, '--batch_size', '2', '--workers', '0',
                          '--epochs', '2', '--merge_all_iters_to_one_epoch',
                          '--num_epochs_to_eval', '0', '--max_ckpt_save_num', '1',
                          '--device', 'cpu',
                          '--set', 'DATA_CONFIG.DATA_PATH', str(root)])
    finally:
        port_config.cfg.ROOT_DIR = saved_root
    out = tmp_path / 'output' / 'cfgs' / 'kitti_models' / 'hvpr_mini' / 'default'
    assert [p.name for p in (out / 'ckpt').iterdir()] == ['checkpoint_epoch_2.pth']
    blob = torch.load(out / 'ckpt' / 'checkpoint_epoch_2.pth', weights_only=True)
    assert blob['it'] == 2 and blob['optimizer_state']['count'] == 2
    assert ret['end_it'] == 2 and ret['train_time/steps'] == 2
    logs = ''.join(p.read_text() for p in out.glob('log_train_*.txt'))
    assert 'OneCycle over 2 steps, 1 an epoch' in logs
    assert 'seeds: not fixed' in logs
    assert (out / 'eval' / 'eval_with_train' / 'eval_list_val.txt').read_text().split() == ['2']


def test_jax_test_cli_reads_the_checkpoint(cli_runs, tmp_path):
    """The JAX ``tools/test.py`` loads the CLI's ``checkpoint_epoch_1.pth``
    into a JAX eval network; the JAX and the port's ``eval_one_epoch`` give
    the same detections from the same host batches."""
    pair, root, out, _, _ = cli_runs
    ckpt = out / 'ckpt' / 'checkpoint_epoch_1.pth'
    cfg = pair.cfg
    cfg.DATA_CONFIG.DATA_PATH = str(root)
    jax_cli = _jax_test_cli()
    jnet = pair.jnet
    assert jax_cli.load_params_into_network(jnet, ckpt, logger()) == '1'
    _, jloader, _ = jax_build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size=2,
                                         root_path=root, workers=0, training=False)
    np.random.seed(0)
    jax_eval_utils.eval_one_epoch(cfg, jnet, jloader, 1, logger(), result_dir=tmp_path / 'jax')

    test_set, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 2,
                                           root_path=root, workers=0)
    net = build_network(cfg.MODEL, 1, test_set, device='cpu')
    epoch, report = load_params_from_file(net.module, ckpt)
    assert epoch == 1 and not report['mismatched'] and not report['not_updated']
    assert report['unused'] and all(k.startswith('backbone_3d.') for k in report['unused'])
    np.random.seed(0)
    eval_utils.eval_one_epoch(cfg, net, loader, epoch, logger(), result_dir=tmp_path / 'port')
    annos = {}
    for name in ('jax', 'port'):
        with open(tmp_path / name / 'result.pkl', 'rb') as f:
            annos[name] = pickle.load(f)
    want, got = annos['jax'], annos['port']
    assert len(got) == len(want) == 2
    assert sum(len(a['name']) for a in got) > 0
    for w, g in zip(want, got):
        assert g['frame_id'] == w['frame_id'] and len(g['name']) == len(w['name'])
        np.testing.assert_allclose(g['boxes_lidar'], w['boxes_lidar'], rtol=0, atol=1e-4)
        np.testing.assert_allclose(g['score'], w['score'], rtol=0, atol=1e-5)


@pytest.mark.parametrize('merge', [False, True])
def test_one_cycle_length_matches_the_jax_cli(tree, merge):
    _, root = tree
    cfg = mini_cfg()
    cfg.DATA_CONFIG.DATA_PATH = str(root)
    epochs = 3
    loaders = [build(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 1, root_path=root, workers=0,
                     training=True, merge_all_iters_to_one_epoch=merge, total_epochs=epochs)[1]
               for build in (jax_build_dataloader, build_dataloader)]
    n_jax, n_port = (len(x) for x in loaders)
    assert n_jax == n_port == (6 if merge else 2)
    # tools/train.py:122-131
    want = n_jax if merge else n_jax * epochs
    total, per_epoch = train.schedule_steps(n_port, epochs, merge)
    assert (total, per_epoch) == (want, 2)
    net = build_network(cfg.MODEL, 1, loaders[1].dataset, device='cpu', train=True)
    net.init_training(cfg.OPTIMIZATION, total)
    jax_params = {'w': np.zeros((2, 2), np.float32)}
    _, jax_lr = jax_build_optimizer(jax_params, cfg.OPTIMIZATION, total_steps=want,
                                    total_iters_each_epoch=per_epoch)
    lr_fn = net.train_state.optimizer.lr_fn
    for step in range(want + 1):
        np.testing.assert_allclose(lr_fn(step), float(jax_lr(step)), rtol=1e-6)
