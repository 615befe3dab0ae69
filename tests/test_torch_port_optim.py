"""The port's ``adam`` and ``sgd`` optimizers against the JAX package's optax
chains, on the CPU.

- ``decay_step_schedule`` against the JAX ``lr_fn`` at every step of
  schedules with a cosine warmup and two decays, and one whose decays
  reach LR_CLIP: rtol 1e-6 (the same formula in f64 against f32).
- 6 steps of ``adam`` and of ``sgd`` (MOMENTUM 0.9) with the global-norm
  clip (active on some steps) and coupled weight decay over a small
  module's parameters, from the same weights and the same gradients (a
  seeded draw plus a pull towards the current weights), against
  ``hvpr_tpu.optimization.build_optimizer``'s chain: each step's global
  norm rtol 1e-6, the weights after 6 steps within 1e-6 relative plus
  1e-3 of the lr (f32, the same updates summed in another order).
- ``state_dict`` resume: 3 steps, a ``.pth`` round trip, 3 more steps equal
  6 uninterrupted steps bit for bit (weights, moments, count).
- The train CLI with ``OPTIMIZER: adam`` and a decay milestone on
  hvpr_mini.yaml (batch 2, 1 step an epoch): the epoch milestones are
  counted in its iterations an epoch, the log names the schedule, and a
  run resumed from ``checkpoint_epoch_1.pth`` writes the uninterrupted
  run's ``checkpoint_epoch_2.pth`` bit for bit (``--fix_random_seed``
  seeds each epoch from its index).
"""

import io

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from kitti_fixture import build_kitti_root
from torch_port_helpers import torch_threads

from hvpr_tpu.optimization import build_optimizer as jax_build_optimizer
from hvpr_tpu.optimization import decay_step_schedule as jax_decay_step_schedule

from hvpr_tpu_torch import config as port_config
from hvpr_tpu_torch.datasets.kitti.kitti_dataset import create_kitti_infos
from hvpr_tpu_torch.optimization import (AdamOneCycle, StepDecayOptimizer, build_optimizer,
                                         decay_step_schedule)
from hvpr_tpu_torch.tools import train


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    with torch_threads(1):
        yield


SCHEDULES = {
    'warmup_two_decays': dict(lr=0.003, decay_step_list=[2, 4], lr_decay=0.1, lr_clip=1e-7,
                              total_iters_each_epoch=3, warmup_epoch=1, warmup=True,
                              div_factor=10.0),
    'clipped': dict(lr=0.01, decay_step_list=[1, 2, 3], lr_decay=0.01, lr_clip=1e-6,
                    total_iters_each_epoch=2, warmup_epoch=0, warmup=False),
    'warmup_over_decay': dict(lr=0.002, decay_step_list=[1], lr_decay=0.5, lr_clip=1e-7,
                              total_iters_each_epoch=4, warmup_epoch=2, warmup=True,
                              div_factor=4.0),
}


@pytest.mark.parametrize('case', list(SCHEDULES))
def test_decay_step_schedule_matches_jax(case):
    kw = SCHEDULES[case]
    want_fn, got_fn = jax_decay_step_schedule(**kw), decay_step_schedule(**kw)
    values = [got_fn(step) for step in range(20)]
    np.testing.assert_allclose(values, [float(want_fn(jnp.asarray(step)))
                                        for step in range(20)], rtol=1e-6)
    if case == 'warmup_two_decays':
        assert values[0] == pytest.approx(0.0003) and values[3] == pytest.approx(0.003)
        assert values[6] == pytest.approx(3e-4) and values[12] == pytest.approx(3e-5)
    if case == 'clipped':
        assert values[-1] == 1e-6


class Small(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 8, 3)
        self.bn = nn.BatchNorm2d(8)
        self.fc = nn.Linear(8, 5)


def optim_cfg(name, **kw):
    cfg = {'OPTIMIZER': name, 'LR': 0.01, 'WEIGHT_DECAY': 0.01, 'MOMENTUM': 0.9,
           'DECAY_STEP_LIST': [1, 2], 'LR_DECAY': 0.1, 'LR_CLIP': 1e-7, 'LR_WARMUP': True,
           'WARMUP_EPOCH': 1, 'DIV_FACTOR': 10, 'GRAD_NORM_CLIP': 8.0}
    cfg.update(kw)
    return cfg


def seeded_module(seed=0):
    torch.manual_seed(seed)
    mod = Small()
    with torch.no_grad():
        for p in mod.parameters():
            p.add_(0.1 * torch.randn(p.shape))
    return mod


def grads_of(step, params):
    """Step ``step``'s gradients: a seeded draw (growing with the step, so
    that the clip acts on some steps) plus 0.5 of the current weights."""
    rng = np.random.default_rng(100 + step)
    scale = 0.2 * (1 + step)
    return [(scale * rng.normal(size=p.shape) + 0.5 * p).astype(np.float32)
            for p in params]


def run_port(mod, opt, steps, start=0):
    norms = []
    for step in range(start, start + steps):
        params = [p.detach().numpy() for p in opt.params]
        norms.append(float(opt.step([torch.from_numpy(g) for g in grads_of(step, params)])))
    return norms


@pytest.mark.parametrize('name', ['adam', 'sgd'])
def test_six_steps_match_the_optax_chain(name):
    cfg = optim_cfg(name)
    mod = seeded_module()
    names = [n for n, _ in mod.named_parameters()]
    params = {n: jnp.asarray(p.detach().numpy()) for n, p in mod.named_parameters()}
    tx, lr_fn = jax_build_optimizer(params, cfg, total_steps=6, total_iters_each_epoch=2)
    state = tx.init(params)
    want_norms = []
    for step in range(6):
        grads = dict(zip(names, map(jnp.asarray, grads_of(
            step, [np.asarray(params[n]) for n in names]))))
        want_norms.append(float(optax.global_norm(grads)))
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)

    opt = build_optimizer(mod, cfg, total_steps=6, total_iters_each_epoch=2)
    assert isinstance(opt, StepDecayOptimizer)
    assert opt.schedule_name == f'{name} with step decay'
    assert [opt.lr_fn(s) for s in range(6)] == pytest.approx(
        [float(lr_fn(s)) for s in range(6)], rel=1e-6)
    norms = run_port(mod, opt, 6)
    np.testing.assert_allclose(norms, want_norms, rtol=1e-6)
    assert max(norms) > cfg['GRAD_NORM_CLIP'] > min(norms)
    lr0 = opt.lr_fn(0)
    for n, p in mod.named_parameters():
        got, want = p.detach().numpy(), np.asarray(params[n])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-3 * lr0, err_msg=n)
        assert not np.allclose(got, seeded_module().state_dict()[n].numpy())
    assert opt.count == 6
    kind = torch.optim.Adam if name == 'adam' else torch.optim.SGD
    assert isinstance(opt.optim, kind)
    assert opt.optim.param_groups[0]['weight_decay'] == 0.01


@pytest.mark.parametrize('name', ['adam', 'sgd', 'adam_onecycle'])
def test_state_dict_resume_is_bit_exact(name):
    cfg = optim_cfg(name, MOMS=[0.95, 0.85], PCT_START=0.4)
    mod = seeded_module()
    opt = build_optimizer(mod, cfg, total_steps=6, total_iters_each_epoch=2)
    run_port(mod, opt, 3)
    buf = io.BytesIO()
    torch.save({'model': mod.state_dict(), 'opt': opt.state_dict()}, buf)
    run_port(mod, opt, 3, start=3)

    buf.seek(0)
    blob = torch.load(buf, weights_only=True)
    resumed = seeded_module(seed=1)
    resumed.load_state_dict(blob['model'])
    opt2 = build_optimizer(resumed, cfg, total_steps=6, total_iters_each_epoch=2)
    opt2.load_state_dict(blob['opt'])
    assert opt2.count == 3
    run_port(resumed, opt2, 3, start=3)
    for (n, a), b in zip(mod.state_dict().items(), resumed.state_dict().values()):
        assert torch.equal(a, b), n
    s1, s2 = opt.state_dict(), opt2.state_dict()
    assert s1['count'] == s2['count'] == 6
    key = 'adamw' if name == 'adam_onecycle' else 'optim'
    for i, st in s1[key]['state'].items():
        for k, v in st.items():
            assert torch.equal(v, s2[key]['state'][i][k]), (i, k)


def test_build_optimizer_dispatch():
    mod = seeded_module()
    assert isinstance(build_optimizer(mod, optim_cfg('adam_onecycle'), 10), AdamOneCycle)
    assert build_optimizer(mod, optim_cfg('adam_onecycle'), 10).schedule_name == 'OneCycle'
    # without the iterations an epoch the milestones count in steps
    assert build_optimizer(mod, optim_cfg('sgd', LR_WARMUP=False)).lr_fn(1) == \
        pytest.approx(0.001)
    with pytest.raises(NotImplementedError):
        build_optimizer(mod, optim_cfg('rmsprop'))


def test_train_cli_adam_resume_gives_the_same_checkpoint(tmp_path):
    root, _ = build_kitti_root(tmp_path / 'kitti', n_scenes=4)
    create_kitti_infos(root, root, workers=2)
    saved_root = port_config.cfg.ROOT_DIR
    port_config.cfg.ROOT_DIR = tmp_path / 'out'
    common = ['--cfg_file', 'tools/cfgs/kitti_models/hvpr_mini.yaml', '--batch_size', '2',
              '--workers', '0', '--fix_random_seed', '--num_epochs_to_eval', '0',
              '--device', 'cpu', '--epochs', '2',
              '--set', 'DATA_CONFIG.DATA_PATH', str(root), 'OPTIMIZATION.OPTIMIZER', 'adam',
              'OPTIMIZATION.DECAY_STEP_LIST', '[1]', 'OPTIMIZATION.LR_WARMUP', 'True']
    out = tmp_path / 'out' / 'output' / 'cfgs' / 'kitti_models' / 'hvpr_mini'
    try:
        whole = train.main(['--extra_tag', 'whole'] + common)
        (out / 'resumed' / 'ckpt').mkdir(parents=True)
        (out / 'resumed' / 'ckpt' / 'checkpoint_epoch_1.pth').write_bytes(
            (out / 'whole' / 'ckpt' / 'checkpoint_epoch_1.pth').read_bytes())
        resumed = train.main(['--extra_tag', 'resumed'] + common)
    finally:
        port_config.cfg.ROOT_DIR = saved_root
    assert (whole['start_epoch'], resumed['start_epoch'], resumed['start_it']) == (0, 1, 1)
    # LR_WARMUP over WARMUP_EPOCH 1 (1 step), then the decay at epoch 1
    assert whole['first_lr'] == pytest.approx(0.0003)
    assert resumed['first_lr'] == pytest.approx(0.0003)
    logs = ''.join(p.read_text() for p in (out / 'whole').glob('log_train_*.txt'))
    assert 'adam with step decay over 2 steps, 1 an epoch' in logs
    blobs = [torch.load(out / tag / 'ckpt' / 'checkpoint_epoch_2.pth', weights_only=True)
             for tag in ('whole', 'resumed')]
    assert blobs[0]['optimizer_state']['count'] == blobs[1]['optimizer_state']['count'] == 2
    assert blobs[0]['model_state'].keys() == blobs[1]['model_state'].keys()
    for k, v in blobs[0]['model_state'].items():
        assert torch.equal(v, blobs[1]['model_state'][k]), k
    for i, st in blobs[0]['optimizer_state']['optim']['state'].items():
        for k, v in st.items():
            assert torch.equal(v, blobs[1]['optimizer_state']['optim']['state'][i][k]), (i, k)
