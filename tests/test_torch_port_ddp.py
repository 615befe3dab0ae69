"""The port's data-parallel training and evaluation over two processes
(gloo, on the CPU) against the JAX package's single-device step and the
port's one process.

Two ranks are spawned once for the module (``tests/torch_ddp_worker.py``,
which imports only the port); the JAX reference and the one-process runs
are made here. hvpr_mini.yaml as ``tests/test_torch_port_train_step.py``
sets it up (TRAIN_ATTEND_MODE gather, BALL_QUERY bucket, FPS_CHUNKS 4),
from the same flax-initialized weights, 4 seeded scans: ranks 0 and 1 take
2 each, with different valid-pillar counts, so that the memory loss's
global pillar count and the BatchNorms' global statistics are exercised.

Tolerances and why:
- against the JAX step on the 4 scans: that file's one-step tolerances
  (loss terms and grad norm rtol 1e-4; 99% of the updated parameters within
  1e-6 relative; running statistics rtol 1e-4, atol 1e-5 of the largest);
- against the port's one-process step on the 4 scans, the same arithmetic
  with each BatchNorm sum and the gradients summed in two parts. The
  memory reconstruction rounds its products to bf16, so an f32-ulp
  difference there flips a rounding (2^-8 of one term) that the memory
  branch carries into the BEV backbone and the heads: gradients leaf by
  leaf within 1e-3 of the leaf in L2 and max magnitude (measured: the
  memory 8.0e-5 and 1.8e-4, the BEV backbone up to 3.7e-5 and 1.3e-4, the
  VFE, the point stream and the heads below 2.4e-6), plus 1e-7 of the
  global norm for leaves whose gradient is a sum that cancels;
  loss terms and grad norm rtol 1e-5, running statistics rtol 1e-5, and
  99% of the updated parameters within 1e-6 relative (as above: Adam's
  first step moves a weight by about lr whatever its gradient, so a
  weight with a noise-level gradient may step the other way);
- between the ranks: bit for bit (parameters, BN statistics, AdamW state);
- the test CLI over two ranks against one process on the fixture tree's
  val scenes: boxes within 1e-4 and scores within 1e-5 (the batches hold
  other scenes, so the products differ in rounding only), the same names
  and the same official result string.
"""

import copy
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from hvpr_tpu.datasets import _StridedEvalSampler as JaxStridedEvalSampler
from hvpr_tpu.ops.voxelizer import voxelize_batch_flat as jax_voxelize

import torch_ddp_worker
from kitti_fixture import build_kitti_root
from test_torch_port_train_step import TOTAL_STEPS, TrainPair, assert_close, run_steps, train_cfg

from hvpr_tpu_torch import config as port_config
from hvpr_tpu_torch.datasets import StridedEvalSampler
from hvpr_tpu_torch.datasets.kitti.kitti_dataset import create_kitti_infos
from hvpr_tpu_torch.parallel import loss_and_grads
from hvpr_tpu_torch.tools import test as test_cli
from hvpr_tpu_torch.utils.checkpoint import save_checkpoint

WORLD = 2
CFG_FILE = 'tools/cfgs/kitti_models/hvpr_mini.yaml'
OVERRIDES = {'MODEL.MAP_TO_BEV.TRAIN_ATTEND_MODE': 'gather',
             'MODEL.BACKBONE_3D.SA_CONFIG.BALL_QUERY': 'bucket',
             'MODEL.BACKBONE_3D.SA_CONFIG.FPS_CHUNKS': 4}


@pytest.fixture(scope='module')
def pair():
    return TrainPair(train_cfg(), batch=4)


def rank_batches(pair):
    """The 4 scans as 2 batches of 2, voxelized as the pair's batch is."""
    m = pair.meta
    out = []
    for r in range(WORLD):
        s = slice(2 * r, 2 * r + 2)
        pts, mask = jnp.asarray(pair.points[s]), jnp.asarray(pair.mask[s])
        vox = jax_voxelize(pts, mask, tuple(float(v) for v in m.point_cloud_range),
                           tuple(float(v) for v in m.voxel_size), max_voxels=m.max_voxels,
                           max_points_per_voxel=m.max_points_per_voxel,
                           grid_size_static=tuple(int(g) for g in m.grid_size))
        out.append({'points': pair.points[s], 'point_valid_mask': pair.mask[s],
                    'gt_boxes': pair.gt[s], **{k: np.asarray(v) for k, v in vox.items()}})
    return out


def cli_argv(root, ckpt=None, train=False):
    argv = ['--cfg_file', CFG_FILE, '--batch_size', '2', '--workers', '0', '--device', 'cpu']
    if train:
        argv += ['--epochs', '1', '--fix_random_seed', '--num_epochs_to_eval', '1']
    else:
        argv += ['--ckpt', str(ckpt)]
    return argv + ['--set', 'DATA_CONFIG.DATA_PATH', str(root)]


@pytest.fixture(scope='module')
def runs(pair, tmp_path_factory):
    """Both ranks' results of every task (``torch_ddp_worker``), one spawn."""
    tmp = tmp_path_factory.mktemp('ddp')
    root, _ = build_kitti_root(tmp / 'kitti', n_scenes=4)
    create_kitti_infos(root, root, workers=2)
    ckpt = tmp / 'ckpt' / 'checkpoint_epoch_3.pth'
    ckpt.parent.mkdir()
    pair.reset()
    with torch.no_grad():       # scores of 0.5 before NMS: detections to compare
        pair.tnet.module.dense_head.conv_cls.bias.zero_()
    save_checkpoint(pair.tnet.module, ckpt, epoch=3)
    pair.reset()
    launch = ['--launcher', 'pytorch']
    payload = {
        'merge': None,
        'step': {'cfg': OVERRIDES, 'state_dict': pair.state_dict,
                 'batches': rank_batches(pair), 'total_steps': TOTAL_STEPS},
        'test_cli': {'root_dir': tmp / 'ddp_test', 'argv': launch + cli_argv(root, ckpt)},
        'train_cli': {'root_dir': tmp / 'ddp_train',
                      'argv': launch + cli_argv(root, train=True)},
    }
    torch.save(payload, tmp / 'payload.pt')
    mp.start_processes(torch_ddp_worker.run,
                       args=(WORLD, str(tmp / 'store'), str(tmp / 'payload.pt'), str(tmp)),
                       nprocs=WORLD, start_method='spawn')
    outs = [torch.load(tmp / f'rank{r}.pt', weights_only=False) for r in range(WORLD)]
    return {'tmp': tmp, 'root': root, 'ckpt': ckpt, 'outs': outs}


def assert_states_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def assert_adamw_equal(a, b):
    assert a['count'] == b['count']
    sa, sb = a['adamw']['state'], b['adamw']['state']
    assert sa.keys() == sb.keys() and sa
    for i in sa:
        for k in sa[i]:
            assert torch.equal(torch.as_tensor(sa[i][k]), torch.as_tensor(sb[i][k])), (i, k)


def params_agree(got, want, frac=0.99):
    """``frac`` of the parameters of ``want`` within 1e-6 relative (+1e-7)
    of ``got``'s; running statistics rtol 1e-4, atol 1e-5 of the largest."""
    agree = total = 0
    for k, w in want.items():
        if 'num_batches' in k:
            continue
        g, w = got[k].numpy(), w.numpy()
        if 'running' in k:
            assert_close(g, w, 1e-4, 1e-5, k)
            continue
        agree += int(np.sum(np.abs(g - w) <= 1e-7 + 1e-6 * np.abs(w)))
        total += w.size
    assert agree >= frac * total, (agree, total)


def test_two_ranks_step_matches_the_jax_single_device_step(pair, runs):
    """One step of 2 ranks x 2 scans against ``make_train_step`` (no mesh)
    on the 4 scans, from the same weights; rank 1 started from its own
    initialization and took rank 0's by the broadcast."""
    steps = [out['step'] for out in runs['outs']]
    assert steps[0]['pillars'] != steps[1]['pillars']
    jm, _, want, _ = run_steps(pair, 1)
    got = steps[0]['metrics']
    assert set(got) == set(jm[0])
    for k, v in jm[0].items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-7, err_msg=k)
    assert got['mem_loss'] > 0
    params_agree(steps[0]['state'], want)


def test_two_ranks_step_matches_one_process(pair, runs):
    """The same step against the port's one process on the 4 scans: the
    averaged gradients leaf by leaf, the metrics and the update."""
    step = runs['outs'][0]['step']
    pair.reset()
    pair.tnet.init_training(pair.cfg.OPTIMIZATION, TOTAL_STEPS)
    _, grads = loss_and_grads(pair.tnet.train_state, pair.tbatch())
    atol = 1e-7 * float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads)))
    names = [n for n, _ in pair.tnet.module.named_parameters()]
    for name, g, w in zip(names, step['grads'], grads):
        diff = (g - w).double()
        assert float(diff.norm()) <= 1e-3 * float(w.double().norm()) + atol, name
        assert float(diff.abs().max()) <= 1e-3 * float(w.abs().max()) + atol, name
    pair.reset()
    pair.tnet.init_training(pair.cfg.OPTIMIZATION, TOTAL_STEPS)
    one = {k: float(v) for k, v in pair.tnet.train_step(pair.tbatch()).items()}
    for k, v in one.items():
        np.testing.assert_allclose(step['metrics'][k], v, rtol=1e-5, atol=1e-7, err_msg=k)
    state = pair.tnet.module.state_dict()
    for k in state:
        if 'running' in k:
            assert_close(step['state'][k], state[k], 1e-5, 1e-6, k)
    params_agree(step['state'], state)


@pytest.mark.parametrize('task', ['step', 'train_cli'])
def test_ranks_end_bit_equal(runs, task):
    """Parameters, BN statistics and AdamW state, bit for bit, after the
    step and after the train CLI."""
    a, b = (out[task] for out in runs['outs'])
    assert_states_equal(a['state'], b['state'])
    assert_adamw_equal(a['adamw'], b['adamw'])
    if task == 'step':
        assert a['metrics'] == b['metrics']


@pytest.mark.parametrize('world', [2, 3])
def test_samplers_give_the_jax_index_sets(world):
    """On 11 items: the strided eval sampler pads with the first items to a
    multiple of the world size and takes every world-th (as
    tests/multihost_worker.py checks the JAX one); the train sampler is
    torch's DistributedSampler in both packages: each epoch's shares cover
    every item and agree between them."""
    items = list(range(11))
    n = -(-11 // world)
    for rank in range(world):
        port = list(StridedEvalSampler(items, world, rank))
        assert port == list(JaxStridedEvalSampler(items, world, rank))
        assert port == (items + items)[:n * world][rank::world] and len(port) == n
    for epoch in (0, 1):
        shares = []
        for rank in range(world):
            s = torch.utils.data.distributed.DistributedSampler(items, world, rank)
            s.set_epoch(epoch)
            shares.append(list(s))
        assert sorted(set(i for share in shares for i in share)) == items
        assert all(len(share) == n for share in shares)


def test_merge_results_dist(runs):
    """Rank 0 gets the parts interleaved in the strided sampler's order and
    truncated to ``size``, in two calls; the other rank None."""
    got0, got1 = (out['merge'] for out in runs['outs'])
    for i in range(2):
        want = [f'r{i}_rank{r}_item{j}' for j in range(3) for r in range(WORLD)]
        assert got0[i] == want[:3 * WORLD - 1]
        assert got1[i] is None


def _annos(root_dir):
    found = sorted(root_dir.glob('output/**/result.pkl'))
    assert len(found) == 1, found
    with open(found[0], 'rb') as f:
        return pickle.load(f)


def test_test_cli_over_two_ranks_gives_the_one_process_annos(runs, monkeypatch):
    """``tools.test.main --launcher pytorch``: rank 0 returns the result
    dict, rank 1 {}; the merged annos and the result string equal one
    process's."""
    tmp, root = runs['tmp'], runs['root']
    monkeypatch.setattr(port_config.cfg, 'ROOT_DIR', tmp / 'one_test')
    one = test_cli.main(cli_argv(root, runs['ckpt']))
    ret0, ret1 = (out['test_cli'] for out in runs['outs'])
    assert ret1 == {} and 'Car_3d/moderate' in ret0
    want, got = _annos(tmp / 'one_test'), _annos(tmp / 'ddp_test')
    assert len(got) == len(want) == 2 and sum(len(a['name']) for a in got) > 0
    for w, g in zip(want, got):
        assert g['frame_id'] == w['frame_id']
        np.testing.assert_array_equal(g['name'], w['name'])
        np.testing.assert_allclose(g['boxes_lidar'], w['boxes_lidar'], rtol=0, atol=1e-4)
        np.testing.assert_allclose(g['score'], w['score'], rtol=0, atol=1e-5)
    from hvpr_tpu_torch.datasets.kitti.kitti_object_eval_python.eval import (
        get_official_eval_result)
    infos = pickle.loads((root / 'kitti_infos_val.pkl').read_bytes())
    strings = [get_official_eval_result([copy.deepcopy(i['annos']) for i in infos],
                                        copy.deepcopy(annos), ['Car'])[0]
               for annos in (want, got)]
    assert strings[0] == strings[1]
    assert {k: v for k, v in ret0.items() if not k.startswith('eval_time/')} == \
        {k: v for k, v in one.items() if not k.startswith('eval_time/')}


def test_train_cli_over_two_ranks(runs):
    """``tools.train.main --launcher pytorch``, global batch 2 (1 a rank), 1
    epoch: rank 0 writes the one checkpoint and the log; the post-train
    evaluation over both ranks reads each val scene once."""
    tmp = runs['tmp']
    ret0, ret1 = (out['train_cli']['ret'] for out in runs['outs'])
    assert ret0['end_it'] == ret1['end_it'] == 1
    assert 'Car_3d/moderate' in ret0['eval'] and ret1['eval'] == {}
    ckpts = sorted(p.name for p in (tmp / 'ddp_train').glob('output/**/ckpt/*.pth'))
    assert ckpts == ['checkpoint_epoch_1.pth']
    assert len(list((tmp / 'ddp_train').glob('output/**/log_train_*.txt'))) == 1
    annos = _annos(tmp / 'ddp_train')
    infos = pickle.loads((runs['root'] / 'kitti_infos_val.pkl').read_bytes())
    assert [a['frame_id'] for a in annos] == [i['point_cloud']['lidar_idx'] for i in infos]
    blob = torch.load(next((tmp / 'ddp_train').glob('output/**/checkpoint_epoch_1.pth')),
                      weights_only=True)
    assert_states_equal(blob['model_state'], runs['outs'][1]['train_cli']['state'])
