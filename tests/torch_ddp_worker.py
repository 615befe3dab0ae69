"""One rank of the port's data-parallel CPU checks (tests/test_torch_port_ddp.py).

Started by ``torch.multiprocessing`` (spawn), one process a rank, joined
by gloo through a ``file://`` store. It imports torch, numpy and the port
only, never JAX or the JAX package. :func:`run` takes a payload written
by the test (``torch.save``), {task: its input}, runs the tasks in turn
and writes {task: what it gave} to ``<out>/rank<r>.pt``:

- ``merge``: ``merge_results_dist`` twice, with parts of 3 strings a rank;
- ``step``: hvpr_mini.yaml's train network (the test's config overrides),
  the test's weights loaded on rank 0 only (rank 1 keeps its own
  initialization, so the broadcast must give it rank 0's), this rank's
  batch of the test's: the averaged gradients of one forward, then from
  the same state one ``train_step`` (metrics, state_dict, AdamW state);
- ``test_cli``: ``tools.test.main`` with ``--launcher pytorch`` (the group
  exists already) and the test's arguments; its return value;
- ``train_cli``: ``tools.train.main`` likewise; its return value and this
  rank's weights, BN statistics and AdamW state when training ends.
"""

import os

import torch
import torch.distributed as dist


def _port_cfg(overrides):
    """hvpr_mini.yaml with {dotted key: value} set."""
    from hvpr_tpu_torch.config import ConfigDict, cfg_from_yaml_file
    cfg = ConfigDict()
    cfg_from_yaml_file('tools/cfgs/kitti_models/hvpr_mini.yaml', cfg)
    for key, value in overrides.items():
        *path, last = key.split('.')
        node = cfg
        for name in path:
            node = node[name]
        node[last] = value
    return cfg


def _step(rank, world, payload):
    from hvpr_tpu_torch.models import DatasetMeta, build_network
    from hvpr_tpu_torch.parallel import average_over_ranks, broadcast_state, loss_and_grads

    cfg = _port_cfg(payload['cfg'])
    meta = DatasetMeta(cfg.DATA_CONFIG, cfg.CLASS_NAMES, mode='train')
    torch.manual_seed(100 + rank)
    net = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), meta, device='cpu', train=True)
    batch = {k: torch.from_numpy(v) for k, v in payload['batches'][rank].items()}

    def fresh():
        if rank == 0:
            net.load_state_dict(payload['state_dict'])
        broadcast_state(net.module)
        net.init_training(cfg.OPTIMIZATION, payload['total_steps'])

    fresh()
    _, grads = loss_and_grads(net.train_state, batch)
    grads = average_over_ranks(grads)
    fresh()
    metrics = net.train_step(batch)
    return {'grads': [g.clone() for g in grads],
            'metrics': {k: float(v) for k, v in metrics.items()},
            'state': {k: v.clone() for k, v in net.module.state_dict().items()},
            'adamw': net.train_state.optimizer.state_dict(),
            'pillars': int(batch['voxel_mask'].sum())}


def _train_cli(argv):
    from hvpr_tpu_torch.tools import train, train_utils

    captured = {}
    train_model = train_utils.train_model

    def keep_state(net, *args, **kwargs):
        out = train_model(net, *args, **kwargs)
        captured['state'] = {k: v.clone() for k, v in net.module.state_dict().items()}
        captured['adamw'] = net.train_state.optimizer.state_dict()
        return out

    train.train_model = keep_state
    try:
        ret = train.main(argv)
    finally:
        train.train_model = train_model
    return dict(captured, ret=ret)


def run(rank, world, init_file, payload_path, out_dir):
    os.chdir(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    torch.set_num_threads(1)
    dist.init_process_group('gloo', init_method=f'file://{init_file}', rank=rank,
                            world_size=world)
    try:
        from hvpr_tpu_torch import config
        from hvpr_tpu_torch.datasets import stop_worker_server
        from hvpr_tpu_torch.tools import test
        from hvpr_tpu_torch.utils.common_utils import merge_results_dist

        out = {}
        for task, payload in torch.load(payload_path, weights_only=False).items():
            if task == 'merge':
                out[task] = [merge_results_dist(
                    [f'r{i}_rank{rank}_item{j}' for j in range(3)], size=3 * world - 1)
                    for i in range(2)]
            elif task == 'step':
                out[task] = _step(rank, world, payload)
            else:
                config.cfg.ROOT_DIR = payload['root_dir']
                out[task] = test.main(payload['argv']) if task == 'test_cli' \
                    else _train_cli(payload['argv'])
        stop_worker_server()
        torch.save(out, os.path.join(out_dir, f'rank{rank}.pt'))
        dist.barrier()
    finally:
        dist.destroy_process_group()
