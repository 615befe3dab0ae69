"""The system under test: the port's network, built and fed through its
public entry points (``build_network``, ``Network.load_state_dict``,
``Network.pipeline``, the detector's ``stages()``).

The benchmark makes the weights (:func:`weight_seeds`) and loads them by
name, one network a draw; it hangs two kinds of hooks on the detector's
stages: one that keeps the dense head's outputs of the scans the check
will compare (references only, no copy), and, in a traced run, CUDA
events before and after each stage (no synchronize). The spans between events are the layers' device
times: voxelize from the call to the first stage, post-processing from
the last stage to the detections' copy to the host.
"""

import time

import torch

from reference.weights import make_weights


class StageEvents:
    """CUDA events at the stage boundaries of every request of a window, and
    the host's clock (``time.time_ns``, the trace's) at each."""

    def __init__(self):
        self.requests = []          # [[(label, event), ...]]
        self.host_marks = []        # [(ns, label)]

    def mark(self, label):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.requests[-1].append((label, ev))
        self.host_marks.append((time.time_ns(), label))

    def begin(self):
        self.requests.append([])
        self.mark('begin')

    def spans_ms(self):
        """{span: [ms a request]}: each stage, 'voxelize' (begin to the first
        stage) and 'post' (the last stage to the end)."""
        torch.cuda.synchronize()
        out = {}
        for marks in self.requests:
            at = dict(marks)
            labels = [lb for lb, _ in marks]
            stages = [lb[:-6] for lb in labels if lb.endswith(':start')]
            if 'end' not in at or not stages:
                continue
            for s in stages:
                out.setdefault(s, []).append(at[f'{s}:start'].elapsed_time(at[f'{s}:end']))
            first, last = at[f'{stages[0]}:start'], at[f'{stages[-1]}:end']
            out.setdefault('voxelize', []).append(at['begin'].elapsed_time(first))
            out.setdefault('post', []).append(last.elapsed_time(at['end']))
        return out


def weight_seeds(scheme, seed):
    """The generator seeds of a run's weight draws: the run's own seed, or,
    where the weight scheme gives ``"draws": K``, the seeds 0 to K - 1, the
    same set for every run."""
    draws = scheme.get('draws')
    return [int(seed)] if draws is None else list(range(int(draws)))


class Program:
    """The port's network for one cell, with seeded weights: one network a
    weight draw (:func:`weight_seeds`); a request of pool batch ``i`` is
    answered by draw ``i`` mod the number of draws."""

    def __init__(self, cell, seed, device):
        from hvpr_tpu_torch.config import ConfigDict
        from hvpr_tpu_torch.models import DatasetMeta, build_network

        cfg = cell.config
        self.cfg = cfg
        self.device = torch.device(device)
        meta = DatasetMeta(ConfigDict(cfg['DATA_CONFIG']), cfg['CLASS_NAMES'], mode='test')
        scheme = cfg['weights']
        self.nets = []
        self.weights = []   # the reference's copies, off the device until the window has closed
        for draw in weight_seeds(scheme, seed):
            net = build_network(ConfigDict(cfg['MODEL']), len(cfg['CLASS_NAMES']), meta,
                                device=self.device, train=False)
            state = net.module.state_dict()
            shapes = {k: tuple(v.shape) for k, v in state.items() if v.is_floating_point()}
            weights = make_weights(shapes, draw, self.device,
                                   cls_bias=scheme.get('cls_bias', 0),
                                   box_std=scheme.get('box_std'), cls_std=scheme.get('cls_std'))
            state.update(weights)
            net.load_state_dict(state)
            self.nets.append(net)
            self.weights.append({k: v.cpu() for k, v in weights.items()})
            del weights, state
        self.events = None
        self.capture_key = None
        self.captured = {}
        self.hooks = []
        for net in self.nets:
            module = net.module
            names = {id(m): n for n, m in module.named_children()}
            for stage in module.stages():
                name = names[id(stage)]
                self.hooks.append(stage.register_forward_pre_hook(self._pre(name)))
                self.hooks.append(stage.register_forward_hook(self._post(name)))
            self.hooks.append(module.dense_head.register_forward_hook(self._keep_head))

    def _pre(self, name):
        def hook(_module, _args):
            if self.events is not None:
                self.events.mark(f'{name}:start')
        return hook

    def _post(self, name):
        def hook(_module, _args, _out):
            if self.events is not None:
                self.events.mark(f'{name}:end')
        return hook

    def _keep_head(self, _module, _args, out):
        if self.capture_key is not None:
            self.captured[self.capture_key] = (out['batch_cls_preds'], out['batch_box_preds'])

    def net_of(self, key):
        """The network that answers pool batch ``key`` (None: the first)."""
        return self.nets[(key or 0) % len(self.nets)]

    def detect(self, points, mask, key=None):
        """One request: the pipeline on device tensors, the detections
        copied to the host. ``key``, the request's pool batch, picks the
        weight draw and names the request whose head outputs the check
        keeps."""
        self.capture_key = key
        if self.events is not None:
            self.events.begin()
        out = self.net_of(key).pipeline(points, mask)
        if self.events is not None:
            self.events.mark('end')
        return {k: out[k].cpu() for k in ('pred_boxes', 'pred_scores', 'pred_labels',
                                          'pred_mask')}

    def close(self):
        for h in self.hooks:
            h.remove()
        self.hooks = []
        self.nets = []
        self.captured = {}
