"""The port's spans and counters (``hvpr_tpu_torch/utils/profiler.py``) on
hvpr_mini.yaml on the CPU.

The recorder is on only under a ``torch.profiler`` session, and changes no
detection. Under one, each ``Network.pipeline`` call is a request: a root
``pipeline`` span whose descendants nest inside it (``voxelize``, a span
per stage, ``post``, and per scan one ``nms`` with one ``nms.iou`` and one
``nms.suppress``). The counters equal what the NMS's parts give when they
are called directly: ``nms.live`` the live candidates of ``preselect``,
``nms.rounds`` the rounds of ``suppress``, and ``host_syncs`` a scan's
rounds + 3 (the live count, each round's comparison, the survivors'
``nonzero`` and the top index); the voxelizer and the stages read nothing.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hvpr_tpu_torch.utils import profiler

REPO = Path(__file__).resolve().parent.parent
STAGES = ('vfe', 'map_to_bev_module', 'backbone_2d', 'dense_head')


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(scope='module')
def net():
    from hvpr_tpu_torch.config import ConfigDict, cfg_from_yaml_file
    from hvpr_tpu_torch.models import DatasetMeta, build_network
    cfg = cfg_from_yaml_file(str(REPO / 'tools' / 'cfgs' / 'kitti_models' / 'hvpr_mini.yaml'),
                             ConfigDict())
    meta = DatasetMeta(cfg.DATA_CONFIG, cfg.CLASS_NAMES)
    torch.manual_seed(0)
    net = build_network(cfg.MODEL, 1, meta, device='cpu')
    with torch.no_grad():       # logits near 0, so that anchors clear SCORE_THRESH
        net.module.dense_head.conv_cls.bias.zero_()
    return net


def _scans(net, seed):
    rng = np.random.default_rng(seed)
    pcr = net.dataset.point_cloud_range
    pts = rng.uniform(pcr[:3], pcr[3:], (2, 256, 3))
    pts = np.concatenate([pts, rng.uniform(0, 1, (2, 256, 1))], axis=2).astype(np.float32)
    return torch.from_numpy(pts), torch.ones(2, 256, dtype=torch.bool)


@pytest.fixture(scope='module')
def traced(net):
    """Two pipeline calls under a profiler: (record, detections)."""
    profiler.clear()
    with _profiled():
        dets = [net.pipeline(*_scans(net, seed)) for seed in (0, 1)]
    return profiler.record(), dets


def _subtree(spans, root):
    """The spans under ``root`` (itself included)."""
    ids, out = {root['id']}, [root]
    for s in spans:                  # opened in order: a parent comes first
        if s['parent'] in ids:
            ids.add(s['id'])
            out.append(s)
    return out


def test_off_by_default_and_the_detections_are_the_same(net, traced):
    _, dets = traced
    profiler.clear()
    assert not profiler.recording()
    off = [net.pipeline(*_scans(net, seed)) for seed in (0, 1)]
    assert profiler.record() == [] and profiler.counters() == {}
    assert profiler.span('x') is profiler.span('y')          # the one idle context
    for got, want in zip(dets, off):
        assert bool(want['pred_mask'].any())
        for k in ('pred_boxes', 'pred_scores', 'pred_labels', 'pred_mask'):
            assert torch.equal(got[k], want[k]), k


def test_requests_nest_and_every_scan_has_one_nms(traced):
    spans, _ = traced
    by_id = {s['id']: s for s in spans}
    roots = [s for s in spans if s['parent'] is None]
    assert [s['name'] for s in roots] == ['pipeline', 'pipeline']
    assert roots[0]['request'] != roots[1]['request']
    for s in spans:
        assert s['device_ms'] is None                          # no card here
        if s['parent'] is None:
            continue
        parent = by_id[s['parent']]
        assert s['request'] == parent['request']
        assert parent['start_ns'] <= s['start_ns'] <= s['end_ns'] <= parent['end_ns']
    for root in roots:
        tree = _subtree(spans, root)
        children = [s['name'] for s in tree if s['parent'] == root['id']]
        assert children == ['voxelize', *STAGES, 'post']
        nms = [s for s in tree if s['name'] == 'nms']
        assert sorted(s['attrs']['scan'] for s in nms) == [0, 1]
        for n in nms:
            assert by_id[n['parent']]['name'] == 'post'
            assert [s['name'] for s in tree if s['parent'] == n['id']] == ['nms.iou',
                                                                         'nms.suppress']


def test_live_and_rounds_are_those_of_the_direct_calls(net, traced):
    from hvpr_tpu_torch.ops.nms import preselect, suppress
    from hvpr_tpu_torch.ops.rotated_iou import boxes_iou_bev
    spans, _ = traced
    nms_cfg = net.post_cfg['NMS_CONFIG']
    nms = [s for s in spans if s['name'] == 'nms']
    for seed, root in zip((0, 1), [s for s in spans if s['name'] == 'pipeline']):
        with torch.no_grad():
            out = net.module.eval()(net.voxelize(*_scans(net, seed)))
        for scan in range(2):
            scores = torch.sigmoid(out['batch_cls_preds'][scan]).max(dim=-1).values
            scores = torch.where(scores >= net.post_cfg['SCORE_THRESH'], scores, -torch.inf)
            order, valid = preselect(scores, int(nms_cfg['NMS_PRE_MAXSIZE']))
            boxes = out['batch_box_preds'][scan, order, :7]
            profiler.clear()
            with _profiled(), profiler.span('suppress'):
                suppress(boxes_iou_bev(boxes, boxes), valid, float(nms_cfg['NMS_THRESH']))
            rounds = profiler.record()[0]['counters']['nms.rounds']
            span = next(s for s in nms if s['request'] == root['request']
                        and s['attrs']['scan'] == scan)
            tree = _subtree(spans, span)
            assert span['counters']['nms.live'] == order.numel() > 1
            assert sum(s['counters'].get('nms.rounds', 0) for s in tree) == rounds >= 2


def test_host_syncs_are_rounds_plus_three_a_scan(traced):
    spans, _ = traced
    for root in [s for s in spans if s['name'] == 'pipeline']:
        tree = _subtree(spans, root)
        rounds = sum(s['counters'].get('nms.rounds', 0) for s in tree)
        syncs = sum(s['counters'].get('host_syncs', 0) for s in tree)
        assert syncs == rounds + 3 * 2
        assert all('host_syncs' not in s['counters'] for s in tree
                   if s['name'] in ('voxelize', *STAGES))


def test_counters_go_to_the_innermost_span_and_the_total():
    profiler.clear()
    profiler.count('outside')                                  # off: nothing
    with _profiled():
        profiler.count('c', 2)                                 # no span open: total only
        with profiler.span('a', scan=3):
            profiler.count('c')
            with profiler.span('b'):
                assert profiler.host_read(int, torch.tensor(5)) == 5
                profiler.count('c', 4)
    a, b = profiler.record()
    assert (a['name'], a['attrs'], a['counters']) == ('a', {'scan': 3}, {'c': 1})
    assert (b['name'], b['parent'], b['counters']) == ('b', a['id'], {'c': 4, 'host_syncs': 1})
    assert profiler.counters() == {'c': 7, 'host_syncs': 1}
    assert profiler.record() == [a, b]                          # idempotent


def test_a_device_count_is_read_when_the_record_is_drained():
    """``count_device`` keeps a 0-d tensor and reads it at ``record()``,
    into the innermost span open at the call and the total; the tensor may
    change until then, and no host read is counted. Off, it keeps
    nothing."""
    profiler.clear()
    profiler.count_device('d', torch.tensor(9))                 # off: nothing
    value = torch.zeros((), dtype=torch.int64)
    with _profiled():
        with profiler.span('a'):
            profiler.count_device('d', value)
            profiler.count('d', 2)
        profiler.count_device('d', torch.tensor(5))             # no span open: total only
        value += 7                                               # counted as it is at the drain
    assert profiler.counters() == {'d': 2}
    (a,) = profiler.record()
    assert a['counters'] == {'d': 9}
    assert profiler.counters() == {'d': 14}
    assert profiler.record() == [a] and profiler.counters() == {'d': 14}


def test_the_iou_kernel_name_is_no_marked_kernel():
    """The benchmark's trace holds the launches of its marked kernels
    against the program's count by the CUDA function's name; K13's
    function (``rotated_iou_kernel``) and its launch name must match no
    marker, so that the trace does not count it as another kernel."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        'bench_trace', REPO / 'benchmark' / 'harness' / 'trace.py')
    trace = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(trace)
    for name in ('void (anonymous namespace)::rotated_iou_kernel<true>(float const*, int, '
                 'float const*, float const*, float const*, int, float const*, float const*, '
                 'float*, int, int, int, unsigned long long*)',
                 'rotated_iou_kernel', 'rotated_iou', 'records_kernel'):
        assert trace.kernel_family(name) is None, name
    assert 'rotated_iou' not in trace.KERNEL_MARKERS
    assert trace.kernel_family('void canvas_kernel<true>(float4 const*)') == 'bev_canvas'


def test_multi_class_nms_is_a_span_per_class():
    from hvpr_tpu_torch.models.model_utils.model_nms_utils import multi_classes_nms
    rng = np.random.default_rng(2)
    boxes = np.zeros((40, 7), np.float32)
    boxes[:, :2] = rng.uniform(0, 10, (40, 2))
    boxes[:, 3:6] = rng.uniform(1, 3, (40, 3))
    scores = rng.uniform(0, 1, (40, 3)).astype(np.float32)
    cfg = {'NMS_THRESH': 0.1, 'NMS_PRE_MAXSIZE': 64, 'NMS_POST_MAXSIZE': 8}
    profiler.clear()
    with _profiled():
        multi_classes_nms(torch.from_numpy(scores), torch.from_numpy(boxes), cfg,
                          score_thresh=0.2, scan=1)
    nms = [s for s in profiler.record() if s['name'] == 'nms']
    assert [s['attrs'] for s in nms] == [{'scan': 1, 'cls': c} for c in range(3)]
    assert [s['counters']['nms.live'] for s in nms] == [int((scores[:, c] >= 0.2).sum())
                                                        for c in range(3)]


def test_trace_writes_the_spans_and_clears_the_record(tmp_path):
    with profiler.trace(tmp_path / 'one'):
        with profiler.span('first'):
            profiler.count('c')
    got = json.loads((tmp_path / 'one' / 'spans.json').read_text())
    assert [s['name'] for s in got['spans']] == ['first'] and got['counters'] == {'c': 1}
    assert (tmp_path / 'one' / 'trace.json').stat().st_size > 0
    with profiler.trace(tmp_path / 'two'):
        assert profiler.record() == [] and profiler.counters() == {}
        with profiler.span('second'):
            pass
    got = json.loads((tmp_path / 'two' / 'spans.json').read_text())
    assert [s['name'] for s in got['spans']] == ['second'] and got['counters'] == {}
