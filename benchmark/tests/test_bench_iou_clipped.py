"""``nms_iou_clipped.infer``: the share of the NMS's box pairs that the
rotated IoU kernel clipped in full, from the program's ``nms.iou_clipped``
and ``nms.iou_pairs`` counters over the window's ``nms`` spans. Read on a
synthetic record (the counters on the ``nms.iou`` spans, as the kernel's
wrapper counts them, and pairs counted outside any ``nms`` span left out);
nothing to read without the recorder, with an empty record, or where the
program counts no pairs (a program without the kernel)."""

from types import SimpleNamespace

import pytest

from harness.spec import BENCH_DIR, load_reader

NAME = 'nms_iou_clipped.infer'


def _record(clipped, pairs):
    """One request of two scans: each ``nms`` span with an ``nms.iou``
    child holding the counters, and a recall IoU under ``post``."""
    spans = []

    def add(name, parent, counters=None):
        spans.append({'name': name, 'id': len(spans), 'parent': parent, 'request': 0,
                      'start_ns': len(spans), 'end_ns': 100 - len(spans), 'device_ms': 1.0,
                      'attrs': {}, 'counters': counters or {}})
        return spans[-1]['id']

    root = add('pipeline', None)
    post = add('post', root, {'nms.iou_pairs': 10 ** 6, 'nms.iou_clipped': 10 ** 6})
    for c, p in zip(clipped, pairs):
        nms = add('nms', post, {'nms.live': 4096})
        add('nms.iou', nms, {'nms.iou_pairs': p, 'nms.iou_clipped': c} if p else {})
        add('nms.suppress', nms, {'nms.rounds': 3})
    return spans


def _read(monkeypatch, spans):
    from hvpr_tpu_torch.utils import profiler
    monkeypatch.setattr(profiler, 'record', lambda: [dict(s) for s in spans])
    return load_reader(NAME, [BENCH_DIR])(SimpleNamespace(trace=None, launches_match=False))


def test_the_share_over_the_nms_spans(monkeypatch):
    got = _read(monkeypatch, _record((300, 100), (4096 ** 2, 4096 ** 2)))
    assert got == pytest.approx(100.0 * 400 / (2 * 4096 ** 2))


def test_nothing_to_read_without_pairs_or_a_record(monkeypatch):
    assert _read(monkeypatch, _record((0, 0), (0, 0))) is None     # a program without K13
    assert _read(monkeypatch, []) is None
    from hvpr_tpu_torch.utils import profiler
    monkeypatch.delattr(profiler, 'record')                         # an older program
    assert load_reader(NAME, [BENCH_DIR])(SimpleNamespace()) is None
