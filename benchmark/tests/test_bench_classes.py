"""A configuration that is not HVPR, added by files alone: a tiny PointPillar
of the three KITTI classes with the anchors of OpenPCDet's
``tools/cfgs/kitti_models/pointpillar.yaml`` (PillarVFE, PointPillarScatter,
BaseBEVBackbone, AnchorHeadSingle, no memory), with a plain reference of its
own written into the search directory. A traced run on the CPU is correct,
its detections carry every class's label, and with two class columns of the
head's output swapped the check fails: the classes after the first are
judged. A configuration the check cannot judge is refused when its cell
loads."""

import json
import time

import pytest

from harness import faults
from harness.program import Program
from harness.run_cell import run_cell
from harness.spec import Cell
from tiny import tiny_config, write_search_dir

SEED = 2 ** 31 + 211

REFERENCE = '''"""Plain PyTorch reference of a PointPillar detector: PillarVFE,
PointPillarScatter, BaseBEVBackbone and AnchorHeadSingle, on the pillar
reference's shared parts."""

import torch

from reference.model import Reference as PillarReference, stated_f32


class Reference(PillarReference):
    MODEL_NAME = 'PointPillar'

    def check_stated(self):
        stated_f32(self.model)

    def bev(self, voxels, num, cells):
        x = self.canvas(self.pfn(voxels, num, cells), cells)
        cfg = self.model['BACKBONE_2D']
        ups = []
        for i, n in enumerate(cfg['LAYER_NUMS']):
            x = self._conv_bn_relu(x, f'backbone_2d.blocks.{i}.1.weight',
                                   f'backbone_2d.blocks.{i}.2', int(cfg['LAYER_STRIDES'][i]))
            for j in range(n):
                x = self._conv_bn_relu(x, f'backbone_2d.blocks.{i}.{4 + 3 * j}.weight',
                                       f'backbone_2d.blocks.{i}.{5 + 3 * j}')
            ups.append(self._deconv_bn_relu(x, f'backbone_2d.deblocks.{i}.0.weight',
                                            f'backbone_2d.deblocks.{i}.1',
                                            int(cfg['UPSAMPLE_STRIDES'][i])))
        return torch.cat(ups, dim=1)
'''


def _anchor(name, size, bottom, matched, unmatched):
    return {'class_name': name, 'anchor_sizes': [size], 'anchor_rotations': [0, 1.57],
            'anchor_bottom_heights': [bottom], 'align_center': False, 'feature_map_stride': 2,
            'matched_threshold': matched, 'unmatched_threshold': unmatched}


def tiny_pointpillar():
    """The tiny HVPR's data layer under a PointPillar of three classes:
    pointpillar.yaml's head, anchors and post-processing, narrow layers, and
    1,024 NMS candidates (the CPU's plain rotated IoU of 4,096 takes ~30 s a
    request)."""
    cfg = tiny_config()
    hvpr = cfg['MODEL']
    cfg.update(name='tiny_pointpillar', reference='tiny_pointpillar',
               weights={'scheme': 'seed_weights', 'box_std': 0.001, 'cls_bias': 0})
    del cfg['work']
    cfg['CLASS_NAMES'] = ['Car', 'Pedestrian', 'Cyclist']
    head = dict(hvpr['DENSE_HEAD'], ANCHOR_GENERATOR_CONFIG=[
        _anchor('Car', [3.9, 1.6, 1.56], -1.78, 0.6, 0.45),
        _anchor('Pedestrian', [0.8, 0.6, 1.73], -0.6, 0.5, 0.35),
        _anchor('Cyclist', [1.76, 0.6, 1.73], -0.6, 0.5, 0.35)])
    post = json.loads(json.dumps(hvpr['POST_PROCESSING']))
    post['NMS_CONFIG'].update(NMS_THRESH=0.01, NMS_PRE_MAXSIZE=1024)
    cfg['MODEL'] = {
        'NAME': 'PointPillar',
        'VFE': {'NAME': 'PillarVFE', 'WITH_DISTANCE': False, 'USE_ABSLOTE_XYZ': True,
                'USE_NORM': True, 'NUM_FILTERS': [32]},
        'MAP_TO_BEV': {'NAME': 'PointPillarScatter', 'NUM_BEV_FEATURES': 32},
        'BACKBONE_2D': {'NAME': 'BaseBEVBackbone', 'LAYER_NUMS': [1, 1, 1],
                        'LAYER_STRIDES': [2, 2, 2], 'NUM_FILTERS': [16, 32, 64],
                        'UPSAMPLE_STRIDES': [1, 2, 4], 'NUM_UPSAMPLE_FILTERS': [16, 16, 16]},
        'DENSE_HEAD': head,
        'POST_PROCESSING': post}
    return cfg


def _pointpillar_cell(root):
    """The cell ``tiny_pointpillar.infer``, its configuration and its
    reference added as files under ``root``."""
    bench_json = write_search_dir(root, bench_cells=())
    (root / 'configs' / 'tiny_pointpillar.json').write_text(json.dumps(tiny_pointpillar()))
    (root / 'reference').mkdir()
    (root / 'reference' / 'tiny_pointpillar.py').write_text(REFERENCE)
    limits = json.loads((root / 'workloads' / 'tiny_hvpr.infer.json').read_text())['limits']
    (root / 'workloads' / 'tiny_pointpillar.infer.json').write_text(json.dumps(
        {'config': 'tiny_pointpillar', 'compare_scans': 3, 'limits': limits}))
    bench = json.loads(bench_json.read_text())
    bench['workloads'] = [{'name': 'tiny_pointpillar.infer', 'config': 'tiny_pointpillar',
                           'traffic': 'tiny_b2', 'chips': 1, 'why': 'a CPU test'}]
    bench_json.write_text(json.dumps(bench))
    return Cell('tiny_pointpillar.infer', bench_json=bench_json, search=[root])


def test_a_pointpillar_of_three_classes_runs_traced_and_is_correct(tmp_path):
    labels = set()

    def recording(cell, seed, device):
        prog = Program(cell, seed, device)
        detect = prog.detect

        def detect_and_keep_labels(points, mask, key=None):
            out = detect(points, mask, key)
            labels.update(out['pred_labels'][out['pred_mask']].tolist())
            return out

        prog.detect = detect_and_keep_labels
        return prog

    cell = _pointpillar_cell(tmp_path)
    assert cell.work() is None
    result = run_cell(cell, SEED, 0.0, True, 'cpu', time.perf_counter(), lambda m: None,
                      program_factory=recording)
    assert result['correct'], result['checks']
    assert labels == {1, 2, 3}
    assert 'pipeline_mfu.infer' not in result['metrics']


def test_swapped_class_columns_fail_the_check(tmp_path):
    result = run_cell(_pointpillar_cell(tmp_path), SEED, 0.0, False, 'cpu', time.perf_counter(),
                      lambda m: None, program_factory=faults.swapped_classes)
    assert not result['correct'], result['checks']


@pytest.mark.parametrize('edit, message', [('reference', 'names no reference'),
                                           ('MULTI_CLASSES_NMS', 'MULTI_CLASSES_NMS')])
def test_a_configuration_the_check_cannot_judge_is_refused(tmp_path, edit, message):
    bench_json = write_search_dir(tmp_path)
    path = tmp_path / 'configs' / 'tiny_hvpr.json'
    cfg = json.loads(path.read_text())
    if edit == 'reference':
        del cfg['reference']
    else:
        cfg['MODEL']['POST_PROCESSING']['NMS_CONFIG']['MULTI_CLASSES_NMS'] = True
    path.write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match=message):
        Cell('tiny_hvpr.infer', bench_json=bench_json, search=[tmp_path])
