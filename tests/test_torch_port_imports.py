"""The port stands alone: no file of hvpr_tpu_torch/ or chip_smoke.py
imports jax, flax or the JAX package."""

import ast
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'hvpr_tpu')
FILES = sorted((REPO / 'hvpr_tpu_torch').rglob('*.py')) + [REPO / 'chip_smoke.py']


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ''


@pytest.mark.parametrize('path', FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported(tree) if m.split('.')[0] in FORBIDDEN]
    assert not bad, f'{path}: imports {bad}'


def test_port_package_imports_without_jax():
    """Importing every module of the port loads no JAX module."""
    import subprocess
    import sys
    code = ('import sys, pkgutil, importlib, hvpr_tpu_torch\n'
            'for m in pkgutil.walk_packages(hvpr_tpu_torch.__path__, "hvpr_tpu_torch."):\n'
            '    importlib.import_module(m.name)\n'
            'bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "hvpr_tpu")]\n'
            'assert not bad, bad\n')
    subprocess.run([sys.executable, '-c', code], cwd=REPO, check=True, timeout=120)


# the sparse voxel path, the multi-head and ATSS heads, PointNet2MSG_NOFP
# and the demo and vis entry points
SLICE_MODULES = (
    'hvpr_tpu_torch.ops.sparse_conv',
    'hvpr_tpu_torch.models.backbones_3d.sparse_backbone',
    'hvpr_tpu_torch.models.backbones_3d.spconv_backbone',
    'hvpr_tpu_torch.models.backbones_3d.pointnet2_backbone',
    'hvpr_tpu_torch.models.backbones_3d.vfe.pillar_vfe',
    'hvpr_tpu_torch.models.backbones_2d.map_to_bev.height_compression',
    'hvpr_tpu_torch.models.dense_heads.anchor_head_multi',
    'hvpr_tpu_torch.models.dense_heads.target_assigner.atss_target_assigner',
    'hvpr_tpu_torch.tools.visual_utils',
    'hvpr_tpu_torch.tools.demo',
    'hvpr_tpu_torch.tools.vis',
)


@pytest.mark.parametrize('name', SLICE_MODULES)
def test_slice_module_is_checked(name):
    """Each module exists, is among the files the AST check reads, and
    imports."""
    import importlib
    path = REPO / (name.replace('.', '/') + '.py')
    assert path in FILES
    importlib.import_module(name)


def test_slice_modules_import_without_jax():
    """Importing the slice's modules and tools (the registries that name
    them too) loads no JAX module, and matplotlib only when drawn."""
    import subprocess
    import sys
    code = ('import sys, importlib\n'
            f'for m in {SLICE_MODULES!r} + ("hvpr_tpu_torch.models",):\n'
            '    importlib.import_module(m)\n'
            'bad = [m for m in sys.modules\n'
            '       if m.split(".")[0] in ("jax", "flax", "hvpr_tpu", "matplotlib")]\n'
            'assert not bad, bad\n')
    subprocess.run([sys.executable, '-c', code], cwd=REPO, check=True, timeout=120)


# the options of ported modules that the JAX package accepts, and the JAX
# package's helper modules
OPTION_MODULES = ('hvpr_tpu_torch.utils.misc', 'hvpr_tpu_torch.utils.profiler')


@pytest.mark.parametrize('name', OPTION_MODULES)
def test_option_module_is_checked(name):
    import importlib
    path = REPO / (name.replace('.', '/') + '.py')
    assert path in FILES
    importlib.import_module(name)


def _head_cfg(target_cfg):
    anchor = {'class_name': 'Car', 'anchor_sizes': [[3.9, 1.6, 1.56]],
              'anchor_rotations': [0, 1.57], 'anchor_bottom_heights': [-1.78],
              'align_center': False, 'feature_map_stride': 2, 'matched_threshold': 0.6,
              'unmatched_threshold': 0.45}
    return {'NAME': 'AnchorHeadSingle', 'USE_DIRECTION_CLASSIFIER': True, 'NUM_DIR_BINS': 2,
            'DIR_OFFSET': 0.78539, 'DIR_LIMIT_OFFSET': 0.0,
            'ANCHOR_GENERATOR_CONFIG': [anchor],
            'TARGET_ASSIGNER_CONFIG': {'NAME': 'AxisAlignedTargetAssigner',
                                       'BOX_CODER': 'ResidualCoder', **target_cfg},
            'LOSS_CONFIG': {'LOSS_WEIGHTS': {'cls_weight': 1.0, 'loc_weight': 2.0,
                                             'dir_weight': 0.2, 'code_weights': [1.0] * 8}}}


def _build_option(option):
    """Build the module that takes ``option``; returns what it built."""
    import torch
    from hvpr_tpu_torch.models.backbones_2d.base_bev_backbone import BaseBEVBackboneScale
    from hvpr_tpu_torch.models.backbones_2d.map_to_bev.pointpillar_scatter import (
        PointPillarScatterAggMemory1Scale)
    from hvpr_tpu_torch.models.dense_heads.anchor_head_single import AnchorHeadSingle
    from hvpr_tpu_torch.optimization import build_optimizer
    from hvpr_tpu_torch.utils import box_coder_utils
    head = lambda **kw: AnchorHeadSingle(_head_cfg(kw), 16, 1, ['Car'], (16, 16, 1),
                                         (0, -2.56, -3, 5.12, 2.56, 1))
    if option == 'encode_angle_by_sincos':
        return head(BOX_CODER_CONFIG={'encode_angle_by_sincos': True})
    if option in ('PreviousResidualDecoder', 'PointResidualCoder'):
        return box_coder_utils.build_box_coder(
            {'BOX_CODER': option, 'BOX_CODER_CONFIG': {'mean_size': [[3.9, 1.6, 1.56]]}})
    if option == 'MATCH_HEIGHT':
        return head(MATCH_HEIGHT=True).target_assigner
    if option == 'POS_FRACTION':
        return head(POS_FRACTION=0.25, SAMPLE_SIZE=512).target_assigner
    if option == 'NORM_BY_NUM_EXAMPLES':
        return head(NORM_BY_NUM_EXAMPLES=True).target_assigner
    if option == 'DUAL_PASS':
        return BaseBEVBackboneScale(
            {'DUAL_PASS': 'sequential', 'LAYER_NUMS': [1], 'SFM_LAYER_NUMS': [1],
             'LAYER_STRIDES': [1], 'NUM_FILTERS': [8], 'NUM_SCALE_FILTERS': [4],
             'UPSAMPLE_STRIDES': [1], 'NUM_UPSAMPLE_FILTERS': [8]}, 8, 4)
    if option == 'TOPK_MODE':
        return PointPillarScatterAggMemory1Scale(
            {'NUM_K': 4, 'NUM_M': 16, 'NUM_PT_FEATURES': 8, 'SHRINK_TH': 0.0025,
             'TOPK_MODE': 'approx'}, (8, 8, 1))
    return build_optimizer(torch.nn.Linear(2, 2), {'OPTIMIZER': option, 'LR': 0.01},
                           total_iters_each_epoch=4)


@pytest.mark.parametrize('option', ['encode_angle_by_sincos', 'PreviousResidualDecoder',
                                    'PointResidualCoder', 'MATCH_HEIGHT', 'POS_FRACTION',
                                    'NORM_BY_NUM_EXAMPLES', 'DUAL_PASS', 'TOPK_MODE',
                                    'adam', 'sgd'])
def test_option_builds(option):
    """Each option the JAX package accepts builds in the port (none raises)."""
    built = _build_option(option)
    if option == 'encode_angle_by_sincos':
        assert built.box_coder.code_size == 8 and built.conv_box.out_channels == 2 * 8
    elif option == 'POS_FRACTION':
        assert (built.pos_fraction, built.sample_size) == (0.25, 512)
    elif option == 'TOPK_MODE':
        assert built.topk_mode == 'approx'
    elif option in ('adam', 'sgd'):
        assert built.schedule_name == f'{option} with step decay'
