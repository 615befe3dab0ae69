"""Per-class NMS (hvpr_multiclass.yaml's MULTI_CLASSES_NMS) in the port
against the JAX package on the CPU: ``multi_classes_nms``,
``post_processing`` with the JAX package's NMS_STAGE ladder (the busy-class
case of tests/test_multiclass.py), and a 3-class hvpr_mini-sized
MixAnchor_Memory (hvpr_multiclass.yaml's Car / Pedestrian / Cyclist anchors
and NMS) through eval and one train step.

Tolerances and why: NMS on the same boxes and scores is exact (the kept
indices equal, so the gathered boxes, scores and labels are the same bits):
the rotated IoU is computed in another order, but no pair of these seeded
boxes sits within rounding of NMS_THRESH. The network, f32: detections as
``torch_port_helpers.check_pipeline`` holds hvpr_mini (kept sets and labels
equal, boxes and scores within 1e-4); one train step's loss terms rtol
1e-4 and 99% of the updated weights within 1e-6 relative, as
``test_torch_port_train_step.py`` holds the 1-class step.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_train_step import TrainPair, check_steps, train_cfg
from torch_port_helpers import Pair, check_pipeline, load_cfg, mini_cfg, torch_threads

from hvpr_tpu.models.detectors.detector3d_template import post_processing as jax_post
from hvpr_tpu.models.model_utils.model_nms_utils import multi_classes_nms as jax_mcnms
from hvpr_tpu.ops.nms import nms_bev_fixed as jax_nms

from hvpr_tpu_torch.models.detectors.detector3d_template import post_processing
from hvpr_tpu_torch.models.model_utils.model_nms_utils import multi_classes_nms
from hvpr_tpu_torch.ops.nms import nms_bev_fixed
from hvpr_tpu_torch.utils.weights import from_flax_variables


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    with torch_threads(1):
        yield


def random_boxes(rng, b, a):
    boxes = np.zeros((b, a, 7), np.float32)
    boxes[..., 0] = rng.uniform(0, 47, (b, a))
    boxes[..., 1] = rng.uniform(-19, 19, (b, a))
    boxes[..., 2] = rng.uniform(-2, 0, (b, a))
    boxes[..., 3:5] = rng.uniform(1.4, 4.2, (b, a, 2))
    boxes[..., 5] = 1.5
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (b, a))
    return boxes


NMS_CFG = {'MULTI_CLASSES_NMS': True, 'NMS_TYPE': 'nms_gpu', 'NMS_THRESH': 0.1,
           'NMS_PRE_MAXSIZE': 512, 'NMS_POST_MAXSIZE': 40}


@pytest.mark.parametrize('score_thresh', [None, 0.1, 0.6])
def test_multi_classes_nms_matches_jax(score_thresh):
    rng = np.random.default_rng(3)
    boxes = random_boxes(rng, 1, 900)[0]
    scores = rng.uniform(0, 1, (900, 3)).astype(np.float32)
    want = jax_mcnms(jnp.asarray(scores), jnp.asarray(boxes), NMS_CFG,
                     score_thresh=score_thresh)
    got = multi_classes_nms(torch.from_numpy(scores), torch.from_numpy(boxes), NMS_CFG,
                            score_thresh=score_thresh)
    mask = np.asarray(want[3])
    np.testing.assert_array_equal(got[3].numpy(), mask)
    assert got[0].shape == (3 * 40, 7) and mask.sum() > 0
    for g, w, what in zip(got[:3], want[:3], ('boxes', 'scores', 'labels')):
        np.testing.assert_array_equal(g.numpy()[mask], np.asarray(w)[mask], err_msg=what)
    assert int(got[4]) == int(want[4])
    if score_thresh is None:
        assert int(got[4]) > 0          # the per-class cap of 40 drops survivors
    # each class's kept indices, from the same scores
    for c in range(3):
        s = scores[:, c] if score_thresh is None else \
            np.where(scores[:, c] >= score_thresh, scores[:, c], -np.inf).astype(np.float32)
        ji, jm, jn = jax_nms(jnp.asarray(boxes), jnp.asarray(s), 0.1, pre_maxsize=512,
                             post_maxsize=40, stage1=512)
        ti, tm, tn = nms_bev_fixed(torch.from_numpy(boxes), torch.from_numpy(s), 0.1,
                                   pre_maxsize=512, post_maxsize=40)
        m = np.asarray(jm)
        np.testing.assert_array_equal(tm.numpy(), m)
        np.testing.assert_array_equal(ti.numpy()[m], np.asarray(ji)[m])
        assert int(tn) == int(jn)


@pytest.mark.parametrize('n_live_per_class', [(400, 10), (20, 15)],
                         ids=['busy_class', 'all_sparse'])
def test_post_processing_matches_the_jax_ladder(n_live_per_class):
    """The JAX package picks the NMS size from a ladder by the busiest
    class (400 live candidates force the full 1024 for both classes; 20
    take the 128 stage); the port runs every class at NMS_PRE_MAXSIZE over
    its live candidates. Both give the same detections and recall."""
    rng = np.random.default_rng(11)
    b, a = 2, 2000
    boxes = random_boxes(rng, b, a)
    probs = np.zeros((b, a, 2), np.float32)            # below SCORE_THRESH
    for c, n_live in enumerate(n_live_per_class):
        for i in range(b):
            idx = rng.choice(a, n_live, replace=False)
            probs[i, idx, c] = rng.uniform(0.1, 1.0, n_live)
    gt = np.zeros((b, 4, 8), np.float32)
    gt[:, :3, :7] = boxes[:, :3]
    gt[:, :3, 7] = 1
    cfg = {'SCORE_THRESH': 0.1, 'RECALL_THRESH_LIST': [0.3, 0.5],
           'NMS_CONFIG': dict(NMS_CFG, NMS_PRE_MAXSIZE=1024, NMS_STAGE1_MAXSIZE=128,
                              NMS_POST_MAXSIZE=64)}
    want = jax_post({'batch_cls_preds': jnp.asarray(probs),
                     'batch_box_preds': jnp.asarray(boxes),
                     'cls_preds_normalized': True, 'gt_boxes': jnp.asarray(gt)},
                    cfg, num_class=2)
    got = post_processing({'batch_cls_preds': torch.from_numpy(probs),
                           'batch_box_preds': torch.from_numpy(boxes),
                           'cls_preds_normalized': True, 'gt_boxes': torch.from_numpy(gt)},
                          cfg, num_class=2)
    mask = np.asarray(want['pred_mask'])
    assert got['pred_boxes'].shape == (b, 128, 7) and mask.sum() > 0
    for key in ('pred_mask', 'pred_boxes', 'pred_scores', 'pred_labels', 'num_capped'):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    assert {k: int(v) for k, v in got['recall'].items()} == \
        {k: int(v) for k, v in want['recall'].items()}


def multiclass_mini_cfg():
    """hvpr_mini.yaml with hvpr_multiclass.yaml's classes, anchors and NMS."""
    cfg = mini_cfg()
    multi = load_cfg('hvpr_multiclass.yaml')
    cfg.CLASS_NAMES = list(multi.CLASS_NAMES)
    cfg.MODEL.DENSE_HEAD.ANCHOR_GENERATOR_CONFIG = multi.MODEL.DENSE_HEAD.ANCHOR_GENERATOR_CONFIG
    cfg.MODEL.POST_PROCESSING.NMS_CONFIG.MULTI_CLASSES_NMS = True
    return cfg


def test_multiclass_network_eval_matches_jax():
    pair = Pair(multiclass_mini_cfg(), batch=2, n_points=256)
    assert pair.tnet.module.dense_head.conv_cls.out_channels == 2 * 3 * 3
    n_live, n_kept = check_pipeline(pair, box_tol=1e-4)
    assert n_live >= 100 and n_kept > 0


def test_multiclass_train_step_matches_jax():
    pair = TrainPair(train_cfg(multiclass_mini_cfg()))
    assert {int(c) for c in pair.gt[..., 7].ravel()} >= {1, 2, 3}
    # every leaf of the 3-class tree (point stream included) lands on its
    # own port key, and every key of the port's train module is fed
    state = from_flax_variables(pair.flat)
    assert len([k for k in state if not k.endswith('num_batches_tracked')]) == len(pair.flat)
    assert set(state) == set(pair.tnet.module.state_dict())
    tm = check_steps(pair, 1)
    assert tm[0]['rpn_loss_cls'] > 0 and tm[0]['mem_loss'] > 0
