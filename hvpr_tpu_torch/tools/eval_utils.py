"""Evaluation loop: batched inference -> the dataset's annos -> its metric.

The port's ``tools/eval_utils/eval_utils.py``: each host batch of the data
layer goes to the network's device (``load_data_to_gpu``), through
``Network.eval_forward``, and back as per-scan detections (the kept slots
of NMS_POST_MAXSIZE, or of C times it with per-class NMS), which the
dataset turns into annos (with ``save_to_file`` also files: KITTI label
``.txt`` files, nuScenes submission rows as ``<token>.json``); then
``result.pkl`` and the dataset's evaluation, the one POST_PROCESSING's
EVAL_METRIC names (``kitti``: the official AP; ``nuscenes``: the devkit's,
or without it the centre-distance AP). Progress goes to the
logger. Besides the recall and AP keys of the JAX package's loop, the
result holds the loop's timing under ``eval_time/``: scans per second, the
share of the loop spent waiting on the DataLoader, both again past the
first batch (``steady_*``, the workers' start-up left out; only with more
than one batch), the forward's median milliseconds a batch (host clock,
device synchronized) and the evaluator's seconds.

With ``dist_test`` each rank of the process group evaluates its share
(the strided eval sampler), and rank 0 gathers every rank's annos in
dataset order, truncated to the dataset's length (``merge_results_dist``),
with the recall counters summed over the ranks, as the JAX package does;
rank 0 alone writes ``result.pkl`` and the ``.txt`` files and runs the
evaluator. The timing is rank 0's own loop.
"""

import pickle
import statistics
import time

import numpy as np
import torch

from ..models import load_data_to_gpu
from ..utils.common_utils import get_dist_info, merge_results_dist


def statistics_info(cfg, ret_dict, metric, disp_dict):
    for cur_thresh in cfg['MODEL']['POST_PROCESSING']['RECALL_THRESH_LIST']:
        metric[f'recall_roi_{cur_thresh}'] += int(ret_dict.get(f'roi_{cur_thresh}', 0))
        metric[f'recall_rcnn_{cur_thresh}'] += int(ret_dict.get(f'rcnn_{cur_thresh}', 0))
    metric['gt_num'] += int(ret_dict.get('gt', 0))
    min_thresh = cfg['MODEL']['POST_PROCESSING']['RECALL_THRESH_LIST'][0]
    disp_dict['recall_%s' % str(min_thresh)] = \
        f"{metric[f'recall_roi_{min_thresh}']}/{metric['gt_num']}"


def _forward(model, batch_dict, keep_gt):
    """Detections of one host batch as numpy arrays, and the seconds of the
    forward (the device synchronized at its end)."""
    device_batch = load_data_to_gpu(
        {k: v for k, v in batch_dict.items() if isinstance(v, np.ndarray)},
        model.device)
    if not keep_gt:
        device_batch.pop('gt_boxes', None)
    t0 = time.perf_counter()
    out = model.eval_forward(device_batch)
    if model.device.type == 'cuda':
        torch.cuda.synchronize(model.device)
    seconds = time.perf_counter() - t0
    host = {k: out[k].cpu().numpy() for k in
            ('pred_boxes', 'pred_scores', 'pred_labels', 'pred_mask', 'num_capped')}
    if 'recall' in out:
        host['recall'] = {k: int(v) for k, v in out['recall'].items()}
    return host, seconds


def eval_one_epoch(cfg, model, dataloader, epoch_id, logger, dist_test=False,
                   save_to_file=False, result_dir=None):
    """Evaluate ``model`` over ``dataloader``; the result dict (recall, AP,
    ``eval_time/``), {} on ranks other than 0 under ``dist_test``."""
    rank = get_dist_info()[0] if dist_test else 0
    result_dir.mkdir(parents=True, exist_ok=True)
    final_output_dir = result_dir / 'final_result' / 'data'
    if save_to_file and rank == 0:
        final_output_dir.mkdir(parents=True, exist_ok=True)

    thresh_list = cfg['MODEL']['POST_PROCESSING']['RECALL_THRESH_LIST']
    metric = {'gt_num': 0}
    for cur_thresh in thresh_list:
        metric[f'recall_roi_{cur_thresh}'] = 0
        metric[f'recall_rcnn_{cur_thresh}'] = 0

    dataset = dataloader.dataset
    class_names = dataset.class_names
    det_annos = []

    logger.info('*************** EPOCH %s EVALUATION *****************', epoch_id)
    num_batches = len(dataloader)
    forward_s, wait_s = [], 0.0
    first_s = first_wait_s = first_n = None
    start_time = time.perf_counter()
    batches = iter(dataloader)
    for i in range(num_batches):
        t0 = time.perf_counter()
        batch_dict = next(batches)
        wait_s += time.perf_counter() - t0
        out, seconds = _forward(model, batch_dict, keep_gt=bool(thresh_list))
        forward_s.append(seconds)

        disp_dict = {}
        if 'recall' in out:
            statistics_info(cfg, out['recall'], metric, disp_dict)

        pred_dicts = []
        for b in range(out['pred_boxes'].shape[0]):
            m = out['pred_mask'][b]
            pred_dicts.append({
                'pred_boxes': out['pred_boxes'][b][m],
                'pred_scores': out['pred_scores'][b][m],
                'pred_labels': out['pred_labels'][b][m],
            })
        capped = int(out['num_capped'].sum())
        if capped:
            logger.warning('NMS_POST_MAXSIZE dropped %d surviving boxes '
                           'in this batch', capped)

        det_annos += dataset.generate_prediction_dicts(
            batch_dict, pred_dicts, class_names,
            output_path=final_output_dir if save_to_file and not dist_test else None)
        logger.info('eval batch %d/%d %s', i + 1, num_batches, disp_dict)
        if i == 0:
            first_s, first_wait_s, first_n = (time.perf_counter() - start_time, wait_s,
                                              len(det_annos))
    loop_s = time.perf_counter() - start_time
    timing = {
        'eval_time/scans_per_s': len(det_annos) / loop_s,
        'eval_time/loader_wait_share': wait_s / loop_s,
        'eval_time/forward_median_ms': statistics.median(forward_s) * 1e3
        if forward_s else 0.0,
    }
    if num_batches > 1:
        timing['eval_time/steady_scans_per_s'] = (len(det_annos) - first_n) / (loop_s - first_s)
        timing['eval_time/steady_loader_wait_share'] = \
            (wait_s - first_wait_s) / (loop_s - first_s)

    sec_per_example = loop_s / max(len(dataset), 1)
    logger.info('Generate label finished(sec_per_example: %.4f second).', sec_per_example)

    if dist_test:
        metrics = merge_results_dist([metric], get_dist_info()[1])
        det_annos = merge_results_dist(det_annos, len(dataset))
        if rank != 0:
            return {}
        metric = {k: sum(m[k] for m in metrics) for k in metric}
        if save_to_file:
            dataset.write_prediction_files(det_annos, final_output_dir)

    ret_dict = {}
    gt_num_cnt = metric['gt_num']
    for cur_thresh in thresh_list:
        cur_roi_recall = metric[f'recall_roi_{cur_thresh}'] / max(gt_num_cnt, 1)
        cur_rcnn_recall = metric[f'recall_rcnn_{cur_thresh}'] / max(gt_num_cnt, 1)
        logger.info('recall_roi_%s: %f', cur_thresh, cur_roi_recall)
        logger.info('recall_rcnn_%s: %f', cur_thresh, cur_rcnn_recall)
        ret_dict[f'recall/roi_{cur_thresh}'] = cur_roi_recall
        ret_dict[f'recall/rcnn_{cur_thresh}'] = cur_rcnn_recall

    total_pred_objects = sum(len(a['name']) for a in det_annos)
    logger.info('Average predicted number of objects(%d samples): %.3f',
                len(det_annos), total_pred_objects / max(len(det_annos), 1))

    with open(result_dir / 'result.pkl', 'wb') as f:
        pickle.dump(det_annos, f)

    t0 = time.perf_counter()
    result_str, result_dict = dataset.evaluation(
        det_annos, class_names,
        eval_metric=cfg['MODEL']['POST_PROCESSING'].get('EVAL_METRIC'))
    evaluator_s = time.perf_counter() - t0
    if result_str is not None:
        logger.info(result_str)
    ret_dict.update(result_dict)
    ret_dict.update(timing, **{'eval_time/evaluator_s': evaluator_s})
    logger.info('eval loop on %s: %d scans in %.3f s (%.3f scans/s), %.3f of it '
                'waiting on the DataLoader, forward median %.3f ms a batch; '
                'evaluator %.3f s', model.device, len(det_annos), loop_s,
                ret_dict['eval_time/scans_per_s'], ret_dict['eval_time/loader_wait_share'],
                ret_dict['eval_time/forward_median_ms'], evaluator_s)
    logger.info('Result is save to %s', result_dir)
    logger.info('****************Evaluation done.*****************')
    return ret_dict
