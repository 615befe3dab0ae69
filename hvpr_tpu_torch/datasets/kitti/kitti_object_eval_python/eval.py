"""Official KITTI AP evaluator (40-recall-point and 41-point metrics).

The port's copy of ``hvpr_tpu/datasets/kitti/kitti_object_eval_python/eval.py``:
the published KITTI devkit semantics (greedy per-image matching with
ignored / similar-class / DontCare handling, difficulty gating by bbox
height / occlusion / truncation, AOS orientation similarity), bbox / BEV /
3D / AOS metrics, 41-point and R40 AP and the official result string. The
rotated IoU runs in the native C++ library of :mod:`hvpr_tpu_torch.native`
(plain fallback in ``ops/rotated_iou.py``); the sequential matching loop
runs in the native kernel when the library is available, else in Python.
"""

import numpy as np

from ....ops.rotated_iou import boxes_bev_iou_cpu
from ....native import geometry as native_geometry


# ---------------------------------------------------------------- primitives

def get_thresholds(scores, num_gt, num_sample_pts=41):
    """Score thresholds hitting evenly spaced recall levels."""
    scores = np.sort(scores)[::-1]
    current_recall = 0.0
    thresholds = []
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < (len(scores) - 1) else l_recall
        if ((r_recall - current_recall) < (current_recall - l_recall)) \
                and (i < (len(scores) - 1)):
            continue
        thresholds.append(score)
        current_recall += 1 / (num_sample_pts - 1.0)
    return thresholds


def image_box_overlap(boxes, query_boxes, criterion=-1):
    """2D image-box overlap. criterion -1: IoU, 0: boxes area, 1: query area."""
    n, k = boxes.shape[0], query_boxes.shape[0]
    overlaps = np.zeros((n, k), dtype=np.float64)
    for j in range(k):
        qbox_area = ((query_boxes[j, 2] - query_boxes[j, 0])
                     * (query_boxes[j, 3] - query_boxes[j, 1]))
        iw = (np.minimum(boxes[:, 2], query_boxes[j, 2])
              - np.maximum(boxes[:, 0], query_boxes[j, 0]))
        ih = (np.minimum(boxes[:, 3], query_boxes[j, 3])
              - np.maximum(boxes[:, 1], query_boxes[j, 1]))
        mask = (iw > 0) & (ih > 0)
        inter = np.where(mask, iw * ih, 0.0)
        if criterion == -1:
            box_area = ((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]))
            ua = box_area + qbox_area - inter
        elif criterion == 0:
            ua = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        else:
            ua = np.full(n, qbox_area)
        # mask before dividing: ua can be 0 on masked/degenerate rows and a
        # raw inter/ua would raise RuntimeWarnings that hide real NaN bugs
        ok = mask & (ua > 0)
        overlaps[:, j] = np.where(ok, inter / np.where(ok, ua, 1.0), 0.0)
    return overlaps


def bev_box_overlap(boxes, qboxes, criterion=-1):
    """Rotated BEV overlap of camera-frame boxes [x, z, w, l, ry]-style rows."""
    # boxes: (N, 5) [x, z, l(dim0), w(dim1), ry] in camera bev; reuse the lidar
    # rotated-IoU by mapping (x, z) -> (x, y) and negating the rotation.
    def to7(b):
        out = np.zeros((b.shape[0], 7), dtype=np.float32)
        out[:, 0] = b[:, 0]
        out[:, 1] = b[:, 1]
        out[:, 3] = b[:, 2]
        out[:, 4] = b[:, 3]
        out[:, 6] = -b[:, 4]
        return out

    if criterion == -1:
        return boxes_bev_iou_cpu(to7(boxes), to7(qboxes)).astype(np.float64)
    # other criteria need the raw intersection area (host-side: the metric
    # must not round-trip through jitted code with dynamic (N, M) shapes)
    from ....ops.rotated_iou import boxes_overlap_bev_cpu
    inter = boxes_overlap_bev_cpu(to7(boxes), to7(qboxes))
    if criterion == -2:          # intersection area only (used by d3_box_overlap)
        return inter.astype(np.float64)
    if criterion == 0:
        denom = (boxes[:, 2] * boxes[:, 3])[:, None]
    else:
        denom = (qboxes[:, 2] * qboxes[:, 3])[None, :]
    return (inter / np.maximum(denom, 1e-9)).astype(np.float64)


def d3_box_overlap(boxes, qboxes, criterion=-1):
    """3D overlap of camera-frame boxes (N, 7) [x, y, z, l, h, w, ry].

    Camera y points down and boxes are bottom-centered: the vertical overlap
    is [y - h, y].
    """
    bev = bev_box_overlap(boxes[:, [0, 2, 3, 5, 6]],
                          qboxes[:, [0, 2, 3, 5, 6]], criterion=-2)
    ymax = np.minimum(boxes[:, None, 1], qboxes[None, :, 1])
    ymin = np.maximum(boxes[:, None, 1] - boxes[:, None, 4],
                      qboxes[None, :, 1] - qboxes[None, :, 4])
    ih = np.clip(ymax - ymin, 0.0, None)
    inter = bev * ih
    vol_b = boxes[:, 3] * boxes[:, 4] * boxes[:, 5]
    vol_q = qboxes[:, 3] * qboxes[:, 4] * qboxes[:, 5]
    if criterion == -1:
        ua = vol_b[:, None] + vol_q[None, :] - inter
    elif criterion == 0:
        ua = np.broadcast_to(vol_b[:, None], inter.shape)
    else:
        ua = np.broadcast_to(vol_q[None, :], inter.shape)
    return (inter / np.maximum(ua, 1e-9)).astype(np.float64)


# ----------------------------------------------------------------- match core

NO_DETECTION = -10000000.0


def _dontcare_fp_subtraction(dt_bboxes, dc_bboxes, assigned, ignored_det,
                             ignored_threshold, min_overlap):
    """Devkit DC rule (bbox metric only): an unassigned, unignored detection
    overlapping a DontCare region above min_overlap is absorbed (not a FP).
    Mutates ``assigned``; returns how many detections were absorbed. Shared
    by the native fast path and the Python oracle so the two can never
    diverge."""
    overlaps_dt_dc = image_box_overlap(dt_bboxes, np.asarray(dc_bboxes), 0)
    nstuff = 0
    for i in range(len(dc_bboxes)):
        for j in range(len(dt_bboxes)):
            if (assigned[j] or ignored_det[j] == -1
                    or ignored_det[j] == 1 or ignored_threshold[j]):
                continue
            if overlaps_dt_dc[j, i] > min_overlap:
                assigned[j] = True
                nstuff += 1
    return nstuff


def compute_statistics(overlaps, gt_datas, dt_datas, ignored_gt, ignored_det,
                       dc_bboxes, metric, min_overlap, thresh=0.0,
                       compute_fp=False, compute_aos=False):
    """Greedy per-image matching — dispatches to the native C++ kernel when
    available (the Python loop below is the semantics oracle and fallback)."""
    if native_geometry.available() and len(gt_datas) and len(dt_datas):
        tp, fp, fn, similarity, thresholds, assigned = \
            native_geometry.kitti_compute_statistics(
                overlaps, gt_datas[:, 4], dt_datas[:, 4], dt_datas[:, 5],
                ignored_gt, ignored_det, min_overlap, thresh,
                compute_fp, compute_aos)
        if compute_fp and metric == 0 and len(dc_bboxes) > 0:
            # DontCare FP subtraction (bbox metric only), on the host
            ignored_threshold = dt_datas[:, 5] < thresh
            fp -= _dontcare_fp_subtraction(
                dt_datas[:, :4], dc_bboxes, assigned, ignored_det,
                ignored_threshold, min_overlap)
        return tp, fp, fn, similarity, thresholds
    return _compute_statistics_py(
        overlaps, gt_datas, dt_datas, ignored_gt, ignored_det, dc_bboxes,
        metric, min_overlap, thresh, compute_fp, compute_aos)


def _compute_statistics_py(overlaps, gt_datas, dt_datas, ignored_gt, ignored_det,
                           dc_bboxes, metric, min_overlap, thresh=0.0,
                           compute_fp=False, compute_aos=False):
    """Greedy per-image matching (devkit semantics).

    Args:
        overlaps: (num_dt, num_gt) overlap matrix.
        gt_datas: (num_gt, 5) [x1, y1, x2, y2, alpha].
        dt_datas: (num_dt, 6) [x1, y1, x2, y2, alpha, score].
        ignored_gt/ignored_det: per-box 0 (valid) / 1 (ignored) / -1 (excluded).
        dc_bboxes: (num_dc, 4) DontCare image boxes.
        metric: 0 bbox, 1 bev, 2 3d.
    Returns:
        tp, fp, fn, similarity, thresholds(list of matched det scores)
    """
    det_size = dt_datas.shape[0]
    gt_size = gt_datas.shape[0]
    dt_scores = dt_datas[:, -1]
    dt_alphas = dt_datas[:, 4]
    gt_alphas = gt_datas[:, 4]
    dt_bboxes = dt_datas[:, :4]

    assigned_detection = [False] * det_size
    ignored_threshold = [False] * det_size
    if compute_fp:
        for i in range(det_size):
            if dt_scores[i] < thresh:
                ignored_threshold[i] = True

    tp, fp, fn, similarity = 0, 0, 0, 0.0
    thresholds = []
    delta = []
    for i in range(gt_size):
        if ignored_gt[i] == -1:
            continue
        det_idx = -1
        valid_detection = NO_DETECTION
        max_overlap = 0.0
        assigned_ignored_det = False

        for j in range(det_size):
            if ignored_det[j] == -1 or assigned_detection[j] or ignored_threshold[j]:
                continue
            overlap = overlaps[j, i]
            dt_score = dt_scores[j]
            if (not compute_fp) and overlap > min_overlap and dt_score > valid_detection:
                det_idx = j
                valid_detection = dt_score
            elif (compute_fp and overlap > min_overlap
                  and (overlap > max_overlap or assigned_ignored_det)
                  and ignored_det[j] == 0):
                max_overlap = overlap
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = False
            elif (compute_fp and overlap > min_overlap
                  and valid_detection == NO_DETECTION and ignored_det[j] == 1):
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = True

        if valid_detection == NO_DETECTION and ignored_gt[i] == 0:
            fn += 1
        elif valid_detection != NO_DETECTION and (
                ignored_gt[i] == 1 or ignored_det[det_idx] == 1):
            assigned_detection[det_idx] = True
        elif valid_detection != NO_DETECTION:
            tp += 1
            thresholds.append(dt_scores[det_idx])
            if compute_aos:
                delta.append(gt_alphas[i] - dt_alphas[det_idx])
            assigned_detection[det_idx] = True

    if compute_fp:
        for j in range(det_size):
            if not (assigned_detection[j] or ignored_det[j] == -1
                    or ignored_det[j] == 1 or ignored_threshold[j]):
                fp += 1
        if metric == 0 and len(dc_bboxes) > 0:
            fp -= _dontcare_fp_subtraction(
                dt_bboxes, dc_bboxes, assigned_detection, ignored_det,
                ignored_threshold, min_overlap)
        if compute_aos:
            tmp = [(1.0 + np.cos(d)) / 2.0 for d in delta]
            similarity = float(np.sum(tmp)) if tp > 0 or fp > 0 else -1.0

    return tp, fp, fn, similarity, thresholds


# -------------------------------------------------------------------- wiring

CLASS_NAMES = ['car', 'pedestrian', 'cyclist', 'van', 'person_sitting', 'truck']
MIN_HEIGHT = [40, 25, 25]
MAX_OCCLUSION = [0, 1, 2]
MAX_TRUNCATION = [0.15, 0.3, 0.5]


def clean_data(gt_anno, dt_anno, current_class, difficulty):
    """Per-image validity flags for a (class, difficulty) pair."""
    ignored_gt, ignored_dt, dc_bboxes = [], [], []
    current_cls_name = CLASS_NAMES[current_class].lower()
    num_gt = len(gt_anno['name'])
    num_dt = len(dt_anno['name'])
    num_valid_gt = 0
    for i in range(num_gt):
        bbox = gt_anno['bbox'][i]
        gt_name = gt_anno['name'][i].lower()
        height = bbox[3] - bbox[1]
        if gt_name == current_cls_name:
            valid_class = 1
        elif current_cls_name == 'pedestrian' and gt_name == 'person_sitting':
            valid_class = 0
        elif current_cls_name == 'car' and gt_name == 'van':
            valid_class = 0
        else:
            valid_class = -1
        ignore = (gt_anno['occluded'][i] > MAX_OCCLUSION[difficulty]
                  or gt_anno['truncated'][i] > MAX_TRUNCATION[difficulty]
                  or height <= MIN_HEIGHT[difficulty])
        if valid_class == 1 and not ignore:
            ignored_gt.append(0)
            num_valid_gt += 1
        elif valid_class == 0 or (ignore and valid_class == 1):
            ignored_gt.append(1)
        else:
            ignored_gt.append(-1)
        if gt_anno['name'][i] == 'DontCare':
            dc_bboxes.append(gt_anno['bbox'][i])

    for i in range(num_dt):
        valid_class = 1 if dt_anno['name'][i].lower() == current_cls_name else -1
        height = abs(dt_anno['bbox'][i, 3] - dt_anno['bbox'][i, 1])
        if height < MIN_HEIGHT[difficulty]:
            ignored_dt.append(1)
        elif valid_class == 1:
            ignored_dt.append(0)
        else:
            ignored_dt.append(-1)

    return num_valid_gt, ignored_gt, ignored_dt, dc_bboxes


def calculate_iou_partly(gt_annos, dt_annos, metric):
    """Per-image overlap matrices for the chosen metric."""
    overlaps = []
    for gt_anno, dt_anno in zip(gt_annos, dt_annos):
        if metric == 0:
            gt_boxes = gt_anno['bbox']
            dt_boxes = dt_anno['bbox']
            ov = image_box_overlap(dt_boxes, gt_boxes) if len(dt_boxes) and len(gt_boxes) \
                else np.zeros((len(dt_boxes), len(gt_boxes)))
        elif metric == 1:
            loc_g = gt_anno['location']
            dims_g = gt_anno['dimensions']
            rots_g = gt_anno['rotation_y']
            loc_d = dt_anno['location']
            dims_d = dt_anno['dimensions']
            rots_d = dt_anno['rotation_y']
            gt_boxes = np.concatenate(
                [loc_g[:, [0, 2]], dims_g[:, [0, 2]], rots_g[..., None]], axis=1) \
                if len(rots_g) else np.zeros((0, 5))
            dt_boxes = np.concatenate(
                [loc_d[:, [0, 2]], dims_d[:, [0, 2]], rots_d[..., None]], axis=1) \
                if len(rots_d) else np.zeros((0, 5))
            ov = bev_box_overlap(dt_boxes, gt_boxes) if len(dt_boxes) and len(gt_boxes) \
                else np.zeros((len(dt_boxes), len(gt_boxes)))
        else:
            gt_boxes = np.concatenate(
                [gt_anno['location'], gt_anno['dimensions'],
                 gt_anno['rotation_y'][..., None]], axis=1) \
                if len(gt_anno['rotation_y']) else np.zeros((0, 7))
            dt_boxes = np.concatenate(
                [dt_anno['location'], dt_anno['dimensions'],
                 dt_anno['rotation_y'][..., None]], axis=1) \
                if len(dt_anno['rotation_y']) else np.zeros((0, 7))
            ov = d3_box_overlap(dt_boxes, gt_boxes) if len(dt_boxes) and len(gt_boxes) \
                else np.zeros((len(dt_boxes), len(gt_boxes)))
        overlaps.append(ov)
    return overlaps


def eval_class(gt_annos, dt_annos, current_classes, difficultys, metric,
               min_overlaps, compute_aos=False, num_parts=50):
    """Core evaluation over (class, difficulty, overlap-threshold) matrix.

    Returns dict with precision (C, D, K, 41), aos, recall.
    """
    assert len(gt_annos) == len(dt_annos)
    num_examples = len(gt_annos)
    overlaps = calculate_iou_partly(gt_annos, dt_annos, metric)
    n_sample_pts = 41

    num_minoverlap = len(min_overlaps)
    num_class = len(current_classes)
    num_difficulty = len(difficultys)
    precision = np.zeros([num_class, num_difficulty, num_minoverlap, n_sample_pts])
    recall = np.zeros([num_class, num_difficulty, num_minoverlap, n_sample_pts])
    aos = np.zeros([num_class, num_difficulty, num_minoverlap, n_sample_pts])

    for m, current_class in enumerate(current_classes):
        for l, difficulty in enumerate(difficultys):
            rets = [clean_data(gt_annos[i], dt_annos[i], current_class, difficulty)
                    for i in range(num_examples)]
            total_num_valid_gt = sum(r[0] for r in rets)
            for k in range(num_minoverlap):
                min_overlap = min_overlaps[k, metric, m]
                thresholdss = []
                for i in range(num_examples):
                    num_valid_gt, ignored_gt, ignored_det, dc_bboxes = rets[i]
                    gt_datas = np.concatenate(
                        [gt_annos[i]['bbox'],
                         gt_annos[i]['alpha'][..., None]], axis=1) \
                        if len(gt_annos[i]['alpha']) else np.zeros((0, 5))
                    dt_datas = np.concatenate(
                        [dt_annos[i]['bbox'],
                         dt_annos[i]['alpha'][..., None],
                         dt_annos[i]['score'][..., None]], axis=1) \
                        if len(dt_annos[i]['alpha']) else np.zeros((0, 6))
                    *_, th = compute_statistics(
                        overlaps[i], gt_datas, dt_datas, ignored_gt, ignored_det,
                        dc_bboxes, metric, min_overlap=min_overlap,
                        thresh=0.0, compute_fp=False)
                    thresholdss += th
                thresholds = np.array(get_thresholds(
                    np.array(thresholdss), total_num_valid_gt))

                pr = np.zeros([len(thresholds), 4])
                for i in range(num_examples):
                    num_valid_gt, ignored_gt, ignored_det, dc_bboxes = rets[i]
                    gt_datas = np.concatenate(
                        [gt_annos[i]['bbox'],
                         gt_annos[i]['alpha'][..., None]], axis=1) \
                        if len(gt_annos[i]['alpha']) else np.zeros((0, 5))
                    dt_datas = np.concatenate(
                        [dt_annos[i]['bbox'],
                         dt_annos[i]['alpha'][..., None],
                         dt_annos[i]['score'][..., None]], axis=1) \
                        if len(dt_annos[i]['alpha']) else np.zeros((0, 6))
                    for t, thresh in enumerate(thresholds):
                        tp, fp, fn, similarity, _ = compute_statistics(
                            overlaps[i], gt_datas, dt_datas, ignored_gt,
                            ignored_det, dc_bboxes, metric,
                            min_overlap=min_overlap, thresh=thresh,
                            compute_fp=True, compute_aos=compute_aos)
                        pr[t, 0] += tp
                        pr[t, 1] += fp
                        pr[t, 2] += fn
                        if similarity != -1:
                            pr[t, 3] += similarity

                for t in range(len(thresholds)):
                    recall[m, l, k, t] = pr[t, 0] / (pr[t, 0] + pr[t, 2])
                    precision[m, l, k, t] = pr[t, 0] / (pr[t, 0] + pr[t, 1])
                    if compute_aos:
                        aos[m, l, k, t] = pr[t, 3] / (pr[t, 0] + pr[t, 1])
                # precision envelope: max to the right (the devkit envelopes
                # precision and aos ONLY — recall stays the raw curve)
                for t in range(len(thresholds)):
                    precision[m, l, k, t] = np.max(precision[m, l, k, t:], axis=-1)
                    if compute_aos:
                        aos[m, l, k, t] = np.max(aos[m, l, k, t:], axis=-1)

    return {'recall': recall, 'precision': precision, 'orientation': aos}


def get_mAP(prec):
    """41-point AP (samples 0, 4, 8, ... / 4-spaced)."""
    sums = 0
    for i in range(0, prec.shape[-1], 4):
        sums = sums + prec[..., i]
    return sums / 11 * 100


def get_mAP_R40(prec):
    """40-recall-point AP (samples 1..40)."""
    sums = 0
    for i in range(1, prec.shape[-1]):
        sums = sums + prec[..., i]
    return sums / 40 * 100


def do_eval(gt_annos, dt_annos, current_classes, min_overlaps, compute_aos=False):
    difficultys = [0, 1, 2]
    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 0,
                     min_overlaps, compute_aos)
    mAP_bbox = get_mAP(ret['precision'])
    mAP_bbox_R40 = get_mAP_R40(ret['precision'])
    mAP_aos = mAP_aos_R40 = None
    if compute_aos:
        mAP_aos = get_mAP(ret['orientation'])
        mAP_aos_R40 = get_mAP_R40(ret['orientation'])

    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 1,
                     min_overlaps)
    mAP_bev = get_mAP(ret['precision'])
    mAP_bev_R40 = get_mAP_R40(ret['precision'])

    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 2,
                     min_overlaps)
    mAP_3d = get_mAP(ret['precision'])
    mAP_3d_R40 = get_mAP_R40(ret['precision'])
    return (mAP_bbox, mAP_bev, mAP_3d, mAP_aos,
            mAP_bbox_R40, mAP_bev_R40, mAP_3d_R40, mAP_aos_R40)


def get_official_eval_result(gt_annos, dt_annos, current_classes):
    """Full result string + scalar dict (reference eval.py:639-744 parity)."""
    overlap_0_7 = np.array([[0.7, 0.5, 0.5, 0.7, 0.5, 0.7],
                            [0.7, 0.5, 0.5, 0.7, 0.5, 0.7],
                            [0.7, 0.5, 0.5, 0.7, 0.5, 0.7]])
    overlap_0_5 = np.array([[0.7, 0.5, 0.5, 0.7, 0.5, 0.5],
                            [0.5, 0.25, 0.25, 0.5, 0.25, 0.5],
                            [0.5, 0.25, 0.25, 0.5, 0.25, 0.5]])
    min_overlaps = np.stack([overlap_0_7, overlap_0_5], axis=0)  # (2, 3, 6)

    name_to_class = {v: i for i, v in enumerate(CLASS_NAMES)}
    if not isinstance(current_classes, (list, tuple)):
        current_classes = [current_classes]
    current_classes_int = []
    for curcls in current_classes:
        if isinstance(curcls, str):
            current_classes_int.append(name_to_class[curcls.lower()])
        else:
            current_classes_int.append(curcls)
    current_classes = current_classes_int
    min_overlaps = min_overlaps[:, :, current_classes]

    result = ''
    compute_aos = False
    for anno in dt_annos:
        if anno['alpha'].shape[0] != 0:
            if anno['alpha'][0] != -10:
                compute_aos = True
            break

    (mAPbbox, mAPbev, mAP3d, mAPaos, mAPbbox_R40, mAPbev_R40,
     mAP3d_R40, mAPaos_R40) = do_eval(
        gt_annos, dt_annos, current_classes, min_overlaps, compute_aos)

    ret_dict = {}
    difficulty_names = ['easy', 'moderate', 'hard']
    for j, curcls in enumerate(current_classes):
        cls_name = CLASS_NAMES[curcls].capitalize()
        for i in range(min_overlaps.shape[0]):
            result += ('%s AP@%.2f, %.2f, %.2f:\n'
                       % (cls_name, *min_overlaps[i, :, j]))
            result += ('bbox AP:%.4f, %.4f, %.4f\n' % tuple(mAPbbox[j, :, i]))
            result += ('bev  AP:%.4f, %.4f, %.4f\n' % tuple(mAPbev[j, :, i]))
            result += ('3d   AP:%.4f, %.4f, %.4f\n' % tuple(mAP3d[j, :, i]))
            if compute_aos:
                result += ('aos  AP:%.2f, %.2f, %.2f\n' % tuple(mAPaos[j, :, i]))
            result += ('%s AP_R40@%.2f, %.2f, %.2f:\n'
                       % (cls_name, *min_overlaps[i, :, j]))
            result += ('bbox AP:%.4f, %.4f, %.4f\n' % tuple(mAPbbox_R40[j, :, i]))
            result += ('bev  AP:%.4f, %.4f, %.4f\n' % tuple(mAPbev_R40[j, :, i]))
            result += ('3d   AP:%.4f, %.4f, %.4f\n' % tuple(mAP3d_R40[j, :, i]))
            if compute_aos:
                result += ('aos  AP:%.2f, %.2f, %.2f\n' % tuple(mAPaos_R40[j, :, i]))

            if i == 0:
                for d in range(3):
                    ret_dict[f'{cls_name}_3d/{difficulty_names[d]}'] = mAP3d[j, d, 0]
                    ret_dict[f'{cls_name}_3d/{difficulty_names[d]}_R40'] = mAP3d_R40[j, d, 0]
                    ret_dict[f'{cls_name}_bev/{difficulty_names[d]}'] = mAPbev[j, d, 0]
                    ret_dict[f'{cls_name}_bev/{difficulty_names[d]}_R40'] = mAPbev_R40[j, d, 0]
                    ret_dict[f'{cls_name}_image/{difficulty_names[d]}'] = mAPbbox[j, d, 0]
                    ret_dict[f'{cls_name}_image/{difficulty_names[d]}_R40'] = mAPbbox_R40[j, d, 0]
                    if compute_aos:
                        ret_dict[f'{cls_name}_aos/{difficulty_names[d]}'] = mAPaos[j, d, 0]
                        ret_dict[f'{cls_name}_aos/{difficulty_names[d]}_R40'] = mAPaos_R40[j, d, 0]

    return result, ret_dict
