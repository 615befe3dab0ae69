"""nuScenes dataset: multi-sweep lidar, balanced resampling, predictions,
devkit-free evaluation.

The port's copy of ``hvpr_tpu/datasets/nuscenes/nuscenes_dataset.py``:

- pickled info lists per split (``nuscenes_infos_<N>sweeps_<split>.pkl``),
  schema on :meth:`NuScenesDataset.include_nuscenes_data`;
- multi-sweep points: past sweeps moved into the reference frame by their
  stored 4x4 transforms (ego-motion compensation) and tagged with their
  time lag, the fifth point channel; points within 1 m of the sensor in x
  and y (the ego vehicle) are dropped from every sweep;
- class-balanced resampling of the infos in training
  (``BALANCED_RESAMPLING``);
- predictions as annos with the sample token, and the nuScenes submission
  rows (global-frame translation, size, yaw quaternion), which
  ``--save_to_file`` writes one ``<token>.json`` a frame;
- evaluation: the official devkit evaluator when the ``nuscenes`` package
  is installed, otherwise an in-tree AP under the official matching rule
  (BEV centre distance within 0.5, 1, 2 and 4 m), with the JAX package's
  result string.

:func:`create_nuscenes_infos` needs the devkit and raises without it;
everything else runs from the pickles alone
(:func:`hvpr_tpu_torch.utils.scans.build_nuscenes_root` writes a synthetic
tree with its pickles).
"""

import json
import pickle
from pathlib import Path

import numpy as np

from ..dataset import DatasetTemplate


def _yaw_to_quaternion(yaw):
    """(w, x, y, z) quaternion for a rotation of ``yaw`` around +z."""
    return [float(np.cos(yaw / 2.0)), 0.0, 0.0, float(np.sin(yaw / 2.0))]


def transform_points(points_xyz, tm):
    """Apply a 4x4 homogeneous transform to (N, 3) points."""
    return points_xyz @ tm[:3, :3].T + tm[:3, 3]


def boxes_lidar_to_global(boxes7, ref_to_global):
    """(N, 7) lidar-frame boxes moved by a 4x4 lidar -> global matrix; the
    heading advances by the transform's yaw."""
    boxes7 = np.asarray(boxes7, np.float32).reshape(-1, 7)
    centers = transform_points(boxes7[:, :3], ref_to_global)
    yaw_tm = np.arctan2(ref_to_global[1, 0], ref_to_global[0, 0])
    out = boxes7.copy()
    out[:, :3] = centers
    out[:, 6] = boxes7[:, 6] + yaw_tm
    return out


class NuScenesDataset(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training=True, root_path=None,
                 logger=None):
        root_path = (Path(root_path) if root_path is not None
                     else Path(dataset_cfg['DATA_PATH'])) / \
            dataset_cfg.get('VERSION', 'v1.0-trainval')
        super().__init__(dataset_cfg=dataset_cfg, class_names=class_names,
                         training=training, root_path=root_path, logger=logger)
        self.infos = []
        self.include_nuscenes_data(self.mode)
        if self.training and self.dataset_cfg.get('BALANCED_RESAMPLING', False):
            self.infos = self.balanced_infos_resampling(self.infos)

    # ------------------------------------------------------------------ infos

    def include_nuscenes_data(self, mode):
        """Load the pickled info lists of ``mode``.

        Info schema (one dict a sample):
          lidar_path      str, relative to the version root
          token           str, nuScenes sample token
          timestamp       float, seconds
          ref_to_global   (4, 4) float, lidar -> global (identity if absent)
          sweeps          list of {lidar_path, transform_matrix (4, 4),
                          time_lag (s)} of the preceding sweeps, newest first
          gt_boxes        (N, 7[+2]) float lidar-frame boxes (+ velocity)
          gt_names        (N,) str
          num_lidar_pts   (N,) int (optional; the min-points filter)
        """
        if self.logger is not None:
            self.logger.info('Loading NuScenes dataset')
        loaded = []
        for name in self.dataset_cfg['INFO_PATH'][mode]:
            path = self.root_path / name
            if not path.exists():
                continue
            with open(path, 'rb') as f:
                loaded.extend(pickle.load(f))
        self.infos.extend(loaded)
        if self.logger is not None:
            self.logger.info('Total samples for NuScenes dataset: %d', len(loaded))

    def balanced_infos_resampling(self, infos):
        """Each class an equal share of the infos: every info is listed
        under each class it holds, and each list is drawn with replacement
        (numpy's global RNG) to ``len(listed) / num_classes`` entries."""
        if self.class_names is None:
            return infos
        cls_infos = {name: [] for name in self.class_names}
        for info in infos:
            for name in set(info['gt_names']) & set(self.class_names):
                cls_infos[name].append(info)

        duplicated_samples = sum(len(v) for v in cls_infos.values())
        if duplicated_samples == 0:
            return infos
        frac = 1.0 / len(self.class_names)
        sampled_infos = []
        for infos_of_cls in cls_infos.values():
            if len(infos_of_cls) == 0:
                continue
            ratio = frac * duplicated_samples / len(infos_of_cls)
            target = int(len(infos_of_cls) * ratio)
            idx = np.random.choice(len(infos_of_cls), target, replace=True)
            sampled_infos.extend([infos_of_cls[i] for i in idx])
        if self.logger is not None:
            self.logger.info('Total samples after balanced resampling: %d',
                             len(sampled_infos))
        return sampled_infos

    # ------------------------------------------------------------------ points

    @staticmethod
    def _load_points(lidar_file):
        """A raw nuScenes ``.bin``: (N, 5) float32 rows [x y z intensity
        ring] -> the first four."""
        return np.fromfile(str(lidar_file), dtype=np.float32).reshape(-1, 5)[:, :4]

    @staticmethod
    def remove_ego_points(points, center_radius=1.0):
        mask = ~((np.abs(points[:, 0]) < center_radius)
                 & (np.abs(points[:, 1]) < center_radius))
        return points[mask]

    def get_sweep(self, sweep_info):
        """One past sweep in the reference frame, and its time lags."""
        points = self.remove_ego_points(
            self._load_points(self.root_path / sweep_info['lidar_path']))
        tm = np.asarray(sweep_info['transform_matrix'], np.float32)
        points[:, :3] = transform_points(points[:, :3], tm)
        times = sweep_info['time_lag'] * np.ones((points.shape[0], 1), np.float32)
        return points, times

    def get_lidar_with_sweeps(self, index, max_sweeps=1):
        """The reference sweep and up to ``max_sweeps - 1`` past ones, as
        (N, 5) [x y z intensity time_lag] (the reference sweep's lag is 0).
        Training draws which past sweeps (numpy's global RNG); evaluation
        takes the newest."""
        info = self.infos[index]
        points = self.remove_ego_points(
            self._load_points(self.root_path / info['lidar_path']))
        sweep_points = [points]
        sweep_times = [np.zeros((points.shape[0], 1), np.float32)]

        sweeps = info.get('sweeps', [])
        k = min(max_sweeps - 1, len(sweeps))
        if k > 0:
            chosen = (np.random.choice(len(sweeps), k, replace=False)
                      if self.training else np.arange(k))
            for i in chosen:
                pts, times = self.get_sweep(sweeps[i])
                sweep_points.append(pts)
                sweep_times.append(times)
        return np.concatenate([np.concatenate(sweep_points, axis=0),
                               np.concatenate(sweep_times, axis=0)],
                              axis=1).astype(np.float32)

    # ------------------------------------------------------------------ items

    def __len__(self):
        n = len(self.infos)
        return n * self.total_epochs if self._merge_all_iters_to_one_epoch else n

    def __getitem__(self, index):
        if self._merge_all_iters_to_one_epoch:
            index = index % len(self.infos)
        if self.item_seed is not None:
            np.random.seed(self.item_seed + index)
        info = self.infos[index]
        points = self.get_lidar_with_sweeps(
            index, max_sweeps=int(self.dataset_cfg.get('MAX_SWEEPS', 1)))
        input_dict = {
            'points': points,
            'frame_id': Path(info['lidar_path']).stem,
            'metadata': {'token': info['token']},
        }
        if 'gt_boxes' in info:
            gt_boxes = np.asarray(info['gt_boxes'], np.float32)
            gt_names = np.asarray(info['gt_names'])
            min_pts = self.dataset_cfg.get('FILTER_MIN_POINTS_IN_GT', 0)
            if min_pts > 0 and 'num_lidar_pts' in info:
                keep = np.asarray(info['num_lidar_pts']) >= min_pts
                gt_boxes, gt_names = gt_boxes[keep], gt_names[keep]
            input_dict['gt_boxes'] = gt_boxes[:, :7]
            input_dict['gt_names'] = gt_names
        return self.prepare_data(data_dict=input_dict)

    # ------------------------------------------------------------- prediction

    def generate_prediction_dicts(self, batch_dict, pred_dicts, class_names,
                                  output_path=None):
        """Per-frame annos (``name``, ``score``, ``boxes_lidar``,
        ``pred_labels``, ``metadata`` with the sample token); with
        ``output_path`` each frame's submission rows as ``<token>.json``."""
        annos = []
        meta = batch_dict.get('metadata')
        for index, box_dict in enumerate(pred_dicts):
            labels = np.asarray(box_dict['pred_labels'])
            anno = {
                'name': (np.array([class_names[int(l) - 1] for l in labels])
                         if len(labels) else np.zeros(0, dtype='<U32')),
                'score': np.asarray(box_dict['pred_scores']),
                'boxes_lidar': np.asarray(box_dict['pred_boxes']),
                'pred_labels': labels,
            }
            if meta is not None:
                anno['metadata'] = meta[index]
            annos.append(anno)
        if output_path is not None:
            self.write_prediction_files(annos, output_path)
        return annos

    def write_prediction_files(self, annos, output_path):
        """One ``<token>.json`` of submission rows a frame of ``annos``."""
        for token, frame in self.annos_to_nusc_results(annos).items():
            with open(Path(output_path) / f'{token}.json', 'w') as f:
                json.dump(frame, f)

    def annos_to_nusc_results(self, det_annos):
        """Annos -> the submission's ``results`` map: token -> rows of
        {translation, size, rotation, velocity, detection_name,
        detection_score, attribute_name}, boxes in the global frame by the
        info's lidar -> global transform."""
        tm_by_token = getattr(self, '_tm_by_token', None)
        if tm_by_token is None:     # built once, not once a batch
            tm_by_token = self._tm_by_token = {
                info['token']: np.asarray(info.get('ref_to_global', np.eye(4)), np.float32)
                for info in self.infos}
        results = {}
        for anno in det_annos:
            token = anno.get('metadata', {}).get('token')
            if token is None:
                continue
            tm = tm_by_token.get(token, np.eye(4, dtype=np.float32))
            boxes_global = boxes_lidar_to_global(anno['boxes_lidar'][:, :7], tm)
            results[token] = [{
                'sample_token': token,
                'translation': b[:3].tolist(),
                # nuScenes size order is (w, l, h); lidar boxes are (l, w, h)
                'size': [float(b[4]), float(b[3]), float(b[5])],
                'rotation': _yaw_to_quaternion(float(b[6])),
                'velocity': [0.0, 0.0],
                'detection_name': str(anno['name'][i]),
                'detection_score': float(anno['score'][i]),
                'attribute_name': '',
            } for i, b in enumerate(boxes_global)]
        return results

    # ------------------------------------------------------------- evaluation

    def evaluation(self, det_annos, class_names, eval_metric='nuscenes', **kwargs):
        if eval_metric not in (None, 'nuscenes'):
            raise ValueError(f'NuScenesDataset evaluates EVAL_METRIC nuscenes, '
                             f'not {eval_metric!r}')
        try:
            import nuscenes  # noqa: F401
        except ImportError:
            result_str, result_dict = self._evaluation_center_distance(
                det_annos, class_names)
            return ('nuscenes-devkit not installed: reporting in-tree '
                    'center-distance AP (official matching rule, '
                    'AP-only)\n' + result_str), result_dict
        return self._evaluation_devkit(det_annos, class_names)

    def _evaluation_devkit(self, det_annos, class_names):
        """The official evaluator (the devkit and the raw dataset)."""
        import tempfile
        from nuscenes import NuScenes
        from nuscenes.eval.detection.config import config_factory
        from nuscenes.eval.detection.evaluate import NuScenesEval

        nusc = NuScenes(version=self.dataset_cfg['VERSION'],
                        dataroot=str(self.root_path), verbose=False)
        results = {
            'results': self.annos_to_nusc_results(det_annos),
            'meta': {'use_camera': False, 'use_lidar': True, 'use_radar': False,
                     'use_map': False, 'use_external': False},
        }
        with tempfile.TemporaryDirectory() as tmpdir:
            res_path = Path(tmpdir) / 'results_nusc.json'
            with open(res_path, 'w') as f:
                json.dump(results, f)
            eval_set = {'v1.0-trainval': 'val', 'v1.0-mini': 'mini_val',
                        'v1.0-test': 'test'}[self.dataset_cfg['VERSION']]
            nusc_eval = NuScenesEval(
                nusc, config=config_factory('detection_cvpr_2019'),
                result_path=str(res_path), eval_set=eval_set,
                output_dir=tmpdir, verbose=False)
            metrics = nusc_eval.main(plot_examples=0, render_curves=False)
        result_dict = {f'{k}/mAP': v for k, v in metrics['mean_dist_aps'].items()}
        result_dict['NDS'] = metrics['nd_score']
        return '\n'.join(f'{k}: {v:.4f}' for k, v in result_dict.items()), result_dict

    def _evaluation_center_distance(self, det_annos, class_names,
                                    dist_thresholds=(0.5, 1.0, 2.0, 4.0)):
        """Devkit-free AP under the official matching rule: a detection
        claims the nearest unclaimed same-class gt within the BEV centre
        distance threshold, in score order; AP is the mean over recall
        0.11-1.0 of the 101-point interpolated precision less 0.1, over
        0.9 (the devkit's clipping), averaged over the four thresholds."""
        gt_by_token = {
            info['token']: (np.asarray(info.get('gt_boxes', np.zeros((0, 7))), np.float32),
                            np.asarray(info.get('gt_names', np.zeros(0, dtype='<U32'))))
            for info in self.infos}
        no_gt = (np.zeros((0, 7), np.float32), np.zeros(0, dtype='<U32'))

        result_dict = {}
        for cls in class_names:
            aps = []
            for thr in dist_thresholds:
                scores, matched, n_gt = [], [], 0
                for anno in det_annos:
                    gt_boxes, gt_names = gt_by_token.get(
                        anno.get('metadata', {}).get('token'), no_gt)
                    gt_sel = gt_boxes[gt_names == cls]
                    n_gt += len(gt_sel)
                    det_mask = anno['name'] == cls
                    det_boxes = anno['boxes_lidar'][det_mask]
                    det_scores = anno['score'][det_mask]
                    claimed = np.zeros(len(gt_sel), bool)
                    for di in np.argsort(-det_scores):
                        scores.append(det_scores[di])
                        if len(gt_sel) == 0:
                            matched.append(False)
                            continue
                        d = np.linalg.norm(gt_sel[:, :2] - det_boxes[di, :2], axis=1)
                        d = np.where(claimed, np.inf, d)
                        j = int(np.argmin(d))
                        hit = bool(d[j] <= thr)
                        claimed[j] |= hit
                        matched.append(hit)
                if n_gt == 0 or len(scores) == 0:
                    aps.append(0.0)
                    continue
                matched_sorted = np.asarray(matched)[np.argsort(-np.asarray(scores))]
                tp = np.cumsum(matched_sorted)
                fp = np.cumsum(~matched_sorted)
                recall = tp / n_gt
                precision = tp / np.maximum(tp + fp, 1)
                # the devkit averages the 101-point curve from index 11 on
                # (the recall 0.1 point itself excluded)
                prec_interp = np.interp(np.linspace(0, 1, 101), recall, precision,
                                        right=0.0)
                aps.append(float(np.mean(np.maximum(prec_interp[11:] - 0.1, 0.0) / 0.9)))
            result_dict[f'{cls}/mAP'] = float(np.mean(aps))
        result_dict['mAP'] = (float(np.mean(list(result_dict.values())))
                              if result_dict else 0.0)
        return '\n'.join(f'{k}: {v:.4f}' for k, v in result_dict.items()), result_dict


def create_nuscenes_infos(version, data_path, save_path, max_sweeps=10):
    """Offline info builder over a raw nuScenes database. It walks the
    database with the devkit and raises without it; the walk itself
    (``fill_infos`` in the JAX package) is not ported."""
    try:
        import nuscenes  # noqa: F401
    except ImportError as e:
        raise ImportError(
            'create_nuscenes_infos requires the nuscenes devkit '
            '(pip install nuscenes-devkit); the runtime dataset only needs '
            'the pickles it produces.') from e
    raise NotImplementedError(
        'the devkit walk that builds the info pickles (fill_infos) is not ported; '
        'hvpr_tpu_torch.utils.scans.build_nuscenes_root writes pickles of the same '
        'schema for a synthetic tree')
