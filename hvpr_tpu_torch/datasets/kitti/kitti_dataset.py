"""KITTI dataset (train and test mode) and prediction export.

The port's copy of ``hvpr_tpu/datasets/kitti/kitti_dataset.py``:
info-pickle loading, ``__getitem__`` (under ``merge_all_iters_to_one_epoch``
over ``total_epochs`` passes of the infos), lidar -> camera prediction
export (vectorized per sample), official-AP evaluation and the offline
writer ``create_kitti_infos`` of the info pickles and the train split's gt
database. Raw-file IO, info building and the gt database live in
:mod:`.kitti_io`. Pickle schemas are those of the reference's
``kitti_infos_*.pkl`` and ``kitti_dbinfos_*.pkl``. Write the infos and the
gt database of a KITTI tree with

    python -m hvpr_tpu_torch.datasets.kitti.kitti_dataset create_kitti_infos [DATA_PATH]

(``DATA_PATH`` defaults to ``data/kitti`` under the repository root).
"""

import copy
import pickle
from pathlib import Path

import numpy as np

from ...native import geometry as native_geometry
from ...utils import box_utils, common_utils
from ..dataset import DatasetTemplate
from . import kitti_io
from .kitti_object_eval_python import eval as kitti_eval

# KITTI detection txt row: name, trunc, occ, alpha, bbox x4, h w l, xyz, ry, score
_KITTI_ROW = ('%s -1 -1 %.4f %.4f %.4f %.4f %.4f %.4f %.4f %.4f '
              '%.4f %.4f %.4f %.4f %.4f')


class KittiDataset(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training=True, root_path=None,
                 logger=None):
        super().__init__(dataset_cfg=dataset_cfg, class_names=class_names,
                         training=training, root_path=root_path, logger=logger)
        self.kitti_infos = []
        self.set_split(self.dataset_cfg['DATA_SPLIT'][self.mode])
        self._load_infos(self.dataset_cfg['INFO_PATH'][self.mode])

    def set_split(self, split):
        """Point the raw-IO handle at a split; infos are loaded separately."""
        self.split = split
        self.io = kitti_io.KittiSplitIO(self.root_path, split)
        self.sample_id_list = self.io.frame_ids

    def _load_infos(self, info_files):
        if self.logger is not None:
            self.logger.info('Loading KITTI dataset')
        count = 0
        for name in info_files:
            path = self.root_path / name
            if not path.exists():
                continue
            with open(path, 'rb') as f:
                loaded = pickle.load(f)
            self.kitti_infos.extend(loaded)
            count += len(loaded)
        if self.logger is not None:
            self.logger.info('Total samples for KITTI dataset: %d', count)

    # -- raw-IO passthroughs (reference public API surface) ----------------
    def get_lidar(self, idx):
        return self.io.lidar(idx)

    def get_calib(self, idx):
        return self.io.calib(idx)

    def get_road_plane(self, idx):
        return self.io.road_plane(idx)

    def get_infos(self, num_workers=4, has_label=True, count_inside_pts=True,
                  sample_id_list=None):
        return kitti_io.build_split_infos(
            self.io, workers=num_workers, has_label=has_label,
            count_inside_pts=count_inside_pts, frame_ids=sample_id_list)

    def create_groundtruth_database(self, info_path=None, used_classes=None,
                                    split='train'):
        kitti_io.create_gt_database(
            self.io, info_path, Path(self.root_path),
            used_classes=used_classes, split=split)

    # -- sample pipeline ----------------------------------------------------
    def __len__(self):
        n = len(self.kitti_infos)
        return n * self.total_epochs if self._merge_all_iters_to_one_epoch else n

    def __getitem__(self, index):
        if self._merge_all_iters_to_one_epoch:
            index = index % len(self.kitti_infos)
        if self.item_seed is not None:
            np.random.seed(self.item_seed + index)
        info = self.kitti_infos[index]
        fid = info['point_cloud']['lidar_idx']
        img_shape = info['image']['image_shape']

        points = self.io.lidar(fid)
        calib = self.io.calib(fid)
        if self.dataset_cfg.get('FOV_POINTS_ONLY', False):
            points = points[kitti_io.fov_point_mask(
                points[:, :3], calib, img_shape)]

        input_dict = {'points': points, 'frame_id': fid, 'calib': calib,
                      'image_shape': img_shape}
        if 'annos' in info:
            annos = common_utils.drop_info_with_name(info['annos'], 'DontCare')
            input_dict['gt_names'] = annos['name']
            input_dict['gt_boxes'] = annos['gt_boxes_lidar']
            plane = self.io.road_plane(fid)
            if plane is not None:
                input_dict['road_plane'] = plane

        data_dict = self.prepare_data(data_dict=input_dict)
        # prepare_data strips host-only keys; eval export needs them back.
        data_dict.update(frame_id=fid, image_shape=img_shape, calib=calib)
        return data_dict

    # -- prediction export / metric ------------------------------------------
    @staticmethod
    def generate_prediction_dicts(batch_dict, pred_dicts, class_names,
                                  output_path=None):
        """Per-sample device outputs -> KITTI anno dicts (+ optional txt).

        Args:
            batch_dict: host metadata lists: 'frame_id', 'calib', 'image_shape'.
            pred_dicts: per-sample dicts of compacted numpy pred_boxes (N, 7)
                lidar frame / pred_scores (N,) / pred_labels (N,) 1-based.
        Returns:
            list of KITTI-anno dicts (camera-frame), one per sample.
        """
        annos = []
        for i, box_dict in enumerate(pred_dicts):
            anno = _predictions_to_kitti_anno(
                np.asarray(box_dict['pred_boxes']),
                np.asarray(box_dict['pred_scores']),
                np.asarray(box_dict['pred_labels']),
                batch_dict['calib'][i], batch_dict['image_shape'][i],
                class_names)
            anno['frame_id'] = batch_dict['frame_id'][i]
            annos.append(anno)
        if output_path is not None:
            KittiDataset.write_prediction_files(annos, output_path)
        return annos

    @staticmethod
    def write_prediction_files(annos, output_path):
        """One KITTI label ``.txt`` a scene of ``annos`` under ``output_path``."""
        for anno in annos:
            _write_kitti_txt(Path(output_path) / f"{anno['frame_id']}.txt", anno)

    def evaluation(self, det_annos, class_names, eval_metric='kitti', **kwargs):
        if eval_metric not in (None, 'kitti'):
            raise ValueError(f'KittiDataset evaluates EVAL_METRIC kitti, not {eval_metric!r}')
        if 'annos' not in self.kitti_infos[0]:
            return None, {}
        if self.logger is not None:
            self.logger.info('KITTI evaluator: rotated IoU and matching %s',
                             'in the native C++ library' if native_geometry.available()
                             else 'on numpy (the native library did not build)')
        gt_annos = [copy.deepcopy(info['annos']) for info in self.kitti_infos]
        return kitti_eval.get_official_eval_result(
            gt_annos, copy.deepcopy(det_annos), class_names)


def _predictions_to_kitti_anno(boxes_lidar, scores, labels, calib, image_shape,
                               class_names):
    """Vectorized lidar->camera-frame conversion of one sample's detections."""
    n = scores.shape[0]
    anno = {
        'name': np.zeros(n), 'truncated': np.zeros(n), 'occluded': np.zeros(n),
        'alpha': np.zeros(n), 'bbox': np.zeros([n, 4]),
        'dimensions': np.zeros([n, 3]), 'location': np.zeros([n, 3]),
        'rotation_y': np.zeros(n), 'score': np.zeros(n),
        'boxes_lidar': np.zeros([n, 7]),
    }
    if n == 0:
        return anno
    boxes_cam = box_utils.boxes3d_lidar_to_kitti_camera(boxes_lidar, calib)
    anno.update(
        name=np.asarray(class_names)[labels - 1],
        alpha=-np.arctan2(-boxes_lidar[:, 1], boxes_lidar[:, 0]) + boxes_cam[:, 6],
        bbox=box_utils.boxes3d_kitti_camera_to_imageboxes(
            boxes_cam, calib, image_shape=image_shape),
        dimensions=boxes_cam[:, 3:6],
        location=boxes_cam[:, 0:3],
        rotation_y=boxes_cam[:, 6],
        score=scores,
        boxes_lidar=boxes_lidar,
    )
    return anno


def _write_kitti_txt(path, anno):
    dims_hwl = anno['dimensions'][:, [1, 2, 0]]
    rows = [
        _KITTI_ROW % (anno['name'][i], anno['alpha'][i], *anno['bbox'][i],
                      *dims_hwl[i], *anno['location'][i],
                      anno['rotation_y'][i], anno['score'][i])
        for i in range(len(anno['score']))
    ]
    path.write_text('\n'.join(rows) + ('\n' if rows else ''))


def create_kitti_infos(data_path, save_path, workers=4):
    """Write ``kitti_infos_{train,val,test}.pkl`` (each split whose
    ImageSets file exists) and ``kitti_infos_trainval.pkl`` under
    ``save_path``, then the train split's gt database (``gt_database/`` and
    ``kitti_dbinfos_train.pkl``) when there is a train split. Returns the
    infos by split."""
    data_path, save_path = Path(data_path), Path(save_path)
    infos_by_split = {}
    for split, has_label in (('train', True), ('val', True), ('test', False)):
        io = kitti_io.KittiSplitIO(data_path, split)
        if io.frame_ids is None:
            continue
        infos_by_split[split] = kitti_io.build_split_infos(
            io, workers=workers, has_label=has_label,
            count_inside_pts=has_label)
        out = save_path / f'kitti_infos_{split}.pkl'
        with open(out, 'wb') as f:
            pickle.dump(infos_by_split[split], f)
        print(f'Kitti info {split} file is saved to {out}')

    if 'train' in infos_by_split and 'val' in infos_by_split:
        with open(save_path / 'kitti_infos_trainval.pkl', 'wb') as f:
            pickle.dump(infos_by_split['train'] + infos_by_split['val'], f)

    if 'train' in infos_by_split:
        print('------------Start create groundtruth database for data augmentation------------')
        kitti_io.create_gt_database(
            kitti_io.KittiSplitIO(data_path, 'train'),
            save_path / 'kitti_infos_train.pkl', save_path, split='train')
    return infos_by_split


if __name__ == '__main__':
    import sys

    if len(sys.argv) in (2, 3) and sys.argv[1] == 'create_kitti_infos':
        root = Path(__file__).resolve().parent.parent.parent.parent
        data_path = Path(sys.argv[2]) if len(sys.argv) > 2 else root / 'data' / 'kitti'
        create_kitti_infos(data_path=data_path, save_path=data_path)
    else:
        sys.exit('usage: python -m hvpr_tpu_torch.datasets.kitti.kitti_dataset '
                 'create_kitti_infos [DATA_PATH]')
