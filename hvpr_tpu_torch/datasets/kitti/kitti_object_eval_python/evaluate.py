"""Standalone eval CLI over the official AP metric (the port's copy of
``hvpr_tpu/datasets/kitti/kitti_object_eval_python/evaluate.py``).
"""

import argparse

from . import eval as kitti_eval
from . import kitti_common as kitti


def evaluate(label_path, result_path, label_split_file, current_classes=(0,)):
    with open(label_split_file, 'r') as f:
        image_ids = [int(line) for line in f if line.strip()]
    dt_annos = kitti.get_label_annos(result_path, image_ids)
    gt_annos = kitti.get_label_annos(label_path, image_ids)
    result, _ = kitti_eval.get_official_eval_result(
        gt_annos, dt_annos, list(current_classes))
    print(result)


if __name__ == '__main__':
    parser = argparse.ArgumentParser()
    parser.add_argument('label_path')
    parser.add_argument('result_path')
    parser.add_argument('label_split_file')
    parser.add_argument('--classes', type=int, nargs='+', default=[0])
    args = parser.parse_args()
    evaluate(args.label_path, args.result_path, args.label_split_file, args.classes)
