"""The control: the reference in the program's place, computed in the
nearest precision below the configuration's (``Reference(lowp=True)``).

It answers requests as the program does (head outputs kept for the check,
detections on the host), so the same comparison judges it. Its
post-processing rounds the decoded boxes and the scores to bfloat16, the
precision below the configuration's float32, and runs the greedy NMS on
them; its detections are rows of its own rounded boxes.
"""

import torch

from reference.model import Reference, _bf16
from reference.nms import greedy_nms


class Control:
    """A stand-in for :class:`harness.program.Program`."""

    def __init__(self, cell, weights, device):
        self.cfg = cell.config
        self.device = torch.device(device)
        self.reference = Reference(self.cfg, weights, device, lowp=True)
        self.captured = {}
        self.events = None

    def detect(self, points, mask, key=None):
        post = self.cfg['MODEL']['POST_PROCESSING']
        nms = post['NMS_CONFIG']
        post_max = int(nms['NMS_POST_MAXSIZE'])
        cls_all, box_all, dets = [], [], []
        for scan, valid in zip(points.cpu().numpy(), mask.cpu().numpy()):
            out = self.reference.forward(scan[valid])
            cls, boxes = _bf16(out['cls']), _bf16(out['boxes'])
            scores = torch.sigmoid(cls)
            keep = greedy_nms(_bf16(scores), boxes, float(post['SCORE_THRESH']),
                              float(nms['NMS_THRESH']), int(nms['NMS_PRE_MAXSIZE']), post_max)
            pad = torch.zeros(post_max, dtype=torch.int64)
            pad[:keep.numel()] = keep
            m = torch.zeros(post_max, dtype=torch.bool)
            m[:keep.numel()] = True
            dets.append((boxes.cpu()[pad], scores.cpu()[pad],
                         torch.ones(post_max, dtype=torch.int32), m))
            cls_all.append(cls[:, None])
            box_all.append(boxes)
        if key is not None:
            self.captured[key] = (torch.stack(cls_all), torch.stack(box_all))
        return {k: torch.stack(v) for k, v in zip(
            ('pred_boxes', 'pred_scores', 'pred_labels', 'pred_mask'), zip(*dets))}

    def close(self):
        self.captured = {}
