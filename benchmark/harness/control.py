"""The control: the reference that the configuration names in the
program's place, computed in the nearest precision below the
configuration's (``Reference(lowp=True)``).

It answers requests as the program does (head outputs kept for the check,
detections on the host), so the same comparison judges it. Its
post-processing rounds the class logits and the decoded boxes to bfloat16,
the precision below the configuration's float32, scores and labels each
anchor by its best class as the judge does, and runs the greedy NMS on
them; its detections are rows of its own rounded boxes.
"""

import torch

from reference.compare import scores_and_labels
from reference.model import _bf16
from reference.nms import greedy_nms


class Control:
    """A stand-in for :class:`harness.program.Program`."""

    def __init__(self, cell, weights, device):
        self.cell = cell
        self.cfg = cell.config
        self.device = torch.device(device)
        self.weights = weights      # one dict a draw, as the program's
        self.references = {}
        self.captured = {}
        self.events = None

    def reference_of(self, key):
        """The low-precision reference of the draw that answers pool batch
        ``key`` (None: the first), made at its first request."""
        draw = (key or 0) % len(self.weights)
        if draw not in self.references:
            self.references[draw] = self.cell.reference(self.weights[draw], self.device,
                                                        lowp=True)
        return self.references[draw]

    def detect(self, points, mask, key=None):
        reference = self.reference_of(key)
        post = self.cfg['MODEL']['POST_PROCESSING']
        nms = post['NMS_CONFIG']
        post_max = int(nms['NMS_POST_MAXSIZE'])
        cls_all, box_all, dets = [], [], []
        for scan, valid in zip(points.cpu().numpy(), mask.cpu().numpy()):
            out = reference.forward(scan[valid])
            cls, boxes = _bf16(out['cls']), _bf16(out['boxes'])
            scores, labels = scores_and_labels(cls)
            keep = greedy_nms(_bf16(scores), boxes, float(post['SCORE_THRESH']),
                              float(nms['NMS_THRESH']), int(nms['NMS_PRE_MAXSIZE']), post_max)
            pad = torch.zeros(post_max, dtype=torch.int64)
            pad[:keep.numel()] = keep
            m = torch.zeros(post_max, dtype=torch.bool)
            m[:keep.numel()] = True
            dets.append((boxes.cpu()[pad], scores.cpu()[pad],
                         labels.cpu()[pad].to(torch.int32), m))
            cls_all.append(cls)
            box_all.append(boxes)
        if key is not None:
            self.captured[key] = (torch.stack(cls_all), torch.stack(box_all))
        return {k: torch.stack(v) for k, v in zip(
            ('pred_boxes', 'pred_scores', 'pred_labels', 'pred_mask'), zip(*dets))}

    def close(self):
        self.captured = {}
        self.references = {}
