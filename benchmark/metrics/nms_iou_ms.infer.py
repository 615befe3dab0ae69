"""Device ms a request of the rotated IoU of the NMS: the program's
``nms.iou`` spans (CUDA events), summed over the request's scans, mean over
the window's requests."""

from harness.spans import program_spans, request_device_ms
from harness.stats import mean


def read(rec):
    spans = program_spans()
    return mean(request_device_ms(spans, 'nms.iou')) if spans else None
