"""Device ms a request of the NMS's suppression loop: the program's
``nms.suppress`` spans (CUDA events), summed over the request's scans, mean
over the window's requests."""

from harness.spans import program_spans, request_device_ms
from harness.stats import mean


def read(rec):
    spans = program_spans()
    return mean(request_device_ms(spans, 'nms.suppress')) if spans else None
