"""Device ms a request of the sparse convs' neighbour searches and strided
output-site builds: the program's ``sparse.lookup`` spans (CUDA events),
summed over the request's convs, mean over the window's requests."""

from harness.spans import program_spans, request_device_ms
from harness.stats import mean


def read(rec):
    spans = program_spans()
    if not spans or not any(s['name'] == 'sparse.lookup' for s in spans):
        return None
    return mean(request_device_ms(spans, 'sparse.lookup'))
