"""Device ms a request of the sparse convs' row gathers and products: the
program's ``sparse.product`` spans (CUDA events), summed over the
request's convs, mean over the window's requests."""

from harness.spans import program_spans, request_device_ms
from harness.stats import mean


def read(rec):
    spans = program_spans()
    if not spans or not any(s['name'] == 'sparse.product' for s in spans):
        return None
    return mean(request_device_ms(spans, 'sparse.product'))
