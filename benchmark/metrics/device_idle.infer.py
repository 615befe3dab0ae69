"""Share of the window in which no kernel, copy or memset ran on the device:
1 - (union of the device intervals) / window, in percent. Left out where
the trace's launches of a hand-written kernel disagree with the program's
count (dropped records)."""


def read(rec):
    if rec.trace is None or not rec.launches_match:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s() / rec.trace.span_s())
