"""Scans whose detections reached the host in the window, over the window
(host clock, from its start to the last request's end)."""

from harness.stats import rate


def read(rec):
    return rate(rec.completed_scans, rec.window_s)
