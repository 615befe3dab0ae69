"""Statistics the metrics take over a window: every request counts."""

import math


def percentile(values, q):
    """The ``q``-th percentile of all ``values`` by nearest rank: the
    smallest value that at least ``q`` percent of them do not exceed."""
    if not values:
        return None
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100.0 * len(ordered)) - 1)]


def rate(count, seconds):
    """``count`` over the whole window of ``seconds``."""
    return count / seconds if seconds > 0 else None


def mean(values):
    return sum(values) / len(values) if values else None
