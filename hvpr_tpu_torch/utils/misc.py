"""Metric smoothing and logging (port of ``hvpr_tpu/utils/misc.py``).

``SmoothedValue`` keeps a window of a series with its median, mean,
global mean, max and last value; ``MetricLogger`` keeps one a metric and
prints progress over an iterable. ``device_memory_stats`` reads the
allocator's statistics of each CUDA device (``torch.cuda.memory_stats``),
as the JAX package reads its devices' ``memory_stats``.
"""

import datetime
import time
from collections import defaultdict, deque

import numpy as np
import torch


class SmoothedValue:
    """Track a series of values with access to smoothed statistics."""

    def __init__(self, window_size=20, fmt=None):
        if fmt is None:
            fmt = '{median:.4f} ({global_avg:.4f})'
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n=1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self):
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self):
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def max(self):
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, max=self.max,
                               value=self.value)


def device_memory_stats():
    """{device name: {'bytes_in_use', 'peak_bytes_in_use'}} of each CUDA
    device (the allocator's current and peak allocated bytes); {} without
    one."""
    if not torch.cuda.is_available():
        return {}
    stats = {}
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        stats[f'cuda:{i}'] = {
            'bytes_in_use': s.get('allocated_bytes.all.current', 0),
            'peak_bytes_in_use': s.get('allocated_bytes.all.peak', 0),
        }
    return stats


class MetricLogger:
    def __init__(self, delimiter='\t'):
        self.meters = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(f'{name}: {meter}' for name, meter in self.meters.items())

    def add_meter(self, name, meter):
        self.meters[name] = meter

    def log_every(self, iterable, print_freq, header=''):
        """Yield the items of ``iterable``, printing the progress, the ETA,
        the meters and the iteration and data times every ``print_freq``
        items and the total time at the end."""
        i = 0
        start_time = time.time()
        end = time.time()
        iter_time = SmoothedValue(fmt='{avg:.4f}')
        data_time = SmoothedValue(fmt='{avg:.4f}')
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0:
                try:
                    total = len(iterable)
                except TypeError:
                    total = -1
                eta = str(datetime.timedelta(
                    seconds=int(iter_time.global_avg * max(total - i, 0))))
                print(f'{header} [{i}/{total}] eta: {eta} {self} '
                      f'time: {iter_time} data: {data_time}')
            i += 1
            end = time.time()
        total_time = time.time() - start_time
        print(f'{header} Total time: {datetime.timedelta(seconds=int(total_time))}')
