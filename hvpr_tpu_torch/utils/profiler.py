"""Profiling hooks (port of ``hvpr_tpu/utils/profiler.py``).

``trace`` captures a ``torch.profiler`` trace of a block (CPU activity, and
CUDA kernels where a device is present) into a Chrome trace file;
``sync`` waits for the work queued on the devices of a nest of tensors
(``torch.cuda.synchronize``); ``StepTimer`` accounts wall-clock seconds a
step, synchronizing every ``sync_every`` steps so that the device queue
stays busy while the timing error stays bounded.
"""

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir):
    """Capture a ``torch.profiler`` trace around a block into
    ``log_dir/trace.json`` (view in Perfetto or chrome://tracing). Yields
    the profiler (``key_averages()`` for a table)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(str(log_dir), 'trace.json'))


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def sync(tree):
    """Wait until the work on every CUDA device that holds a tensor of
    ``tree`` (tensors in dicts, lists and tuples) is done; returns
    ``tree``."""
    for dev in {t.device for t in _leaves(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)
    return tree


class StepTimer:
    """Per-step wall-clock accounting with a device sync every
    ``sync_every`` steps."""

    def __init__(self, sync_every=10):
        self.sync_every = sync_every
        self.reset()

    def reset(self):
        self.count = 0
        self.start = time.time()

    def step(self, output_tree=None):
        self.count += 1
        if output_tree is not None and self.count % self.sync_every == 0:
            sync(output_tree)

    @property
    def sec_per_step(self):
        return (time.time() - self.start) / max(self.count, 1)
