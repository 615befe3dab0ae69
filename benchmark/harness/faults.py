"""Faults planted under the timed path, for the tests and the readings that
show the check catches them. Each is a stand-in for
:class:`harness.program.Program` (``program_factory`` of ``run_cell``)."""

import torch

from harness.program import Program


def half_batch(cell, seed, device):
    """Inference answering each batch from its first half only."""
    prog = Program(cell, seed, device)
    pipeline = prog.net.pipeline

    def broken(points, mask):
        half = points.shape[0] // 2
        return pipeline(torch.cat([points[:half], points[:half]]), mask)

    prog.net.pipeline = broken
    return prog


def altered_answer(cell, seed, device):
    """Inference with one detection a batch moved by half a metre where
    post-processing produces it."""
    prog = Program(cell, seed, device)
    pipeline = prog.net.pipeline

    def broken(points, mask):
        out = dict(pipeline(points, mask))
        boxes = out['pred_boxes'].clone()
        boxes[0, 0, 0] += 0.5
        out['pred_boxes'] = boxes
        return out

    prog.net.pipeline = broken
    return prog


FAULTS = {f.__name__: f for f in (half_batch, altered_answer)}
