"""Faults planted under the timed path, for the tests and the readings that
show the check catches them. Each is a stand-in for
:class:`harness.program.Program` (``program_factory`` of ``run_cell``)."""

import torch

from harness.program import Program


def half_batch(cell, seed, device):
    """Inference answering each batch from its first half only."""
    prog = Program(cell, seed, device)
    for net in prog.nets:
        net.pipeline = _half(net.pipeline)
    return prog


def _half(pipeline):
    def broken(points, mask):
        half = points.shape[0] // 2
        return pipeline(torch.cat([points[:half], points[:half]]), mask)
    return broken


def altered_answer(cell, seed, device):
    """Inference with one detection a batch moved by half a metre where
    post-processing produces it."""
    prog = Program(cell, seed, device)
    for net in prog.nets:
        net.pipeline = _altered(net.pipeline)
    return prog


def _altered(pipeline):
    def broken(points, mask):
        out = dict(pipeline(points, mask))
        boxes = out['pred_boxes'].clone()
        boxes[0, 0, 0] += 0.5
        out['pred_boxes'] = boxes
        return out
    return broken


def swapped_classes(cell, seed, device):
    """Inference whose head gives its last two classes' logits each other's
    places, in its output, before post-processing (two classes or more)."""
    if len(cell.config['CLASS_NAMES']) < 2:
        raise ValueError('swapping classes needs a configuration of two classes or more')
    prog = Program(cell, seed, device)

    def swap(_module, _args, out):
        cls = out['batch_cls_preds']
        cls[..., [-2, -1]] = cls[..., [-1, -2]]

    for net in prog.nets:
        prog.hooks.append(net.module.dense_head.register_forward_hook(swap))
    return prog


FAULTS = {f.__name__: f for f in (half_batch, altered_answer, swapped_classes)}
