"""The performer's projection redraw: counterpart of ``vil_tpu/train/redraw.py``.

The reference redraws every performer's random features every
``feature_redraw_interval`` training forwards, with the interval ``1 +
5·epoch`` (its run_experiment.py:217-221 and msvit.py:517-530). The
projections are the ``projection_matrix`` buffers of the model's
``PerformerAttention`` modules; :func:`redraw_projections` draws them anew in
place and :class:`RedrawSchedule` says when, as ``vil_tpu``'s Trainer asks it
before each step.
"""
from __future__ import annotations

import torch
from torch import nn

from ..models.attention_efficient import gaussian_orthogonal_random_matrix


@torch.no_grad()
def redraw_projections(model: nn.Module, generator: torch.Generator) -> int:
    """Draw every ``projection_matrix`` buffer of ``model`` anew, in place,
    from the CPU ``generator``, in the order of ``named_buffers``. Returns
    how many were drawn."""
    n = 0
    for name, buf in model.named_buffers():
        if name.rpartition(".")[2] == "projection_matrix":
            buf.copy_(gaussian_orthogonal_random_matrix(*buf.shape, generator=generator))
            n += 1
    return n


class RedrawSchedule:
    """feature_redraw_interval = 1 + 5·epoch; a redraw once the calls since
    the last one reach it (a copy of ``vil_tpu.train.redraw.RedrawSchedule``).
    A new schedule starts its count afresh, as ``vil_tpu``'s Trainer does on
    a resume."""

    def __init__(self):
        self.interval = 1
        self.calls_since_last = 0

    def set_epoch(self, epoch: int):
        self.interval = 1 + 5 * epoch

    def should_redraw(self) -> bool:
        if self.calls_since_last >= self.interval:
            self.calls_since_last = 0
            return True
        self.calls_since_last += 1
        return False
