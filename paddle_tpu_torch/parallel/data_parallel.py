"""DataParallel (the counterpart of ``paddle_tpu/parallel/data_parallel.py``;
reference: ``paddle.DataParallel``, fluid/dygraph/parallel.py:323).

In the JAX package the gradient all-reduce falls out of GSPMD.  Here it
is written out: each rank holds a slice of the batch, and after the
backward every gradient is averaged over 'dp' (so each rank applies the
gradient of the mean loss over the whole batch).  Eagerly,
``loss.backward()`` on the wrapped layer averages each parameter's
``.grad`` as it is accumulated (a post-accumulate hook); the functional
path (``SpmdTrainStep``) calls :func:`allreduce_gradients` on its list.
"""
from __future__ import annotations

from typing import List

import torch
from torch import nn

from ..distributed.collective import ReduceOp, _resolve, all_reduce
from ..distributed.mesh import DP_AXIS

__all__ = ["DataParallel", "allreduce_gradients"]


def allreduce_gradients(grads: List[torch.Tensor], group=DP_AXIS):
    """Average every gradient over ``group`` in place (nothing to do over
    a group of one); returns the list."""
    g = _resolve(group)
    if g.nranks > 1:
        for t in grads:
            all_reduce(t, ReduceOp.AVG, g)
    return grads


class DataParallel(nn.Module):
    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        self._layers = layers
        self.find_unused_parameters = find_unused_parameters
        self.group = _resolve(group if group is not None else DP_AXIS)
        if self.group.nranks > 1:
            for p in layers.parameters():
                if p.requires_grad:
                    p.register_post_accumulate_grad_hook(self._average)

    def _average(self, p):
        all_reduce(p.grad, ReduceOp.AVG, self.group)

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def scale_loss(self, loss):
        """The mean over 'dp' is taken on the gradients (reference:
        parallel.py:572), so the loss is returned as it is."""
        return loss

    def apply_collective_grads(self):
        """The gradients were averaged as they were accumulated
        (reference: parallel.py:581)."""
        return

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.load_state_dict(state_dict, *args, **kwargs)
