"""DataParallel (the counterpart of ``paddle_tpu/parallel/data_parallel.py``;
reference: ``paddle.DataParallel``, fluid/dygraph/parallel.py:323).

In the JAX package the gradient all-reduce falls out of GSPMD.  Here it
is written out: each rank holds a slice of the batch, and after the
backward every gradient is averaged over 'dp' (so each rank applies the
gradient of the mean loss over the whole batch).  Eagerly,
``loss.backward()`` on the wrapped layer averages each parameter's
``.grad`` as it is accumulated (a post-accumulate hook); the functional
path (``SpmdTrainStep``) calls :func:`allreduce_gradients` on its list.

A sparse embedding gradient (a ``sparse_coo`` tensor in the ``.grad``
slot, ``nn.Embedding(sparse=True)``) has other rows on every rank, so
it is not summed but gathered: the slot then holds every rank's rows,
each value divided by the number of ranks, which is the whole batch's
sparse gradient of the mean loss.  SGD and ``Adam(lazy_mode=True)``
then update the same rows on every rank.
"""
from __future__ import annotations

from typing import List

import torch
from torch import nn

from ..core.tensor import raw_grad
from ..distributed.collective import ReduceOp, _resolve, all_gather, all_reduce
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


def _gather_rows(g: torch.Tensor, group) -> torch.Tensor:
    """A ``sparse_coo`` gradient with one sparse dim made the mean over
    ``group``: every rank's (row, value) pairs, in rank order, the values
    over the number of ranks.  The ranks' counts are gathered first (one
    host read), then the pairs, padded to the longest."""
    rows, vals = g._indices()[0], g._values()
    counts = all_gather(None, torch.tensor([rows.shape[0]],
                                           device=rows.device), group)
    width = int(counts.max())
    pad = width - rows.shape[0]
    if pad:
        rows = torch.cat([rows, rows.new_zeros(pad)])
        vals = torch.cat([vals, vals.new_zeros((pad,) + vals.shape[1:])])
    keep = (torch.arange(width, device=rows.device)[None, :]
            < counts[:, None]).reshape(-1)
    return torch.sparse_coo_tensor(
        all_gather(None, rows, group)[keep].unsqueeze(0),
        all_gather(None, vals, group)[keep] / counts.shape[0], g.shape,
        check_invariants=False)


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
        g = raw_grad(p)
        if g.is_sparse:
            p.grad = _gather_rows(g, self.group)
        else:
            all_reduce(g, ReduceOp.AVG, self.group)

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
