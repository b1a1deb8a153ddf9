"""SelectedRows: the sparse row gradient (the counterpart of
``paddle_tpu.core.selected_rows``).

The backward of an embedding lookup touches only the looked-up rows, so
its gradient is ``(rows, values)`` with ``height`` the full first dim,
not a mostly-zero ``[height, dim]`` tensor.  Duplicates are kept until
:meth:`SelectedRows.merge` sums them; optimizers apply the merged rows
with row-wise scatter updates.

In the port the sparse gradient lives in a parameter's torch ``.grad``
slot as an uncoalesced ``sparse_coo`` tensor (one sparse dim, the rows;
torch's autograd adds two of them sparsely when a leaf accumulates, and
one to a dense gradient densely): :meth:`SelectedRows.from_coo` reads
it.  Rows are int64 on the values' device.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["SelectedRows", "sparse_grad"]


class SelectedRows:
    """rows: int64 [n]; values: [n, *dim]; height: the full dim 0;
    ``merged``: the rows are unique and ascending (:meth:`merge`'s
    output, and what is made from it), so merging again is a no-op."""

    __slots__ = ("rows", "values", "height", "merged")

    # numpy defers ``dense + sr`` to __radd__ instead of broadcasting
    __array_ufunc__ = None
    __array_priority__ = 1000

    def __init__(self, rows, values, height: int, merged: bool = False):
        values = torch.as_tensor(values)
        self.rows = torch.as_tensor(rows, device=values.device).reshape(
            -1).to(torch.int64)
        self.values = values
        self.height = int(height)
        self.merged = merged

    @classmethod
    def from_coo(cls, g: torch.Tensor) -> "SelectedRows":
        """The rows and values of a ``sparse_coo`` gradient with one
        sparse dim, duplicates kept, in the order they were deposited."""
        return cls(g._indices()[0], g._values(), g.shape[0])

    @property
    def shape(self):
        return (self.height,) + tuple(self.values.shape[1:])

    @property
    def dtype(self):
        return self.values.dtype

    def merge(self) -> "SelectedRows":
        """Duplicate rows summed, one entry a touched row, the rows in
        ascending order (paddle_tpu's ``jnp.unique`` order).  The number
        of unique rows is read on the host: one device sync, none when
        the rows are merged already."""
        if self.merged:
            return self
        uniq, inv = torch.unique(self.rows, sorted=True, return_inverse=True)
        vals = torch.zeros((uniq.shape[0],) + tuple(self.values.shape[1:]),
                           dtype=self.values.dtype, device=self.values.device)
        vals.index_add_(0, inv.reshape(-1), self.values)
        return SelectedRows(uniq, vals, self.height, merged=True)

    def to_dense(self) -> torch.Tensor:
        out = torch.zeros(self.shape, dtype=self.values.dtype,
                          device=self.values.device)
        return out.index_add_(0, self.rows, self.values)

    # dense and sparse accumulation (the tape deposits either)
    def __add__(self, other):
        if isinstance(other, SelectedRows):
            if other.height != self.height:
                raise ValueError(f"SelectedRows heights differ: "
                                 f"{self.height} and {other.height}")
            return SelectedRows(torch.cat([self.rows, other.rows]),
                                torch.cat([self.values, other.values]),
                                self.height)
        dense = torch.as_tensor(np.asarray(other) if not isinstance(
            other, torch.Tensor) else other).to(self.values.device)
        return dense.clone().index_add_(0, self.rows,
                                        self.values.to(dense.dtype))

    def __radd__(self, other):
        return self.__add__(other)

    def __mul__(self, s):
        return SelectedRows(self.rows, self.values * s, self.height,
                            self.merged)

    __rmul__ = __mul__

    def numpy(self) -> np.ndarray:
        return self.to_dense().detach().cpu().numpy()

    def __repr__(self):
        return (f"SelectedRows(height={self.height}, "
                f"nnz_rows={self.rows.shape[0]}, "
                f"dim={tuple(self.values.shape[1:])})")


def sparse_grad(g):
    """``g`` as the optimizers read it: a :class:`SelectedRows` for a
    ``sparse_coo`` gradient, else ``g`` itself."""
    if g is not None and g.is_sparse:
        return SelectedRows.from_coo(g)
    return g
