"""Dynamic decoding (paddle_tpu.nn.decode): ``gather_tree``,
``BeamSearchDecoder``, ``cell_step`` and ``dynamic_decode``.

The JAX package runs the beam search as one ``lax.while_loop``; here it
is an eager loop on tensors with the same contract:

- the state is ``[B, K]`` scores and a ``[T, B, K]`` token and parent
  history written by step; only beam 0 is live at t = 0 (the others
  start at -1e9), so K identical start beams do not multiply;
- a finished beam extends only with ``end_token``, at zero cost;
- the unwritten history pads with ``end_token`` and the parents with
  the identity, so ``gather_tree`` backtracks through it unchanged;
- the loop ends after ``max_step_num`` steps or once every beam has
  finished: that test reads one bool from the device a step (one host
  sync a step);
- the K best candidates of a row come from a stable descending sort, so
  equal scores (the -1e9 rows of finished beams tie exactly) keep the
  lower index first, as ``lax.top_k`` does;
- the output is ``[B, K, max_step_num]`` ids, best beam first.

Cell states keep their shapes across steps, as ``lax.while_loop``
demands: a cell that changes a state's shape raises.  ``cache=True``
is accepted and runs the same loop: there is no compiled program to
keep.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..core.dispatch import apply
from ..core.tensor import wrap

__all__ = ["BeamSearchDecoder", "dynamic_decode", "gather_tree",
           "cell_step"]

NEG = -1e9


def _tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested lists, tuples (named too) and
    dicts, zipped with ``rest`` of the same structure."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        if any(len(r) != len(tree) for r in rest):
            raise ValueError("decode states changed their structure")
        items = [_tree_map(fn, *xs) for xs in zip(tree, *rest)]
        return (type(tree)(*items) if hasattr(tree, "_fields")
                else type(tree)(items))
    return fn(tree, *rest)


def _leaves(tree):
    out = []
    _tree_map(out.append, tree)
    return out


def _gather_tree(step_ids, parent_ids):
    """``[T, B, K]`` ids and parent beams -> the backtracked ids:
    ``beams[t - 1] = parents[t][beams[t]]`` from the last step down."""
    T, B, K = step_ids.shape
    beams = torch.arange(K, device=step_ids.device).expand(B, K)
    out = torch.empty_like(step_ids)
    for t in range(T - 1, -1, -1):
        out[t] = torch.gather(step_ids[t], 1, beams)
        beams = torch.gather(parent_ids[t].long(), 1, beams)
    return out


def gather_tree(step_ids, parent_ids):
    """The final beams' ids from ``[T, B, K]`` step ids and parents."""
    return apply(_gather_tree, step_ids, parent_ids, op_name="gather_tree")


class BeamSearchDecoder:
    """``cell(inputs, states) -> (out, new_states)``; ``embedding_fn``
    maps token ids to the cell's inputs and ``output_fn`` its output to
    vocabulary logits, where the cell does not."""

    def __init__(self, cell, start_token: int, end_token: int,
                 beam_size: int, embedding_fn: Optional[Callable] = None,
                 output_fn: Optional[Callable] = None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn


def _tensor(t):
    return wrap(t) if type(t) is torch.Tensor else t


def cell_step(decoder: BeamSearchDecoder, tokens, states):
    """One step of the decoder's cell: ``tokens`` [N] ids (a tensor or
    an array, put on the states' device) and the state tree with
    leading dim N -> ``(log_probs [N, V] float32, new_states)``.
    ``dynamic_decode`` runs exactly this each step."""
    dec = decoder
    if not isinstance(tokens, torch.Tensor):
        leaves = _leaves(states)
        dev = leaves[0].device if leaves else None
        tokens = torch.as_tensor(np.asarray(tokens), device=dev)
    inp = _tensor(tokens)
    if dec.embedding_fn is not None:
        inp = dec.embedding_fn(inp)
    out, new_states = dec.cell(inp, _tree_map(_tensor, states))
    if dec.output_fn is not None:
        out = dec.output_fn(out)
    logp = torch.log_softmax(out.float(), -1)
    return wrap(logp), _tree_map(_tensor, new_states)


def _decode(dec, inits, T):
    K, end = dec.beam_size, dec.end_token
    leaves = _leaves(inits)
    if not leaves:
        raise ValueError("dynamic_decode needs initial states with a "
                         "batch dim")
    B, dev = leaves[0].shape[0], leaves[0].device
    states = _tree_map(lambda a: torch.repeat_interleave(a, K, 0), inits)
    i64 = dict(dtype=torch.int64, device=dev)
    scores = torch.where(torch.arange(K, device=dev) == 0, 0.0,
                         NEG).to(torch.float32).expand(B, K)
    tokens = torch.full((B, K), dec.start_token, **i64)
    finished = torch.zeros((B, K), dtype=torch.bool, device=dev)
    ids_h = torch.full((T, B, K), end, **i64)
    par_h = torch.arange(K, **i64).expand(T, B, K).clone()
    lens = torch.zeros((B, K), **i64)
    rows = torch.arange(B, device=dev)[:, None]
    fin_row = None
    t = 0
    while t < T and not bool(finished.all()):
        logp, new_states = cell_step(dec, tokens.reshape(-1), states)
        V = logp.shape[-1]
        if fin_row is None:
            fin_row = torch.full((V,), NEG, dtype=torch.float32, device=dev)
            fin_row[end] = 0.0
        logp = torch.where(finished[..., None], fin_row,
                           torch.reshape(logp, (B, K, V)))
        cand = torch.reshape(scores[..., None] + logp, (B, K * V))
        top, idx = torch.sort(cand, dim=1, descending=True, stable=True)
        top, idx = top[:, :K], idx[:, :K]
        parent, tok = idx // V, idx % V

        def select(new, old):
            if tuple(new.shape) != tuple(old.shape):
                raise ValueError(f"a decode state changed its shape from "
                                 f"{tuple(old.shape)} to "
                                 f"{tuple(new.shape)}")
            a = torch.reshape(new, (B, K) + tuple(new.shape[1:]))
            return torch.reshape(a[rows, parent], tuple(new.shape))

        states = _tree_map(select, new_states, states)
        fin_parent = torch.gather(finished, 1, parent)
        lens = torch.gather(lens, 1, parent)
        lens = torch.where(fin_parent, lens, lens + 1)
        finished = fin_parent | (tok == end)
        ids_h[t], par_h[t] = tok, parent
        tokens, scores = tok, top
        t += 1
    seq = _gather_tree(ids_h, par_h).permute(1, 2, 0)
    return seq, scores, lens


def dynamic_decode(decoder: BeamSearchDecoder, inits=None,
                   max_step_num: int = 64, is_test: bool = True,
                   return_length: bool = False, cache: bool = False,
                   **kwargs):
    """Beam search from ``inits`` (the cell's state tree, leading dim
    B): ``(ids [B, K, max_step_num], scores [B, K])``, and the lengths
    ``[B, K]`` with ``return_length``; beams best first, positions past
    a beam's end hold ``end_token``.  Runs without autograd."""
    with torch.no_grad():
        seq, scores, lens = _decode(decoder, inits, int(max_step_num))
    seq, scores, lens = wrap(seq.contiguous()), wrap(scores), wrap(lens)
    return (seq, scores, lens) if return_length else (seq, scores)
