"""Pipeline parallelism (the counterpart of
``paddle_tpu/parallel/pipeline.py``).

Stages run over the 'pp' axis of the mesh, one stage a rank: every rank
holds only its own stage's parameters (:func:`stack_stage_params` gives
each rank its block of the stacked parameters) and runs the same
fill-drain schedule of ``T = M + S - 1`` ticks, as the JAX package's
``lax.scan`` does:

- the microbatch stream is laid out round-robin, ``[S, Q]`` (microbatch
  ``q * S + r`` on rank ``r``; the tail slots are zero padding when S
  does not divide M, never injected or collected), and with a 'dp' axis
  its batch dim is cut over 'dp': each data-parallel group runs its own
  pipeline;
- each tick the owner of microbatch ``t`` broadcasts it to the ring,
  stage 0 takes it (through the optional embedding first stage), every
  rank runs its stage, and the outputs move one stage on
  (:func:`~..distributed.collective.ppermute`);
- the last stage's output (through the optional head) is summed over
  'pp' with the other ranks' zeros and kept by the rank that owns that
  microbatch, so outputs are born sharded like the inputs; the result is
  gathered over 'pp' (and 'dp') at the end.

torch autograd gives the reverse schedule: the ticks are recorded in
order with the same operations on every rank (the rank-dependent choices
are ``torch.where`` masks, never Python branches), so each rank's
backward issues the collectives of the forward in reverse, in the same
order as the other ranks.  The conjugate collectives do what the JAX
package's ``shard_map`` transpose does: the broadcasts are a masked
:func:`~..distributed.collective.psum`, whose backward sums the
cotangent over 'pp' and the mask keeps it on the owner; the stage
parameters' gradients are summed over 'dp' and the embedding's and
head's (replicated, used on one stage) over 'pp' and 'dp'
(:func:`~..distributed.collective.copy_to_group`); the final gathers
keep each rank's slice of the cotangent, the loss being computed alike
on every rank.

``remat=True`` (the default) runs the stage, embedding and head bodies
as :func:`~.recompute.recompute` segments (their dropout masks
replayed): a tick keeps its input and recomputes the layers' internals
in the backward, as ``jax.checkpoint`` does there.

The stages must be structurally uniform and shape-preserving (the
embedding and head excepted), and the number of stages is the size of
the 'pp' axis.
"""
from __future__ import annotations

import copy
from typing import Callable, Optional, Sequence

import torch
from torch.func import functional_call

from ..distributed.collective import (axis_group, broadcast, copy_to_group,
                                      gather_from_group, ppermute, psum)
from ..distributed.mesh import PP_AXIS, ensure_mesh
from ..nn.layer_base import Layer

__all__ = ["PipelineStage", "Pipeline", "stack_stage_params",
           "pipelined_fn", "pipeline_train_fn"]


class PipelineStage(Layer):
    """Marker container for one stage (uniform structure across
    stages)."""

    def __init__(self, block):
        super().__init__()
        self.block = block

    def forward(self, x):
        return self.block(x)


class Pipeline(Layer):
    """A sequence of shape-uniform stages, run one after another (the
    single-device form); :func:`pipelined_fn` runs them over 'pp'."""

    def __init__(self, stages: Sequence, num_microbatches: int = 1):
        super().__init__()
        from ..nn import LayerList
        self.stages = LayerList(list(stages))
        self.num_microbatches = num_microbatches

    def forward(self, x):
        for s in self.stages:
            x = s(x)
        return x


def _names(layer):
    return [n for n, _ in layer.named_parameters()]


def stack_stage_params(stages: Sequence, mesh=None, pp_axis: str = PP_AXIS):
    """The stages' parameters stacked on a new leading 'stage' axis,
    returned as ``(stacked, n_params_per_stage)``: one new leaf
    Parameter per parameter of a stage, in the stage's parameter order.

    Over a 'pp' axis of n ranks each rank keeps only its block, the
    ``S / n`` stages it runs (``global_shape`` names the whole stack);
    without one, the whole stack.  The stages must be structurally
    uniform; the stacks are copies, so the stages may be dropped."""
    per_stage = [[p for _, p in s.named_parameters()] for s in stages]
    n = len(per_stage[0])
    for ps in per_stage:
        if len(ps) != n:
            raise ValueError("pipeline stages must be structurally uniform")
    S = len(stages)
    mesh = mesh or ensure_mesh()
    pp = mesh.axis_size(pp_axis)
    if S % pp:
        raise ValueError(f"{S} stages do not divide over the '{pp_axis}' "
                         f"axis of {pp} ranks")
    per = S // pp
    lo = mesh.axis_index(pp_axis) * per
    stacked = []
    for i in range(n):
        ref = per_stage[0][i]
        with torch.no_grad():
            block = torch.stack([per_stage[k][i].detach()
                                 for k in range(lo, lo + per)], dim=0)
        p = torch.nn.Parameter(block, requires_grad=ref.requires_grad)
        p.global_shape = (S,) + tuple(ref.shape)
        stacked.append(p)
    return stacked, n


def _meta_template(layer):
    """A copy of ``layer`` whose parameters are meta tensors (its buffers
    kept): the structure the pipeline runs with the parameters it is
    given, holding no second copy of them."""
    if layer is None:
        return None
    memo = {id(p): torch.nn.Parameter(torch.empty_like(p, device="meta"),
                                      requires_grad=p.requires_grad)
            for p in layer.parameters()}
    return copy.deepcopy(layer, memo)


def _where(flag: bool, a, b):
    """``a`` where this rank's ``flag`` holds, else ``b``, with both in
    the graph on every rank (so each rank's backward runs the same
    nodes)."""
    return torch.where(torch.tensor(flag, device=a.device), a, b)


def pipelined_fn(stage_layer, n_stages: int, num_microbatches: int,
                 mesh=None, pp_axis: str = PP_AXIS,
                 dp_axis: Optional[str] = None, embed_layer=None,
                 head_layer=None, remat: bool = True):
    """``stage_layer`` run as an S-stage pipeline over 'pp'.

    Returns ``fn(stacked_params, x[, embed_params][, head_params])``:
    ``stacked_params`` are :func:`stack_stage_params`'s (this rank's
    block); ``x`` is the global batch ``[B, ...]`` on every rank, split
    into ``num_microbatches`` (with ``dp_axis`` in the mesh, each dp
    group takes its slice of every microbatch); ``embed_layer`` /
    ``head_layer`` make the first / last stages non-uniform, their
    parameters (``tuple(layer.parameters())``) replicated.  Output: the
    global ``[B, ...]`` after embed, the S stages and head, alike on
    every rank."""
    mesh = mesh or ensure_mesh()
    S, M = int(n_stages), int(num_microbatches)
    if mesh.axis_size(pp_axis) != S:
        raise ValueError(
            f"pipelined_fn: {S} stages over a '{pp_axis}' axis of "
            f"{mesh.axis_size(pp_axis)} ranks: one stage a rank")
    # round-robin stream layout [S, Q]; when S doesn't divide M the tail
    # slots are zero padding that is never injected or collected
    Q = (M + S - 1) // S
    T = M + S - 1
    names = _names(stage_layer)
    e_names = _names(embed_layer) if embed_layer is not None else []
    h_names = _names(head_layer) if head_layer is not None else []
    template = _meta_template(stage_layer)
    e_tmpl = _meta_template(embed_layer)
    h_tmpl = _meta_template(head_layer)
    use_dp = dp_axis is not None and mesh.axis_size(dp_axis) > 1
    pp_g = axis_group(pp_axis, mesh)
    dp_g = axis_group(dp_axis, mesh) if use_dp else None
    idx = mesh.axis_index(pp_axis)
    ring = [(i, (i + 1) % S) for i in range(S)]

    def _apply(tmpl, pnames, params):
        pd = dict(zip(pnames, params))

        def body(a):
            return functional_call(tmpl, pd, (a,))

        if not remat:
            return body
        from .recompute import recompute
        return lambda a: recompute(body, a)

    def _replicated(params):
        # used on one stage, replicated over 'pp' (and 'dp'): the
        # gradient is the sum of every rank's
        out = []
        for p in params:
            p = copy_to_group(p, pp_g)
            out.append(copy_to_group(p, dp_g) if use_dp else p)
        return out

    def fn(stacked_params, x, embed_params=(), head_params=()):
        B = x.shape[0]
        if B % M:
            raise ValueError(f"batch {B} not divisible by microbatches {M}")
        mb = B // M
        if use_dp and mb % dp_g.nranks:
            raise ValueError(f"microbatch {mb} not divisible by the "
                             f"'{dp_axis}' size {dp_g.nranks}")
        if x.requires_grad:
            x = copy_to_group(x, pp_g)
            x = copy_to_group(x, dp_g) if use_dp else x
        xs = x.reshape((M, mb) + tuple(x.shape[1:]))
        if Q * S != M:
            xs = torch.cat([xs, xs.new_zeros((Q * S - M,) + tuple(
                xs.shape[1:]))], dim=0)
        # stream[r, q] = microbatch q * S + r; this rank keeps row idx
        my_stream = xs.reshape((Q, S) + tuple(xs.shape[1:]))[:, idx]
        if use_dp:
            my_stream = my_stream.chunk(dp_g.nranks, dim=1)[dp_g.rank]
        if any(p.shape[0] != 1 for p in stacked_params):
            raise ValueError("pipelined_fn: give each rank its block of "
                             "one stage (stack_stage_params)")
        my_params = [p[0] for p in stacked_params]
        if use_dp:
            my_params = [copy_to_group(p, dp_g) for p in my_params]
        stage = _apply(template, names, my_params)
        embed = (_apply(e_tmpl, e_names, _replicated(embed_params))
                 if embed_layer is not None else None)
        head = (_apply(h_tmpl, h_names, _replicated(head_params))
                if head_layer is not None else None)
        diff_in = my_stream.requires_grad

        def inject(t):
            """The owner (rank t mod S) broadcasts microbatch t: the
            stream stays sharded, the wire carries one microbatch."""
            cand = my_stream[t // S]
            if S == 1:
                return cand
            if diff_in:
                return psum(_where(idx == t % S, cand,
                                   torch.zeros_like(cand)), pp_g)
            return broadcast(cand.detach().clone(), t % S, pp_g)

        buf = None
        outs = [None] * Q
        for t in range(T):
            mb_in = inject(min(t, M - 1))
            cand_act = embed(mb_in) if embed is not None else mb_in
            if buf is None:
                buf = torch.zeros_like(cand_act)
            inp = cand_act if S == 1 else _where(idx == 0, cand_act, buf)
            y = stage(inp)
            if S > 1 and t < T - 1:
                buf = ppermute(y, ring, pp_g)
            # the last stage's tick-t output is microbatch t - (S - 1);
            # its owner keeps it (the output stream stays sharded)
            h_out = head(y) if head is not None else y
            tp = t - (S - 1)
            tq = min(max(tp, 0), M - 1)
            slot = tq // S
            if S == 1:
                outs[slot] = h_out
                continue
            yb = psum(_where(idx == S - 1, h_out, torch.zeros_like(h_out)),
                      pp_g)
            if outs[slot] is None:
                outs[slot] = torch.zeros_like(yb)
            outs[slot] = _where(tp >= 0 and idx == tq % S, yb, outs[slot])
        stream = torch.stack([o if o is not None else torch.zeros_like(
            outs[0]) for o in outs], dim=0)          # [Q, mb/dp, ...]
        if use_dp:
            stream = gather_from_group(stream, dp_g, dim=1)
        stream = gather_from_group(stream.unsqueeze(0), pp_g, dim=0)
        # [S, Q, mb, ...] -> [B, ...], undoing the round-robin layout
        out = stream.transpose(0, 1).reshape((Q * S * mb,) + tuple(
            stream.shape[3:]))
        return out[:M * mb]

    return fn


def pipeline_train_fn(stage_layer, head_fn: Callable, n_stages: int,
                      num_microbatches: int, mesh=None,
                      pp_axis: str = PP_AXIS, dp_axis=None,
                      embed_layer=None, head_layer=None,
                      remat: bool = True):
    """``fn(stacked_params, x, y, embed_params=(), head_params=())`` ->
    the scalar loss ``head_fn(pipeline output, y)``, alike on every
    rank; ``loss.backward()`` leaves each rank the gradients of its own
    stage's block and of the replicated embedding and head."""
    fwd = pipelined_fn(stage_layer, n_stages, num_microbatches, mesh,
                       pp_axis, dp_axis=dp_axis, embed_layer=embed_layer,
                       head_layer=head_layer, remat=remat)

    def fn(stacked_params, x, y, embed_params=(), head_params=()):
        return head_fn(fwd(stacked_params, x, embed_params, head_params), y)

    return fn
