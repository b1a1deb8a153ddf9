"""Static-graph Executor (the counterpart of
``paddle_tpu/static/executor.py``).

``run`` interprets a recorded Program.  A step is built once per key,
``(program serial, version, feed names/shapes/dtypes, fetch names, has
optimizer, kernel tier on)``, and cached; :attr:`Executor.compile_count`
counts the builds.  Building a step:

- with ``FLAGS_use_pallas_kernels`` on, runs the epilogue-fusion pass
  under the run's feed shapes (:mod:`.analysis.fusion`): matched chains
  become one node calling the fused epilogue kernels (K2f, K2b);
- for a training program, picks the update: the fused Adam kernel (K3,
  one launch over a device table built here, once) when
  ``ops.fused_adam.fused_update_for`` takes the optimizer, else the
  optimizer's ``functional_update``;
- records the realized kernel list as ``step.kernels`` (paddle_tpu's
  ``compiled._pallas_kernels``), and the cost model's prediction at the
  run's feed shapes as ``step.predicted``
  (:func:`.analysis.cost.compile_summary`: FLOPs forward and a step,
  peak bytes, the unmodeled ops), kept out of the build key.

With ``FLAGS_static_verify`` on, each (program, version) is verified
(:meth:`Program.verify` with the run's fetch list) before its first
build, so a broken program is refused before anything runs.
:attr:`Executor.host_feed_converts` counts the feeds that were not
already tensors on the Executor's device (each one an upload, or a copy
across devices); device feeds keep it at 0.

A training run interprets the (rewritten) node list with the live
parameters, takes ``torch.autograd.grad`` of the loss with respect to
the trainable ones (``requires_grad``, ``minimize``'s ``parameters=``
and ``no_grad_set=``), and updates parameters and the Executor-held
optimizer slots in place under ``no_grad``: the counterpart of
paddle_tpu's donated state.  The fused update reads its gradients from
buffers the table points at (the autograd result is copied there), and
``lr`` and the step count from device scalars, so a steady loop does
no host-to-device upload; ``return_numpy=False`` returns the fetches as
tensors without a sync.

``Executor(place)`` names the device (``set_device``'s choice, else the
current CUDA device, when None); parameters elsewhere raise.

Observability: each build is reported to
``observability.record_compile`` (component ``executor``, paddle_tpu's
causes); with a tracer on, each run is an ``executor.run`` span whose
step id is the program's run count; an exception escaping a run feeds
the flight recorder; the performance observatory times each run's host
lanes and, on sampled runs, its device lane by CUDA events; the fleet
exporter ticks once a run.  The ``executor.run`` fault point fires at
the start of each run.

Not ported: the ``_ExecState`` binding and escape machinery (torch
tensors update in place), GSPMD plans, ``grad_comm`` and the anomaly
sentry with ``sentry_stats`` (A5), ``_run_legacy`` (the JAX package's
loop from before its donated fast path; the port has no earlier loop),
the persistent compile cache (ROADMAP §C), and the supervised
heartbeat (A5).
"""
from __future__ import annotations

import time
import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core import obs_hook, rng
from ..core.flags import get_flag
from ..core.placement import device as _resolve_device
from ..core.static_hooks import replay_scope
from ..ops.fused_adam import fused_adam_eligible, fused_update_for
from ..testing import fault
from .program import Program, Variable, default_main_program

__all__ = ["Executor", "global_scope"]


class _Scope:
    """Name -> value map (the reference's Scope shim)."""

    def __init__(self):
        self.vars: Dict[str, object] = {}

    def find_var(self, name):
        return self.vars.get(name)


_global_scope = _Scope()


def global_scope() -> _Scope:
    return _global_scope


def _interp(nodes, env: Dict[int, torch.Tensor], pmap: Dict[int, object]):
    """Run the node list; ``env`` maps id(Variable) -> tensor and
    ``pmap`` id(Parameter) -> the tensor standing in for it.  A
    control-flow node's closures run under a replay scope that resolves
    the Variables and Parameters they name the same way."""
    def lookup(v):
        if isinstance(v, torch.nn.Parameter):
            return pmap.get(id(v), v)
        return env[id(v)]

    with replay_scope(lookup):
        for node in nodes:
            args = []
            for tag, v in node.in_specs:
                if tag == "v":
                    args.append(env[id(v)])
                elif tag == "p":
                    args.append(pmap[id(v)])
                else:
                    args.append(v)
            out = node.fn(*args, **node.attrs)
            for var, o in zip(node.out_vars, out if node.multi else [out]):
                env[id(var)] = o
    return env


class _Step:
    """One built step: the node list it runs and what it updates."""

    def __init__(self, nodes, feed_vars, fetch_vars, kernels):
        self.nodes = nodes
        self.feed_vars = feed_vars
        self.fetch_vars = fetch_vars
        self.kernels: List[str] = kernels
        self.predicted: Optional[dict] = None
        self.t_idx: List[int] = []
        self.loss_var: Optional[Variable] = None
        self.fused = None            # ops.fused_adam.FusedAdam or None
        self.perf_identity = ""      # the perf observatory's key


class _State:
    """Per-program training state held by the Executor: optimizer slots
    and gradient buffers by parameter, and the device scalars."""

    def __init__(self, dev, step_count):
        self.slots: Dict[int, dict] = {}
        self.gbufs: Dict[int, torch.Tensor] = {}
        self.step = torch.full((), float(step_count), dtype=torch.float32,
                               device=dev)
        self.lr = torch.zeros((), dtype=torch.float32, device=dev)
        self.lr_value: Optional[float] = None


class Executor:
    def __init__(self, place=None):
        self.place = _resolve_device(place)
        self._cache: Dict[tuple, _Step] = {}
        self._states: Dict[int, _State] = {}
        self._verified: set = set()     # (serial, version) checked
        self._compile_count = 0
        self._host_feed_converts = 0
        self._run_counts: Dict[int, int] = {}   # program serial -> runs

    @property
    def compile_count(self) -> int:
        """Steps built (one per key: program version, feed signature,
        fetch set, optimizer, tier)."""
        return self._compile_count

    @property
    def host_feed_converts(self) -> int:
        """Feeds that were not already tensors on this Executor's device
        (each one crossed to it).  Stays 0 when every feed is one."""
        return self._host_feed_converts

    def close(self):
        """Drop the built steps and the per-program state (optimizer
        slots); parameters keep their values."""
        self._cache.clear()
        self._states.clear()
        self._verified.clear()

    # -- main entry --------------------------------------------------------
    def run(self, program: Optional[Program] = None, feed=None,
            fetch_list: Optional[Sequence] = None, return_numpy=True,
            seed=None):
        # loaded inference programs (load_inference_model) run their own
        if hasattr(program, "_run_loaded"):
            return program._run_loaded(feed, fetch_list, return_numpy)
        if program is None:
            program = default_main_program()
        # observability: a span per run when tracing is on (one
        # module-attribute None-check when off), and an exception
        # escaping the step feeds the crash flight recorder before it
        # propagates
        trc = obs_hook._tracer
        sid = (trc.begin_span("executor.run", program=program._serial)
               if trc is not None else None)
        try:
            return self._run(program, feed, fetch_list, return_numpy, seed)
        except Exception as e:
            h = obs_hook._crash
            if h is not None:
                h(e, f"executor.run(program#{program._serial})")
            raise
        finally:
            if sid is not None:
                trc.end_span(sid)

    def _run(self, program, feed, fetch_list, return_numpy, seed):
        fault.point("executor.run", program._serial)
        if not program.nodes:
            return []          # a startup program: parameters exist already
        feed = feed or {}
        fetch_names = []
        for f in fetch_list or []:
            if isinstance(f, Variable):
                fetch_names.append(f.name)
            elif isinstance(f, str):
                fetch_names.append(f)
            else:
                raise TypeError(f"fetch_list entry {f!r} is not a Variable "
                                f"or a name")
        params = program.parameters()
        for p in params:
            if p.device != self.place:
                raise ValueError(f"Executor(place={self.place}): a "
                                 f"parameter of shape {tuple(p.shape)} is on "
                                 f"{p.device}")
        # perf observatory (one module-attribute None-check when off):
        # host-side anatomy stamps around feed conversion and dispatch
        perf = obs_hook._perf
        t_h0 = time.perf_counter() if perf is not None else 0.0
        feed_items = sorted(feed.items())
        feeds = [self._feed_tensor(a) for _, a in feed_items]
        t_h1 = time.perf_counter() if perf is not None else 0.0
        feed_names = tuple(n for n, _ in feed_items)
        # the per-program run counter is the step correlation id of the
        # events this run emits
        run_i = self._run_counts.get(program._serial, 0) + 1
        self._run_counts[program._serial] = run_i
        trc = obs_hook._tracer
        if trc is not None:
            trc.set_step(run_i)
        tier = bool(get_flag("use_pallas_kernels"))
        key = (program._serial, program._version, feed_names,
               tuple((tuple(t.shape), t.dtype) for t in feeds),
               tuple(fetch_names), program._optimizer is not None, tier)
        step = self._cache.get(key)
        built = step is None
        if built:
            # a new version makes the steps of older ones unreachable
            for k in [k for k in self._cache
                      if k[0] == program._serial and k[1] != key[1]]:
                del self._cache[k]
            vkey = (program._serial, program._version)
            if get_flag("static_verify") and vkey not in self._verified:
                program.verify(fetch_list=fetch_list)
                self._verified.add(vkey)
            step = self._build(program, params, feed_names, feeds,
                               fetch_names, tier)
            self._cache[key] = step
            self._compile_count += 1
            shapes = ";".join("x".join(map(str, t.shape)) for t in feeds)
            step.perf_identity = (
                f"{program._serial}v{program._version}[{shapes}]"
                f"#{zlib.crc32(repr(key).encode()) & 0xffffff:06x}")
            # recompile attribution: the first changed field (most
            # significant first) names the cause of this build
            from ..observability import record_compile
            record_compile("executor", program._serial, {
                "program_version": program._version,
                "feed_signature": tuple(
                    (tuple(t.shape), str(t.dtype).replace("torch.", ""))
                    for t in feeds),
                "feed_names": feed_names,
                "fetch_set": tuple(fetch_names),
                "optimizer": program._optimizer is not None,
                "pallas": tier,
            }, predicted=step.predicted, kernels=step.kernels)
        if seed is not None:
            rng.generator(self.place).manual_seed(int(seed))
        sample = (perf.begin("executor", step.perf_identity, self.place)
                  if perf is not None and not built else None)
        t_d0 = time.perf_counter() if perf is not None else 0.0
        env = {id(v): t for v, t in zip(step.feed_vars, feeds)}
        if program._optimizer is None:
            with torch.no_grad():
                _interp(step.nodes, env, {id(p): p for p in params})
        else:
            self._train(program, params, step, env)
        fetches = [env[id(v)].detach() for v in step.fetch_vars]
        # the building run is left out of the anatomy (its wall is the
        # build); a sampled step waits for its end event here
        if perf is not None and not built:
            perf.step("executor", step.perf_identity, t_h0, t_h1 - t_h0,
                      t_d0, time.perf_counter() - t_d0,
                      predicted=step.predicted, sample=sample)
        # fleet telemetry: the exporter flushes at most once an interval
        exp = obs_hook._export
        if exp is not None:
            exp.tick()
        if return_numpy:
            return [f.cpu().numpy() for f in fetches]
        return fetches

    def _feed_tensor(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor) and a.device == self.place:
            return a
        self._host_feed_converts += 1
        if isinstance(a, torch.Tensor):
            return a.to(self.place)
        return torch.tensor(np.asarray(a), device=self.place)

    # -- training ----------------------------------------------------------
    def _state_for(self, program, opt) -> _State:
        state = self._states.get(program._serial)
        if state is None:
            state = self._states[program._serial] = _State(
                self.place, opt._step_count)
        return state

    def _slots(self, state, opt, tparams):
        fresh = [p for p in tparams if id(p) not in state.slots]
        for p, s in zip(fresh, opt.functional_init(
                [p.detach() for p in fresh])):
            state.slots[id(p)] = s
        return [state.slots[id(p)] for p in tparams]

    def _train(self, program, params, step: _Step, env):
        opt = program._optimizer[0]
        state = self._state_for(program, opt)
        tparams = [params[i] for i in step.t_idx]
        t_ids = {id(p) for p in tparams}
        pmap = {id(p): (p if id(p) in t_ids else p.detach()) for p in params}
        with torch.enable_grad():
            _interp(step.nodes, env, pmap)
            loss = env[id(step.loss_var)]
            grads = torch.autograd.grad(loss, tparams, allow_unused=True)
        opt._step_count += 1
        lr = float(opt.get_lr())
        with torch.no_grad():
            if step.fused is not None:
                if lr != state.lr_value:     # uploaded when it moves
                    state.lr.fill_(lr)
                    state.lr_value = lr
                state.step.add_(1.0)
                gbufs = [state.gbufs[id(p)] for p in tparams]
                for b, g in zip(gbufs, grads):
                    if g is None:
                        b.zero_()
                torch._foreach_copy_(
                    [b for b, g in zip(gbufs, grads) if g is not None],
                    [g for g in grads if g is not None])
                step.fused(state.lr, state.step)
            else:
                state.step.add_(1.0)
                slots = self._slots(state, opt, tparams)
                grads = [torch.zeros_like(p) if g is None else g
                         for p, g in zip(tparams, grads)]
                new_p, new_s = opt.functional_update(
                    [p.detach() for p in tparams], grads, slots, lr,
                    opt._step_count, params_meta=tparams)
                torch._foreach_copy_([p.detach() for p in tparams], new_p)
                for old, new in zip(slots, new_s):
                    for k, t in new.items():
                        old[k].copy_(t)

    # -- building ----------------------------------------------------------
    def _build(self, program, params, feed_names, feeds, fetch_names,
               tier) -> _Step:
        from .analysis.graph import DefUseGraph
        graph = DefUseGraph(program)
        feed_vars = []
        for name in feed_names:
            if name not in program.feed_vars:
                raise KeyError(f"feed {name!r} is not a static.data of the "
                               f"program")
            feed_vars.append(program.feed_vars[name])
        fetch_vars = []
        for name in fetch_names:
            v = graph.resolve_fetch(name)
            if v is None:
                raise KeyError(f"fetch {name!r} names no Variable of the "
                               f"program")
            fetch_vars.append(v)
        nodes, kernels = list(program.nodes), []
        if tier:
            from .analysis import fusion
            # the loss, like a fetch, must survive the rewrite
            loss = ([] if program._optimizer is None
                    else [program._optimizer[1]])
            plans = fusion.plan_fusions(
                program, fetch_list=fetch_vars + loss,
                feed_shapes={n: tuple(t.shape)
                             for n, t in zip(feed_names, feeds)})
            if plans:
                nodes = fusion.apply_plans(nodes, plans)
                kernels.extend(f"fused_epilogue[{p.label}]" for p in plans)
        step = _Step(nodes, feed_vars, fetch_vars, kernels)
        from .analysis.cost import compile_summary
        step.predicted = compile_summary(
            program, feed_shapes={n: tuple(t.shape)
                                  for n, t in zip(feed_names, feeds)},
            place=self.place)
        if program._optimizer is None:
            return step
        opt, loss_var, param_filter, no_grad_set = program._optimizer
        allow = (None if param_filter is None
                 else {id(p) for p in param_filter})
        deny = {id(p) for p in (no_grad_set or ())}
        step.t_idx = [i for i, p in enumerate(params)
                      if p.requires_grad and id(p) not in deny
                      and (allow is None or id(p) in allow)]
        step.loss_var = loss_var
        tparams = [params[i] for i in step.t_idx]
        if tier and tparams and fused_adam_eligible(opt, tparams):
            state = self._state_for(program, opt)
            slots = self._slots(state, opt, tparams)
            for p in tparams:
                if id(p) not in state.gbufs:
                    state.gbufs[id(p)] = torch.zeros_like(p.detach())
            step.fused = fused_update_for(
                opt, [p.detach() for p in tparams],
                [state.gbufs[id(p)] for p in tparams], slots)
            kernels.append("fused_adam")
        return step
