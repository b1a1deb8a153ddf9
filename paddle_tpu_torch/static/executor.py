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

Sharding plans.  When the program's optimizer went through
``fleet.distributed_optimizer`` (it carries the strategy) or the program
carries ``_sharding_rules``, the run follows a
:class:`~..distributed.sharding.ShardingPlan` (:meth:`Executor._plan_for`)
and, as paddle_tpu does, builds its step with the kernel tier off (no
epilogue fusion, no fused Adam; attention keeps its own gate).  At
dp = 1 nothing else changes.  At dp > 1 each rank is one process of a
``torch.distributed`` job:

- every rank is fed the global batch and keeps its dp slice of each
  batch feed (:meth:`ShardingPlan.feed_spec`);
- forward and backward run on the slice; the gradients go through the
  gradient-communication stage (:mod:`..distributed.grad_comm`): the
  strategy's ``grad_comm`` plan when one is configured, with its
  error-feedback residuals kept per rank, else an fp32 plan of the same
  machinery without stats;
- a dp-sharded (ZeRO-3, dim 0) parameter holds only this rank's rows
  between runs (:class:`~..distributed.sharding.ParamShards`): a run
  all-gathers them just before the forward (the plan's gather leg),
  the gradient is reduce-scattered to the rows, the optimizer slots
  hold only those rows, the update writes them, and the full value is
  dropped after the run.  :meth:`Executor.sync_params` gives the
  parameters their full values (for a read or an outside write);
- fetches are the mean over dp (a scalar) or the dp slices
  all-gathered (batch-major), as the build-time probe classified them;
  a sum-reduced loss or fetch is refused;
- with ``grad_comm`` on, each run adds the plan's figures to the
  ``comm.*`` monitor stats (``comm.wire_bytes``, ``comm.collectives``,
  per bucket, per algorithm, ``comm.axis.<name>.wire_bytes``,
  ``comm.gather.*``) and the compile record carries the bucket
  schedule.

The hybrid {dp, mp} form: a trainable whose spec cuts it over 'mp'
(the program's ``_sharding_rules`` or a tensor-parallel placement)
rests as this rank's chunk between runs, as a ZeRO-3 one rests as its
rows.  A run all-gathers each such chunk over 'mp' in the reduction
plan's gather order (the forward order) before the forward, outside the
differentiated region, so gradients are taken with respect to the full
values; the dp-reduced gradient is cut back to the rank's chunk along
the gather's dim and the update writes the chunk.  Dropout draws fold
in the dp index only, so the mp replicas of a dp group draw the same
masks and compute the same values.  The ``comm.axis.mp.*`` statistics
carry the mp gathers' bytes.  Other mesh axes (pp, sp) hold replicas of
the computation; under ``grad_comm`` they are refused with paddle_tpu's
cause string.
:meth:`Executor.sharded_state` is the program's state as a
``ShardedState`` for ``SnapshotStore``.

Not ported: the ``_ExecState`` binding and escape machinery (torch
tensors update in place), the anomaly sentry with ``sentry_stats`` and
the supervised heartbeat (A5c), ``_run_legacy`` (the JAX package's loop
from before its donated fast path; the port has no earlier loop), and
the persistent compile cache (ROADMAP §C).
"""
from __future__ import annotations

import time
import weakref
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
        self.dist: Optional["_DistStep"] = None   # dp > 1 under a plan
        self.comm_record: Optional[dict] = None


class _DistStep:
    """What a step under a sharding plan at dp > 1 needs: the dp group,
    the feeds' specs, the fetches' rules, the reduction plan, the
    dp-sharded trainables (positions into the trainable list) and the
    stats a run adds."""

    def __init__(self, plan, group, feed_specs, fetch_rules, gplan, fsdp,
                 comm_stats, mp=None):
        self.plan = plan
        self.g = group
        self.dp = group.nranks
        self.feed_specs = feed_specs
        self.fetch_rules = fetch_rules
        self.gplan = gplan
        self.fsdp = frozenset(fsdp)
        self.comm_stats = comm_stats
        # trainable position -> (dim, mp group) of the mp-cut ones
        self.mp = dict(mp or {})


class _State:
    """Per-program training state held by the Executor: optimizer slots
    and gradient buffers by parameter, and the device scalars."""

    def __init__(self, dev, step_count, params=()):
        self.slots: Dict[int, dict] = {}
        self.gbufs: Dict[int, torch.Tensor] = {}
        # id(param) -> its position in program.parameters(): the key of
        # the slots optimizer.state_dict exports
        self.position = {id(p): i for i, p in enumerate(params)}
        # grad_comm error-feedback residuals (this rank's row of each
        # residual bucket) and the plan fingerprint they were kept under
        self.ef: List[torch.Tensor] = []
        self.ef_key = None
        self.step = torch.full((), float(step_count), dtype=torch.float32,
                               device=dev)
        self.lr = torch.zeros((), dtype=torch.float32, device=dev)
        self.lr_value: Optional[float] = None

    def export_slots(self) -> Dict[str, dict]:
        """The optimizer slots keyed by the param's position in
        ``program.parameters()``: static-mode ``optimizer.state_dict``
        reads them here."""
        out = {}
        for pid, s in self.slots.items():
            if s and pid in self.position:
                out[str(self.position[pid])] = {
                    k: v.detach().cpu().numpy().copy() for k, v in s.items()}
        return out


class Executor:
    def __init__(self, place=None):
        self.place = _resolve_device(place)
        self._cache: Dict[tuple, _Step] = {}
        self._states: Dict[int, _State] = {}
        self._verified: set = set()     # (serial, version) checked
        self._compile_count = 0
        self._host_feed_converts = 0
        self._run_counts: Dict[int, int] = {}   # program serial -> runs
        # sharding plans per program serial:
        # (version, mesh, strategy, rules, plan)
        self._plans: Dict[int, tuple] = {}
        # ZeRO-3 parameters resting as this rank's rows, and mp-cut ones
        # as their chunks, between runs
        from ..distributed.sharding import ParamShards
        self._shards = ParamShards()
        # program serial -> the params in the reduction plan's gather
        # order (the forward order), which a run gathers them in
        self._gather_order: Dict[int, list] = {}

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
        slots); parameters keep their values (ZeRO-3 ones are gathered
        back first: every rank of the job calls it)."""
        self._shards.sync()
        self._cache.clear()
        self._states.clear()
        self._verified.clear()
        self._plans.clear()

    def sync_params(self, program=None):
        """Give the program's ZeRO-3 parameters (default: every one this
        Executor holds) their full values again, gathered from the
        ranks' rows (a collective: every rank calls it).  Between runs
        such a parameter holds only this rank's rows; after this call it
        holds its full value, which the next run reads, and rests again
        after that run."""
        self._shards.sync(None if program is None
                          else program.parameters())

    # -- sharding ----------------------------------------------------------
    def _plan_for(self, program, params):
        """The program's ShardingPlan, or None.  A plan exists when the
        attached optimizer went through ``fleet.distributed_optimizer``
        (it carries the strategy) or the program carries
        ``_sharding_rules``; the mesh is the global one (``fleet.init``
        derives it).  Cached per serial, revalidated against (version,
        mesh, strategy, rules)."""
        pack = program._optimizer
        opt = pack[0] if pack is not None else None
        strategy = (getattr(opt, "_dist_strategy", None)
                    if opt is not None else None)
        rules = getattr(program, "_sharding_rules", None)
        if strategy is None and rules is None:
            return None
        from ..distributed.mesh import get_mesh, init_mesh
        mesh = get_mesh()
        if mesh is None:
            if strategy is None:
                return None
            import torch.distributed as dist
            world = dist.get_world_size() if dist.is_initialized() else 1
            mesh = init_mesh(strategy.infer_mesh_shape(world))
        cached = self._plans.get(program._serial)
        if cached is not None:
            ver, cmesh, cstrat, crules, plan = cached
            if (ver == program._version and cmesh is mesh
                    and cstrat is strategy and crules is rules):
                return plan
        from ..distributed import sharding as _sh
        plan = _sh.plan_for_params(
            [(p.name, p) for p in params], strategy=strategy, mesh=mesh,
            rules=rules, label=f"program#{program._serial}")
        self._plans[program._serial] = (program._version, mesh, strategy,
                                        rules, plan)
        return plan

    def sharded_state(self, program=None):
        """The program's live state (params, optimizer slots, the step
        and run counters, the grad_comm residuals under ``ef/``) as a
        :class:`~..distributed.sharding.ShardedState` for
        ``SnapshotStore``: per-block, digest-verified, reshardable
        checkpoints.  Entries are keyed by position in
        ``program.parameters()``.  Under a plan a dp-sharded param's
        entry is this rank's block; every rank of the job saves and
        restores together."""
        from ..distributed.mesh import DP_AXIS, PartitionSpec
        from ..distributed.sharding import (ShardedState, gather_full,
                                            shard_local, spec_axes)
        if program is None:
            program = default_main_program()

        def _key(i):
            return f"{i:04d}"

        def _plan():
            return self._plan_for(program, program.parameters())

        def _tag(t, sharding, global_shape):
            t = t.detach()
            t.sharding = sharding
            t.global_shape = tuple(global_shape)
            return t

        def getter():
            params = program.parameters()
            plan = _plan()
            state = self._states.get(program._serial)
            pack = program._optimizer
            opt = pack[0] if pack is not None else None
            out = {"params": {}, "slots": {}, "aux": {}}
            for i, p in enumerate(params):
                sh = plan.param_sharding(i) if plan is not None else None
                if self._shards.resting(p):
                    # it holds this rank's block already
                    out["params"][_key(i)] = _tag(p, sh, p.global_shape)
                elif sh is not None and spec_axes(sh.spec) \
                        and sh.mesh.size > 1:
                    out["params"][_key(i)] = shard_local(p.detach(), sh)
                else:
                    out["params"][_key(i)] = p.detach()
            if state is not None:
                for i, p in enumerate(params):
                    sl = state.slots.get(id(p))
                    if not sl:
                        continue
                    sh = plan.param_sharding(i) if plan is not None else None
                    shape = getattr(p, "global_shape", None) or p.shape
                    ent = {}
                    for k, v in sl.items():
                        if (sh is not None and spec_axes(sh.spec)
                                and tuple(v.shape) != tuple(shape)):
                            ent[k] = _tag(v, sh, shape)
                        else:
                            ent[k] = v.detach()
                    out["slots"][_key(i)] = ent
                if state.ef and plan is not None:
                    dp = plan.mesh.shape.get(DP_AXIS, 1)
                    from ..distributed.mesh import NamedSharding
                    sh = NamedSharding(plan.mesh, PartitionSpec(DP_AXIS))
                    out["ef"] = {
                        _key(j): _tag(r.reshape(1, -1), sh,
                                      (dp, r.shape[0]))
                        for j, r in enumerate(state.ef)}
            if opt is not None:
                pending = getattr(opt, "_static_pending_slots", None)
                for k, sl in (pending or {}).items():
                    out["slots"].setdefault(_key(int(k)), {
                        sk: torch.as_tensor(np.asarray(v))
                        for sk, v in sl.items()})
                out["aux"] = {
                    "run": torch.tensor(
                        self._run_counts.get(program._serial, 0),
                        dtype=torch.int32),
                    "step": torch.tensor(opt._step_count,
                                         dtype=torch.int32)}
            return {k: v for k, v in out.items() if v}

        def setter(tree):
            params = program.parameters()
            # the restore writes full values: ZeRO-3 params take theirs
            # back first (every rank restores together)
            self._shards.sync(params)
            ptree = tree.get("params", {})
            slots = tree.get("slots", {})
            aux = tree.get("aux", {})
            pack = program._optimizer
            opt = pack[0] if pack is not None else None
            for k, arr in ptree.items():
                i = int(k)
                if i >= len(params):
                    raise ValueError(
                        f"sharded checkpoint restore: saved param slot "
                        f"{i} but the program has {len(params)} params "
                        f"— the model structure changed since save")
                want = tuple(params[i].shape)
                got = tuple(getattr(arr, "global_shape", arr.shape))
                if want != got:
                    raise ValueError(
                        f"sharded checkpoint restore: param {i} "
                        f"('{params[i].name}') has shape {want} but the "
                        f"snapshot holds {got} — the model structure "
                        f"changed since save")
            with torch.no_grad():
                for k, arr in ptree.items():
                    p = params[int(k)]
                    p.copy_(gather_full(arr).to(p.device, p.dtype))
            state = self._states.get(program._serial)
            plan = _plan()
            if slots and opt is not None:
                staged = {}
                for k, sl in slots.items():
                    i = int(k)
                    p = params[i]
                    sh = plan.param_sharding(i) if plan is not None else None
                    sharded = (sh is not None and spec_axes(sh.spec)
                               and sh.mesh.size > 1)
                    vals = {}
                    for sk, v in sl.items():
                        full = gather_full(v)
                        if sharded and tuple(full.shape) == tuple(p.shape):
                            full = full[sh.index(tuple(full.shape))]
                        vals[sk] = full
                    live = (state.slots.get(id(p))
                            if state is not None else None)
                    if live:
                        with torch.no_grad():
                            for sk, v in vals.items():
                                live[sk].copy_(v.to(live[sk].device,
                                                    live[sk].dtype))
                    else:
                        staged[str(i)] = vals
                opt._static_pending_slots = staged or None
            ef = tree.get("ef", {})
            if ef and state is not None:
                rows = [ef[_key(j)].reshape(-1) for j in range(len(ef))]
                if (len(rows) == len(state.ef) and all(
                        r.shape == c.shape for r, c in zip(rows, state.ef))):
                    state.ef = [r.to(c.device).clone()
                                for r, c in zip(rows, state.ef)]
                else:
                    import warnings
                    warnings.warn(
                        "sharded checkpoint restore: snapshot carries "
                        "grad_comm error-feedback residuals that do not "
                        "match the live carry (mesh or bucket layout "
                        "changed) — starting from a fresh residual carry")
            if aux and opt is not None:
                opt._step_count = int(aux["step"])
                self._run_counts[program._serial] = int(aux.get("run", 0))
                if state is not None:
                    state.step.fill_(float(opt._step_count))

        def specs(name):
            parts = name.split("/")
            plan = _plan()
            if plan is None:
                return None
            if parts[0] == "ef" and len(parts) >= 2:
                return PartitionSpec(DP_AXIS)
            # slots keep the spec they were saved under (the param's,
            # when they have its shape)
            if parts[0] != "params" or len(parts) < 2:
                return None
            try:
                return plan.param_spec(int(parts[1]))
            except (ValueError, IndexError):
                return None

        return ShardedState(getter=getter, setter=setter, specs=specs)

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
            # ZeRO-3 parameters resting as this rank's rows are gathered
            # for the run (the plan's gather leg, before the forward) and
            # put back to their rows after it
            params = program.parameters()
            first = self._gather_order.get(program._serial, [])
            ids = {id(p) for p in first}
            held = self._shards.materialize(
                first + [p for p in params if id(p) not in ids])
            try:
                return self._run(program, feed, fetch_list, return_numpy,
                                 seed)
            finally:
                self._shards.release(held)
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
        plan = self._plan_for(program, params)
        # as in paddle_tpu, the kernel tier (epilogue fusion, fused
        # Adam) is off under a sharding plan
        tier = bool(get_flag("use_pallas_kernels")) and plan is None
        key = (program._serial, program._version, feed_names,
               tuple((tuple(t.shape), t.dtype) for t in feeds),
               tuple(fetch_names), program._optimizer is not None, tier,
               None if plan is None else plan.fingerprint())
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
                               fetch_names, tier, plan)
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
                "sharding": None if plan is None else plan.fingerprint(),
                "feed_signature": tuple(
                    (tuple(t.shape), str(t.dtype).replace("torch.", ""))
                    for t in feeds),
                "feed_names": feed_names,
                "fetch_set": tuple(fetch_names),
                "optimizer": program._optimizer is not None,
                "pallas": tier,
            }, predicted=step.predicted, kernels=step.kernels,
                comm=step.comm_record)
            if plan is not None:
                # replacing the mesh while this step lives would keep
                # the old placement: register the hold
                from ..distributed.mesh import register_mesh_user
                register_mesh_user(
                    step, plan.mesh, f"Executor program#{program._serial} "
                    f"(mesh {dict(plan.mesh.shape)})")
        if seed is not None:
            # every seed reproduces, negative ones too
            rng.generator(self.place).manual_seed(int(seed))
        sample = (perf.begin("executor", step.perf_identity, self.place)
                  if perf is not None and not built else None)
        t_d0 = time.perf_counter() if perf is not None else 0.0
        env = {id(v): t for v, t in zip(step.feed_vars, feeds)}
        if program._optimizer is None:
            with torch.no_grad():
                _interp(step.nodes, env, {id(p): p for p in params})
        else:
            self._train(program, params, step, env, feeds)
        if step.dist is not None and program._optimizer is not None:
            fetches = self._dist_fetches(step, env)
        else:
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
                self.place, opt._step_count, program.parameters())
            # static-mode optimizer.state_dict reads the slots here
            opt._static_state_provider = weakref.ref(state)
        return state

    def _slots(self, state, opt, tparams, targets=None):
        """The slots of ``tparams``, made at first use by
        ``functional_init`` on ``targets`` (default: the params; a
        dp-sharded param's rows under a plan), or taken from the slots a
        ``set_state_dict`` staged."""
        targets = [p.detach() for p in tparams] if targets is None \
            else targets
        fresh = [k for k, p in enumerate(tparams) if id(p) not in state.slots]
        if fresh:
            made = opt.functional_init([targets[k] for k in fresh])
            pending = getattr(opt, "_static_pending_slots", None) or {}
            for k, s in zip(fresh, made):
                pos = state.position.get(id(tparams[k]))
                staged = pending.get(str(pos)) if pos is not None else None
                if staged:
                    for sk, v in staged.items():
                        if sk in s:
                            s[sk] = torch.as_tensor(np.asarray(v)
                                                    if not isinstance(
                                                        v, torch.Tensor)
                                                    else v).to(
                                s[sk].device, s[sk].dtype).clone()
                state.slots[id(tparams[k])] = s
            if pending:
                opt._static_pending_slots = None
        return [state.slots[id(p)] for p in tparams]

    def _train(self, program, params, step: _Step, env, feeds=()):
        opt = program._optimizer[0]
        state = self._state_for(program, opt)
        tparams = [params[i] for i in step.t_idx]
        if step.dist is not None:
            return self._train_dist(program, opt, state, params, tparams,
                                    step, env, feeds)
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

    # -- the step under a sharding plan at dp > 1 --------------------------
    @staticmethod
    def _local_feeds(d: "_DistStep", feeds):
        r = d.g.rank
        out = []
        for t, spec in zip(feeds, d.feed_specs):
            if spec:
                per = t.shape[0] // d.dp
                t = t[r * per:(r + 1) * per]
            out.append(t)
        return out

    def _train_dist(self, program, opt, state, params, tparams, step,
                    env, feeds):
        """One training run on this rank's dp slice: backward, the
        grad_comm stage and the update, which writes only this rank's
        rows of a dp-sharded param."""
        from ..distributed import grad_comm as _gc
        d = step.dist
        gplan = d.gplan
        local = self._local_feeds(d, feeds)
        for v, t in zip(step.feed_vars, local):
            env[id(v)] = t
        # alias leaves (sharing the params' storage) take the gradients
        leaves = [p.detach().requires_grad_(True) for p in tparams]
        lmap = {id(p): leaf for p, leaf in zip(tparams, leaves)}
        pmap = {id(p): lmap.get(id(p), p.detach()) for p in params}
        if state.ef_key != d.plan.fingerprint() or len(state.ef) != len(
                gplan.residual_buckets):
            state.ef = [torch.zeros(_gc.bucket_flat_numel(
                b, d.dp, gplan.cfg.block_size), dtype=torch.float32,
                device=self.place) for b in gplan.residual_buckets]
            state.ef_key = d.plan.fingerprint()
        residuals = state.ef if gplan.residual_buckets else None
        path = gplan.overlap_path
        reducer = None
        # each dp rank draws its own dropout masks (rng.fold_in, as
        # paddle_tpu folds axis_index('dp') into its key)
        with rng.fold_in(d.g.rank), torch.enable_grad():
            _interp(step.nodes, env, pmap)
            loss = env[id(step.loss_var)]
            if path == "xla":
                # each bucket's first collective is issued as soon as its
                # last gradient lands, beside the rest of backward
                reducer = _gc.BucketReducer(gplan, d.g, residuals)
                hooks = [leaf.register_post_accumulate_grad_hook(
                    lambda t, k=k: reducer.arrived(k, t.grad))
                    for k, leaf in enumerate(leaves)]
                try:
                    torch.autograd.backward(loss, inputs=leaves)
                finally:
                    for h in hooks:
                        h.remove()
                grads = [leaf.grad for leaf in leaves]
            else:
                grads = list(torch.autograd.grad(loss, leaves,
                                                 allow_unused=True))
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(tparams, grads)]
        red, new_res = _gc.reduce_gradients(
            grads, plan=gplan, group=d.g, residuals=residuals, mode=path,
            issued=None if reducer is None else reducer.issued)
        if residuals is not None:
            state.ef = list(new_res)
        opt._step_count += 1
        lr = float(opt.get_lr())
        with torch.no_grad():
            state.step.add_(1.0)
            # a dp-sharded param's update writes this rank's rows, an
            # mp-cut one's its chunk, which they rest as until the next
            # run gathers them
            targets = []
            for k, p in enumerate(tparams):
                if k in d.fsdp:
                    targets.append(self._shards.rows(p, d.g))
                elif k in d.mp:
                    dim, mg = d.mp[k]
                    targets.append(self._shards.rows(p, mg, dim=dim))
                    # the reduced gradient is the full mp-invariant one:
                    # this rank keeps its chunk of it
                    red[k] = red[k].chunk(mg.nranks, dim=dim)[mg.rank]
                else:
                    targets.append(p.detach())
            slots = self._slots(state, opt, tparams, targets)
            new_p, new_s = opt.functional_update(
                targets, red, slots, lr, opt._step_count,
                params_meta=tparams)
            torch._foreach_copy_(targets, new_p)
            for old, new in zip(slots, new_s):
                for key, t in new.items():
                    old[key].copy_(t)
        self._shards.release([tparams[k] for k in sorted(d.fsdp | set(d.mp))])
        if d.comm_stats:
            from ..utils import monitor
            for name, val in d.comm_stats:
                monitor.stat_add(name, val)

    def _dist_fetches(self, step: _Step, env) -> List[torch.Tensor]:
        """The global fetches from this rank's: the mean over dp of a
        shard-invariant one, the dp slices of a batch-major one."""
        from ..distributed.grad_comm import _all_gather_rows, _psum
        d = step.dist
        out = []
        for v, rule in zip(step.fetch_vars, d.fetch_rules):
            t = env[id(v)].detach()
            if rule == "mean":
                t = _psum(t.to(torch.float32), d.g).div_(d.dp).to(t.dtype) \
                    if t.is_floating_point() else t
            else:
                rows = _all_gather_rows(t, d.g, False)
                t = rows.reshape((-1,) + tuple(t.shape[1:]))
            out.append(t)
        return out

    # -- building ----------------------------------------------------------
    def _build(self, program, params, feed_names, feeds, fetch_names,
               tier, plan=None) -> _Step:
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
            place=self.place, sharding=plan)
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
        if plan is not None:
            self._build_dist(program, params, plan, step, feeds, graph)
        return step

    def _build_dist(self, program, params, plan, step: _Step, feeds,
                    graph) -> None:
        """The plan's runtime part at dp > 1: the reduction plan (the
        strategy's grad_comm stage when :func:`grad_comm.plan_status`
        says it is active, else an fp32 plan of the same machinery), the
        dp-sharded trainables, the feeds' specs, and the fetches' rules
        from a probe of the forward (global feeds against each dp
        slice), which refuses a sum-reduced loss or fetch."""
        from ..distributed import grad_comm as _gc
        from ..distributed.collective import axis_group
        from ..distributed.mesh import DP_AXIS, MP_AXIS
        shape = dict(plan.mesh.shape)
        dp = shape.get(DP_AXIS, 1)
        status, msg = _gc.plan_status(plan)
        if status == "error":
            raise NotImplementedError(msg)
        if dp <= 1:
            return
        tparams = [params[i] for i in step.t_idx]
        shapes = [tuple(p.shape) for p in tparams]
        order = _gc.production_order(program, tparams, step.loss_var,
                                     graph=graph)
        named = [(p.name, s) for p, s in zip(tparams, shapes)]
        kinds, fsdp, gathers = _gc.hybrid_layout(plan, named, order=order)
        mp = {k: (dim, axis_group(MP_AXIS, plan.mesh))
              for k, (kind, dim) in enumerate(kinds) if kind == "mp"}
        opt = program._optimizer[0]
        if (fsdp or mp) and (opt._grad_clip is not None
                             or type(opt).__name__ in ("Lamb",
                                                       "LarsMomentum")):
            raise NotImplementedError(
                f"Executor: {type(opt).__name__}"
                f"{' with grad_clip' if opt._grad_clip is not None else ''}"
                f" over dp-sharded (ZeRO-3) or mp-cut parameters: its "
                f"per-tensor norms would be taken over this rank's rows "
                f"only.  Keep those parameters replicated (ZeRO stage <= "
                f"2, no 'mp' cut) or drop the clip")
        if status == "active":
            cfg = plan.grad_comm
        else:
            strategy = getattr(opt, "_dist_strategy", None)
            cfg = _gc.CommSpec(
                "fp32", 256, False, 0.0,
                float(getattr(strategy, "fuse_grad_size_in_MB", 32) or 32),
                "plan", "none")
        gplan = _gc.plan_reduction(shapes, dp=dp, cfg=cfg, order=order,
                                   fsdp=fsdp, gathers=gathers)
        feed_specs = [tuple(plan.feed_spec(tuple(t.shape))) for t in feeds]
        fetch_rules = self._probe_fetches(program, params, step, feeds,
                                          feed_specs, dp)
        stats = []
        if status == "active":
            stats = [("comm.wire_bytes", gplan.wire_bytes_per_step),
                     ("comm.collectives", gplan.collectives_per_step)]
            for algo, cnt in gplan.algo_counts().items():
                stats.append((f"comm.algo.{algo}", cnt))
            for i, b in enumerate(gplan.buckets):
                stats.append((f"comm.bucket.{i}.wire_bytes", b.wire_bytes))
                stats.append((f"comm.bucket.{i}.collectives",
                              b.collectives))
                stats.append((f"comm.algo.{b.algorithm}.wire_bytes",
                              b.wire_bytes))
            for ax in sorted(gplan.axis_wire_bytes):
                stats.append((f"comm.axis.{ax}.wire_bytes",
                              gplan.axis_wire_bytes[ax]))
            if gplan.gathers:
                stats.append(("comm.gather.wire_bytes",
                              gplan.gather_wire_bytes_per_step))
                stats.append(("comm.gather.collectives",
                              len(gplan.gathers)))
            step.comm_record = gplan.schedule()
        step.dist = _DistStep(plan, axis_group(DP_AXIS, plan.mesh),
                              feed_specs, fetch_rules, gplan, fsdp, stats,
                              mp)
        self._gather_order[program._serial] = [
            tparams[g["index"]] for g in gplan.gathers]
        if mp:
            # the mp gathers compose the all-gather + matmul of each
            # cut layer into this step, as paddle_tpu records it
            step.kernels.append("collective_matmul[composite]")

    def _probe_fetches(self, program, params, step: _Step, feeds,
                       feed_specs, dp) -> List[str]:
        """Each fetch's rule: ``'mean'`` when its shape on a dp slice is
        its global shape, ``'batch'`` when it is the slice of a
        batch-major global, else the cause string is raised.  The mean
        rule (and the loss) is certified by value: the global forward
        against each slice's, run here under one fixed seed (the
        device generator's state is restored after)."""
        from ..distributed import grad_comm as _gc
        gen = rng.generator(self.place)
        saved = gen.get_state()
        pmap = {id(p): p.detach() for p in params}
        probe_vars = list(step.fetch_vars)
        if not any(v is step.loss_var for v in probe_vars):
            probe_vars.append(step.loss_var)

        def run(fs):
            gen.manual_seed(0)
            env = {id(v): t for v, t in zip(step.feed_vars, fs)}
            with torch.no_grad():
                _interp(step.nodes, env, pmap)
            return [env[id(v)].double().cpu() if env[id(v)]
                    .is_floating_point() else env[id(v)].cpu()
                    for v in probe_vars]

        def slice_of(i):
            return [t[i * (t.shape[0] // dp):(i + 1) * (t.shape[0] // dp)]
                    if spec else t for t, spec in zip(feeds, feed_specs)]

        memo = []

        def randomized():
            # only asked when certification fails: does another seed
            # change the global forward?
            if not memo:
                gen.manual_seed(1)
                env = {id(v): t for v, t in zip(step.feed_vars, feeds)}
                with torch.no_grad():
                    _interp(step.nodes, env, pmap)
                memo.append(any(
                    not torch.equal(env[id(v)].double().cpu()
                                    if env[id(v)].is_floating_point()
                                    else env[id(v)].cpu(), g)
                    for v, g in zip(probe_vars, glob)))
                gen.set_state(saved)
            return memo[0]

        try:
            glob = run(feeds)
            parts = [run(slice_of(i)) for i in range(dp)]
        finally:
            gen.set_state(saved)
        rules = []
        for k, v in enumerate(probe_vars):
            go, lo = glob[k], parts[0][k]
            if tuple(lo.shape) == tuple(go.shape):
                rule = "mean"
            elif lo.dim() and tuple(go.shape) == (
                    lo.shape[0] * dp,) + tuple(lo.shape[1:]):
                rule = "batch"
            else:
                raise NotImplementedError(
                    _gc.fetch_rule_message(v.name, go.shape, lo.shape))
            if k < len(step.fetch_vars):
                rules.append(rule)
            if rule != "mean" or not go.is_floating_point():
                continue
            stack = torch.stack([p[k] for p in parts])
            mean_est, sum_est = stack.mean(0), stack.sum(0)
            scale = max(float(go.abs().max()), float(sum_est.abs().max()),
                        1e-6)
            if float((go - mean_est).abs().max()) <= 1e-3 * scale:
                continue
            what = "loss" if v is step.loss_var else "fetch"
            if float((go - sum_est).abs().max()) <= 1e-3 * scale:
                raise NotImplementedError(_gc.sum_fetch_message(what, v.name))
            if randomized():
                import warnings
                warnings.warn(
                    f"grad_comm: could not certify that {what} '{v.name}' "
                    f"is a per-shard mean (the program's random ops "
                    f"defeat the build-time probe); proceeding under the "
                    f"mean assumption — a sum-reduced {what} would be "
                    f"scaled by 1/dp.")
                continue
            raise NotImplementedError(
                f"grad_comm: {what} '{v.name}' is neither the mean nor "
                f"the sum of its per-shard values — it cannot be "
                f"reconstructed from dp shards.  Fetch batch-major or "
                f"mean-reduced tensors, or disable grad_comm.")
        return rules
