"""Sharding: partition rules, layouts, sharded trees, plans and
reshardable checkpoint state (the counterpart of
``paddle_tpu/distributed/sharding.py``).

paddle_tpu runs one controller over a GSPMD mesh, where a sharded array
is one global value.  This port runs one process per rank over
``torch.distributed``, so a sharded tensor is the rank's own block: the
local tensor, with the :class:`~.mesh.NamedSharding` it was cut by and
the global shape as attributes (``sharding``, ``global_shape``).  Every
place where paddle_tpu names a ``PartitionSpec`` the port names the same
axes (:class:`~.mesh.PartitionSpec`).

- **Partition rules** (:func:`match_partition_rules`): the first
  ``(regex, spec)`` rule that ``re.search``-matches a leaf's
  ``/``-joined name wins; scalars replicate; an unmatched non-scalar
  leaf raises with the nearest rule.
- **Layouts** (:class:`SpecLayout`), **spec helpers**
  (:func:`spec_divisor`, the spec JSON, :func:`_fit_spec_to_mesh`).
- **Trees**: :func:`shard_tree` keeps each rank's block,
  :func:`gather_tree` all-gathers them back to full numpy arrays (a
  collective: every rank calls it).
- **Plans** (:class:`ShardingPlan`, :func:`plan_for_params`): the
  per-parameter specs the static Executor and the cost model read.
- **Checkpoints** (:class:`ShardedState`): ``SnapshotStore``'s sharded
  protocol, one payload per unique block.  A save gathers the blocks of
  every rank (all ranks call it) and world rank 0 writes; a restore
  reads the files on every rank and keeps the block the live mesh gives
  it, reading only its own payload when the layouts agree.
"""
from __future__ import annotations

import difflib
import re
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.enforce import InvalidArgumentError, enforce
from .mesh import (DP_AXIS, MP_AXIS, PP_AXIS, SP_AXIS, Mesh, NamedSharding,
                   PartitionSpec, ensure_mesh, get_mesh)

__all__ = [
    "SpecLayout", "ShardingPlan", "ShardedState", "match_partition_rules",
    "named_tree_flatten", "named_tree_unflatten", "shard_tree",
    "gather_tree", "with_constraint", "spec_divisor", "spec_to_json",
    "spec_from_json", "specs_for_state", "plan_for_params", "PartitionSpec",
]

SEP = "/"
P = PartitionSpec


# ---------------------------------------------------------------------------
# named trees
# ---------------------------------------------------------------------------

def _leaf_array(leaf):
    """The tensor or array behind a leaf, or None when it is not
    array-like."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    if hasattr(leaf, "shape") and hasattr(leaf, "dtype"):
        return leaf
    return None


def named_tree_flatten(tree, sep: str = SEP) -> List[Tuple[str, object]]:
    """Flatten nested dicts / lists / tuples / [(name, leaf)] pairs to
    ``[(name, leaf)]`` with ``sep``-joined path names."""
    out: List[Tuple[str, object]] = []

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}{sep}{k}" if prefix else str(k), v)
        elif isinstance(node, (list, tuple)) and not _is_pair_list(node):
            for i, v in enumerate(node):
                walk(f"{prefix}{sep}{i}" if prefix else str(i), v)
        else:
            out.append((prefix, node))

    if _is_pair_list(tree):
        for name, leaf in tree:
            walk(str(name), leaf)
    else:
        walk("", tree)
    return out


def _is_pair_list(node) -> bool:
    return (isinstance(node, (list, tuple)) and len(node) > 0
            and all(isinstance(e, tuple) and len(e) == 2
                    and isinstance(e[0], str) for e in node))


def named_tree_unflatten(items: Sequence[Tuple[str, object]],
                         sep: str = SEP) -> dict:
    """Rebuild the nested-dict skeleton from ``[(name, leaf)]``."""
    root: dict = {}
    for name, leaf in items:
        parts = name.split(sep)
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = leaf
    return root


# ---------------------------------------------------------------------------
# partition-rule engine
# ---------------------------------------------------------------------------

def _as_spec(s) -> PartitionSpec:
    if isinstance(s, PartitionSpec):
        return s
    if s is None:
        return PartitionSpec()
    if isinstance(s, (tuple, list)):
        return PartitionSpec(*s)
    return PartitionSpec(s)


def _shape_of(arr) -> tuple:
    g = getattr(arr, "global_shape", None)
    return tuple(int(d) for d in (g if g is not None
                                  else getattr(arr, "shape", ())))


def _is_scalar(arr) -> bool:
    shape = _shape_of(arr)
    return len(shape) == 0 or int(np.prod(shape)) == 1


def _nearest_rule(name: str, rules) -> Optional[str]:
    """The rule pattern most similar to ``name`` (regex metachars
    stripped before comparing): the hint for an unmatched leaf."""
    if not rules:
        return None
    plain = {p: re.sub(r"[\\^$.|?*+()\[\]{}]", "", p) for p, _ in rules}
    return max(plain, key=lambda p: difflib.SequenceMatcher(
        None, plain[p], name).ratio())


def match_partition_rules(rules, tree, sep: str = SEP,
                          strict: bool = True):
    """Assign a spec to every leaf of a named tree.

    ``rules`` is an ORDERED sequence of ``(regex, spec)``; the first
    pattern ``re.search``-matching the leaf's ``sep``-joined name wins.
    Scalar leaves (0-dim or one element) are replicated regardless of
    rules.  A non-scalar leaf with no matching rule raises
    :class:`InvalidArgumentError` naming the leaf and the nearest rule
    (``strict=False`` downgrades to replicated).

    Returns ``[(name, spec)]`` pairs for a pair-list input, or the
    nested-dict skeleton of specs for a nested input."""
    rules = [(p, _as_spec(s)) for p, s in (rules or [])]
    items = named_tree_flatten(tree, sep=sep)
    out: List[Tuple[str, PartitionSpec]] = []
    for name, leaf in items:
        arr = _leaf_array(leaf)
        if arr is not None and _is_scalar(arr):
            out.append((name, PartitionSpec()))
            continue
        for pat, spec in rules:
            if re.search(pat, name) is not None:
                out.append((name, spec))
                break
        else:
            if strict:
                hint = _nearest_rule(name, rules)
                enforce(False, (
                    f"no partition rule matches parameter '{name}' "
                    f"({len(rules)} rule(s) tried)"
                    + (f"; nearest rule: r'{hint}'" if hint else "")
                    + " — add an explicit (regex, PartitionSpec) rule "
                    "for it (use r'.*' -> PartitionSpec() as a final "
                    "catch-all to replicate everything unmatched)"),
                    exc=InvalidArgumentError)
            out.append((name, PartitionSpec()))
    if _is_pair_list(tree):
        return out
    return named_tree_unflatten(out, sep=sep)


class SpecLayout:
    """Canonical specs per parameter family over named axes: data
    parallel 'dp' (also the fsdp/ZeRO axis), tensor parallel 'mp',
    pipeline 'pp', sequence 'sp'.  The methods are the right-hand sides
    of partition rules."""

    def __init__(self, data_axis: str = DP_AXIS, fsdp_axis: str = DP_AXIS,
                 tp_axis: str = MP_AXIS, pp_axis: str = PP_AXIS,
                 sp_axis: str = SP_AXIS):
        self.data_axis = data_axis
        self.fsdp_axis = fsdp_axis
        self.tp_axis = tp_axis
        self.pp_axis = pp_axis
        self.sp_axis = sp_axis

    def replicated(self) -> PartitionSpec:
        return PartitionSpec()

    def embedding(self) -> PartitionSpec:
        """[vocab, hidden] row-sharded over tp."""
        return PartitionSpec(self.tp_axis, None)

    def column_parallel(self) -> PartitionSpec:
        """[in, out] matmul weight split on the output dim."""
        return PartitionSpec(None, self.tp_axis)

    def row_parallel(self) -> PartitionSpec:
        """[in, out] matmul weight split on the input dim."""
        return PartitionSpec(self.tp_axis, None)

    def fsdp(self) -> PartitionSpec:
        """Dim-0 (ZeRO-3 style) shard over the fsdp axis."""
        return PartitionSpec(self.fsdp_axis)

    def norm(self) -> PartitionSpec:
        return PartitionSpec()

    def activations(self) -> PartitionSpec:
        """Batch-major runtime tensors shard over data."""
        return PartitionSpec(self.data_axis)

    def rules(self) -> List[Tuple[str, PartitionSpec]]:
        """A transformer default, first match wins: embeddings
        vocab-sharded, norms and biases replicated, 2-D weights
        fsdp-sharded on dim 0, everything else replicated."""
        return [
            (r"embedding", self.embedding()),
            (r"(^|/)(ln|norm|layer_norm|bn)[^/]*", self.norm()),
            (r"\.b_\d+$|(^|/)bias$", PartitionSpec()),
            (r"\.w_\d+$|(^|/)weight$", self.fsdp()),
            (r".*", PartitionSpec()),
        ]


# ---------------------------------------------------------------------------
# spec utilities
# ---------------------------------------------------------------------------

def spec_axes(spec) -> List[str]:
    axes: List[str] = []
    for entry in tuple(spec or ()):
        if entry is None:
            continue
        if isinstance(entry, (tuple, list)):
            axes.extend(entry)
        else:
            axes.append(entry)
    return axes


def spec_divisor(spec, mesh_shape: Dict[str, int]) -> int:
    """How many ways this spec splits a tensor on the given mesh: the
    product of the sizes of every mesh axis the spec shards over."""
    n = 1
    for a in spec_axes(spec):
        n *= int(mesh_shape.get(a, 1))
    return n


def spec_to_json(spec) -> list:
    return [list(e) if isinstance(e, (tuple, list)) else e
            for e in tuple(spec)]


def spec_from_json(data) -> PartitionSpec:
    return PartitionSpec(*[tuple(e) if isinstance(e, list) else e
                           for e in (data or [])])


def _mesh_shape(mesh) -> Dict[str, int]:
    return dict(mesh) if isinstance(mesh, dict) else dict(mesh.shape)


def _fit_spec_to_mesh(spec, shape, mesh, name: str = "",
                      downgrades=None) -> PartitionSpec:
    """Drop spec axes the mesh does not carry, and axes whose dim is
    not divisible by the axis size: the portability rule that lets one
    rule set run unchanged on any mesh size.  ``mesh`` is a live mesh or
    a plain ``{axis: size}`` dict.  Every dropped axis counts a
    ``sharding.spec_downgrades`` monitor stat; ``downgrades`` (a list)
    collects ``(dim, axis, size, reason)`` records instead of warning."""
    from ..utils import monitor
    spec = _as_spec(spec)
    mesh_shape = _mesh_shape(mesh)

    def _note(d, a, size, reason):
        monitor.stat_add("sharding.spec_downgrades")
        if downgrades is not None:
            downgrades.append((d, a, size, reason))
        elif size is not None:    # only the divisibility drop warns
            warnings.warn(reason)

    entries = []
    changed = False
    for d, entry in enumerate(tuple(spec)):
        axes = ([entry] if isinstance(entry, str)
                else list(entry) if isinstance(entry, (tuple, list))
                else [])
        kept = []
        for a in axes:
            size = mesh_shape.get(a)
            dim = int(shape[d]) if d < len(shape) else 0
            if size is None:
                changed = True
                _note(d, a, None,
                      f"sharding: '{name}' dim {d} spec names mesh axis "
                      f"'{a}' which this mesh does not carry; "
                      f"replicating that dim instead")
                continue
            if size > 1 and dim % size != 0:
                changed = True
                _note(d, a, size,
                      f"sharding: '{name}' dim {d} ({dim}) is not "
                      f"divisible by mesh axis '{a}' (size {size}); "
                      f"replicating that dim instead")
                continue
            kept.append(a)
        if not kept:
            entries.append(None)
        elif len(kept) == 1:
            entries.append(kept[0])
        else:
            entries.append(tuple(kept))
    if len(tuple(spec)) > len(shape):
        entries = entries[:len(shape)]
        changed = True
    while entries and entries[-1] is None:
        entries.pop()
    return PartitionSpec(*entries) if changed else spec


def specs_for_state(param_specs, state, param_shapes=None):
    """Optimizer-state specs inheriting from the params they belong to:
    a slot whose shape equals the param's inherits its spec (Adam m/v
    shard like their param under ZeRO); scalars and other shapes
    replicate.  Without ``param_shapes`` any non-scalar slot
    inherits."""
    out = []
    for i, (spec, slots) in enumerate(zip(param_specs, state)):
        entry = {}
        p_shape = (tuple(param_shapes[i]) if param_shapes is not None
                   else None)
        for k, v in (slots or {}).items():
            arr = _leaf_array(v)
            inherits = (arr is not None and not _is_scalar(arr)
                        and len(spec_axes(spec)) > 0)
            if inherits and p_shape is not None \
                    and _shape_of(arr) != p_shape:
                inherits = False
            entry[k] = _as_spec(spec) if inherits else PartitionSpec()
        out.append(entry)
    return out


# ---------------------------------------------------------------------------
# tree placement
# ---------------------------------------------------------------------------

def _as_torch(arr) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):
        return arr
    return torch.as_tensor(np.asarray(arr))


def shard_local(arr, sharding: NamedSharding) -> torch.Tensor:
    """This rank's block of the full ``arr`` under ``sharding``, tagged
    with ``sharding`` and ``global_shape``."""
    t = _as_torch(arr)
    shape = tuple(t.shape)
    block = t[sharding.index(shape)]
    if spec_axes(sharding.spec):
        block = block.clone()
    if isinstance(t, torch.Tensor) and type(t) is not torch.Tensor:
        block.__class__ = type(t)
    block.sharding = sharding
    block.global_shape = shape
    return block


def gather_full(arr) -> torch.Tensor:
    """The full value of a (possibly) sharded tensor: its blocks from
    every rank of the job, assembled (a collective when it is sharded:
    every rank must call it)."""
    sh = getattr(arr, "sharding", None)
    t = _as_torch(arr)
    if sh is None or not spec_axes(sh.spec) or sh.mesh.size == 1:
        return t
    import torch.distributed as dist
    shape = tuple(arr.global_shape)
    parts = [torch.empty_like(t) for _ in range(sh.mesh.size)]
    dist.all_gather(parts, t.contiguous())
    out = t.new_empty(shape)
    for r, part in enumerate(parts):
        out[sh.index(shape, r)] = part
    return out


def shard_tree(tree, specs=None, mesh: Optional[Mesh] = None,
               rules=None, sep: str = SEP):
    """Keep this rank's block of every leaf of a named tree, cut by its
    spec over ``mesh``.  ``specs`` may be a matching tree / pair-list /
    dict of name->spec; or pass ``rules`` to derive specs through
    :func:`match_partition_rules`.  With neither, leaves replicate."""
    mesh = mesh or ensure_mesh()
    items = named_tree_flatten(tree, sep=sep)
    if rules is not None:
        spec_of = dict(match_partition_rules(
            rules, [(n, l) for n, l in items], sep=sep))
    elif specs is not None:
        if isinstance(specs, dict) and not any(
                isinstance(v, dict) for v in specs.values()):
            spec_of = {n: _as_spec(s) for n, s in specs.items()}
        else:
            spec_of = {n: _as_spec(s)
                       for n, s in named_tree_flatten(specs, sep=sep)}
    else:
        spec_of = {}
    out = []
    for name, leaf in items:
        arr = _leaf_array(leaf)
        if arr is None:
            out.append((name, leaf))
            continue
        spec = spec_of.get(name, PartitionSpec())
        spec = _fit_spec_to_mesh(spec, _shape_of(arr), mesh, name)
        out.append((name, shard_local(arr, NamedSharding(mesh, spec))))
    if _is_pair_list(tree):
        return out
    return named_tree_unflatten(out, sep=sep)


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return np.asarray(t)


def gather_tree(tree, sep: str = SEP):
    """Every leaf as a full host ``np.ndarray`` (the read side of
    :func:`shard_tree`; a collective for sharded leaves)."""
    items = named_tree_flatten(tree, sep=sep)
    out = [(n, _to_numpy(gather_full(l)) if _leaf_array(l) is not None
            else l) for n, l in items]
    if _is_pair_list(tree):
        return out
    return named_tree_unflatten(out, sep=sep)


def with_constraint(x, *spec, mesh: Optional[Mesh] = None):
    """Pin an activation's layout.  Each rank of this port already holds
    what its program computes, so a constraint moves nothing: ``x`` is
    returned as it is (paddle_tpu's eager call is the identity too
    outside a traced program)."""
    del spec, mesh
    return x


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

class ShardingPlan:
    """(mesh, per-param specs, batch axes) for one ordered param list.

    The static Executor runs a program's state by it and the cost model
    prices a program per shard through :meth:`divisor`."""

    __slots__ = ("mesh", "param_names", "param_specs", "batch_axes",
                 "label", "grad_comm", "_fp")

    def __init__(self, mesh: Mesh, param_names: Sequence[str],
                 param_specs: Sequence, batch_axes: Sequence[str] = (DP_AXIS,),
                 label: str = "", grad_comm=None):
        self.mesh = mesh
        self.param_names = list(param_names)
        self.param_specs = [_as_spec(s) for s in param_specs]
        self.batch_axes = tuple(a for a in batch_axes if a in mesh.shape)
        self.label = label
        # the resolved grad_comm.CommSpec (or None): part of the
        # build identity below
        self.grad_comm = grad_comm
        self._fp = None

    def fingerprint(self) -> tuple:
        """Hashable identity for the Executor's step cache: a mesh or a
        spec change must rebuild."""
        if self._fp is None:
            self._fp = (tuple(self.mesh.shape.items()),
                        tuple(int(r) for r in self.mesh.ranks.flat),
                        tuple(str(s) for s in self.param_specs),
                        self.batch_axes,
                        (None if self.grad_comm is None
                         else self.grad_comm.fingerprint()))
        return self._fp

    @property
    def n_devices(self) -> int:
        return int(self.mesh.size)

    def _ns(self, spec) -> NamedSharding:
        return NamedSharding(self.mesh, _as_spec(spec))

    def param_spec(self, i: int) -> PartitionSpec:
        return self.param_specs[i]

    def param_sharding(self, i: int) -> NamedSharding:
        return self._ns(self.param_specs[i])

    def replicated(self) -> NamedSharding:
        return self._ns(PartitionSpec())

    def feed_spec(self, shape) -> PartitionSpec:
        """Batch feeds shard dim 0 over the batch axes when divisible;
        anything else replicates."""
        if not self.batch_axes or not shape:
            return PartitionSpec()
        n = self.batch_divisor()
        if int(shape[0]) % n != 0:
            return PartitionSpec()
        entry = (self.batch_axes[0] if len(self.batch_axes) == 1
                 else tuple(self.batch_axes))
        return PartitionSpec(entry)

    def feed_sharding(self, shape) -> NamedSharding:
        return self._ns(self.feed_spec(shape))

    def divisor(self, spec) -> int:
        return spec_divisor(_as_spec(spec), dict(self.mesh.shape))

    def batch_divisor(self) -> int:
        n = 1
        for a in self.batch_axes:
            n *= self.mesh.shape[a]
        return n

    def spec_by_name(self, name: str) -> Optional[PartitionSpec]:
        try:
            return self.param_specs[self.param_names.index(name)]
        except ValueError:
            return None

    def __repr__(self):
        sharded = sum(1 for s in self.param_specs if spec_axes(s))
        return (f"ShardingPlan(mesh={dict(self.mesh.shape)}, "
                f"params={len(self.param_specs)} ({sharded} sharded), "
                f"batch_axes={self.batch_axes})")


def plan_for_params(named_params, strategy=None, mesh: Optional[Mesh] = None,
                    rules=None, label: str = "") -> ShardingPlan:
    """A :class:`ShardingPlan` for ``[(name, param)]``.

    Per-param resolution order:

    1. explicit ``placement`` metadata (tensor-parallel layers);
    2. ``rules`` (or ``strategy.sharding_rules``) through the rule
       engine: unmatched non-scalar names are a hard error;
    3. default: replicated, except ZeRO-3 (``strategy.sharding`` stage
       >= 3), which shards dim 0 over 'dp' for params of at least
       ``min_shard_numel`` elements whose dim 0 divides by dp.

    Specs are then fitted to the mesh (axes it does not carry, or
    non-divisible dims, replicate)."""
    from ..parallel.tp_layers import get_placement
    mesh = mesh or ensure_mesh()
    if rules is None and strategy is not None:
        rules = getattr(strategy, "sharding_rules", None)
    names = [n for n, _ in named_params]
    arrays = [_leaf_array(p) for _, p in named_params]

    rule_specs: Dict[str, PartitionSpec] = {}
    if rules is not None:
        unplaced = [(n, p) for n, p in named_params
                    if get_placement(p) is None]
        rule_specs = dict(match_partition_rules(rules, unplaced))

    z3 = (strategy is not None and getattr(strategy, "sharding", False)
          and strategy.sharding_configs.stage >= 3
          and DP_AXIS in mesh.shape)
    min_numel = strategy.sharding_configs.min_shard_numel if z3 else 0
    dp = mesh.shape.get(DP_AXIS, 1)

    specs: List[PartitionSpec] = []
    for (name, p), arr in zip(named_params, arrays):
        pl = get_placement(p)
        if pl is not None:
            spec = _as_spec(pl)
        elif name in rule_specs:
            spec = rule_specs[name]
        elif (z3 and arr is not None and not _is_scalar(arr)
              and int(np.prod(_shape_of(arr))) >= min_numel
              and _shape_of(arr)[0] % dp == 0):
            spec = PartitionSpec(DP_AXIS)
        else:
            spec = PartitionSpec()
        shape = _shape_of(arr) if arr is not None else ()
        specs.append(_fit_spec_to_mesh(spec, shape, mesh, name))
    from . import grad_comm as _gc
    return ShardingPlan(mesh, names, specs, label=label,
                        grad_comm=_gc.resolve(strategy))


# ---------------------------------------------------------------------------
# ZeRO-3 parameters at rest
# ---------------------------------------------------------------------------

class ParamShards:
    """Sharded parameters between steps: each holds only this rank's
    block along one dim (ZeRO-3: the dim-0 rows over 'dp'; a
    tensor-parallel parameter of the hybrid static step: its chunk over
    'mp'), and a step gathers them back just before its forward.

    While a parameter rests, its ``data`` is the block (dim 0 padded to
    a multiple of the group's size where given) and it carries the
    ``global_shape`` it stands for, as every sharded tensor of the port
    does; the static analysis prices it by that shape.  The block is
    what the update writes.

    - :meth:`rows` gives the block the update writes: the stored one,
      or, when the parameter holds its full value (its first step, or
      after :meth:`sync`), a copy of this rank's block of it;
    - :meth:`materialize` gathers every resting parameter's blocks from
      the ranks of its group into a full value for one step (a
      collective: every rank calls it, in the same order);
    - :meth:`release` puts each parameter back to its block;
    - :meth:`sync` (``sync_params``) gathers them for good: the
      parameters hold their full values again and are what the next
      step reads, so an outside write into them is kept.

    Each resting parameter names this store as its
    ``_param_owner_step``: ``Layer.state_dict`` and ``set_state_dict``
    call :meth:`sync_params` first, as paddle_tpu's do."""

    def __init__(self):
        # id(p) -> [p, block, d0, padded d0, group, dim]
        self._ent: Dict[int, list] = {}

    def resting(self, p) -> bool:
        """True while ``p`` holds only its block."""
        e = self._ent.get(id(p))
        return (e is not None and tuple(p.shape) == tuple(e[1].shape)
                and p.data_ptr() == e[1].data_ptr())

    def rows(self, p, group, padded_d0: Optional[int] = None,
             dim: int = 0):
        e = self._ent.get(id(p))
        if e is not None:
            return e[1]
        n, r = group.nranks, group.rank
        t = p.detach()
        dim = dim % t.dim()
        d0 = int(t.shape[dim])
        pd0 = int(padded_d0 or d0)
        if pd0 != d0:              # dim 0 only (ZeRO-3's padded rows)
            t = torch.nn.functional.pad(
                t, [0, 0] * (t.dim() - 1) + [0, pd0 - d0])
        per = pd0 // n
        rows = t.narrow(dim, r * per, per).clone()
        self._ent[id(p)] = [p, rows, d0, pd0, group, dim]
        return rows

    def _full(self, e):
        import torch.distributed as dist
        p, rows, d0, pd0, g, dim = e
        if dim == 0:
            full = rows.new_empty((pd0,) + tuple(rows.shape[1:]))
            dist.all_gather(list(full.chunk(g.nranks)), rows.contiguous(),
                            group=g.process_group)
            return full[:d0] if pd0 != d0 else full
        parts = [torch.empty_like(rows) for _ in range(g.nranks)]
        dist.all_gather(parts, rows.contiguous(), group=g.process_group)
        return torch.cat(parts, dim=dim)

    def materialize(self, params) -> list:
        """Gather each resting parameter of ``params``, in their order;
        returns them."""
        out = []
        for p in params:
            if self.resting(p):
                e = self._ent[id(p)]
                p.data = self._full(e)
                p.__dict__.pop("global_shape", None)
                out.append(p)
        return out

    def release(self, params) -> None:
        import weakref
        for p in params:
            e = self._ent.get(id(p))
            if e is None or self.resting(p):
                continue
            p.data = e[1]
            shape = list(e[1].shape)
            shape[e[5]] = e[2]
            p.global_shape = tuple(shape)
            p._param_owner_step = weakref.ref(self)

    def sync(self, params=None) -> None:
        """The full values back into ``params`` (default: every one
        held), which then own them (a collective)."""
        params = ([e[0] for e in self._ent.values()] if params is None
                  else [p for p in params if id(p) in self._ent])
        self.materialize(params)
        for p in params:
            del self._ent[id(p)]
            p.__dict__.pop("_param_owner_step", None)

    sync_params = sync

    def rows_of(self, p):
        """The stored rows of ``p`` (None when it holds its full
        value)."""
        e = self._ent.get(id(p))
        return None if e is None else e[1]


# ---------------------------------------------------------------------------
# reshardable checkpoint state (SnapshotStore's sharded protocol)
# ---------------------------------------------------------------------------

def _index_json(index) -> list:
    return [[int(sl.start), int(sl.stop)] for sl in index]


def _index_key(index) -> tuple:
    return tuple((int(sl.start), int(sl.stop)) for sl in index)


def _np_dtype_name(t) -> str:
    if isinstance(t, torch.Tensor):
        from ..core.dtype import dtype_name
        return dtype_name(t.dtype)
    return str(np.dtype(t.dtype))


class ShardedState:
    """A named tree of (possibly sharded) tensors as a SnapshotStore
    object with one payload per unique block.

    ``SnapshotStore.save`` calls :meth:`shard_state`: a JSON manifest
    (global shape and dtype, the spec and the mesh shape each leaf was
    saved under) and one payload per unique block, each given its own
    sha256 digest by the store.  The blocks of every rank are gathered
    first, so every rank of the job calls it.  ``restore`` calls
    :meth:`load_shard_state` under whatever mesh is then live:

    - layouts agree (same mesh shape, same spec): **gather-free**, each
      rank takes its own block's payload (stat
      ``sharding.restore.gather_free``);
    - layouts differ: the blocks are assembled into the global value on
      the host and each rank keeps the block the live mesh gives it
      (stat ``sharding.restore.resharded``).

    Construct over a live ``tree``, or with ``getter``/``setter``
    callables for state read and applied at save/restore time (the
    Executor's).  ``specs`` optionally pins restore placement by name
    (a dict or a callable); the default is the saved spec fitted to the
    live mesh."""

    def __init__(self, tree=None, *, getter: Optional[Callable] = None,
                 setter: Optional[Callable] = None, specs=None,
                 mesh: Optional[Mesh] = None, sep: str = SEP):
        self.tree = tree
        self._getter = getter
        self._setter = setter
        self._specs = specs
        self._mesh = mesh
        self._sep = sep

    # -- save side ---------------------------------------------------------
    def _current_tree(self):
        return self._getter() if self._getter is not None else self.tree

    def shard_state(self):
        """-> (manifest dict, {fname: payload bytes})."""
        from ..framework_io import dumps
        import torch.distributed as dist
        items = named_tree_flatten(self._current_tree(), sep=self._sep)
        manifest = {"version": 1, "sep": self._sep, "leaves": []}
        payloads: Dict[str, bytes] = {}
        for li, (name, leaf) in enumerate(items):
            arr = _leaf_array(leaf)
            if arr is None:
                arr = np.asarray(leaf)
            sh = getattr(arr, "sharding", None)
            shape = _shape_of(arr)
            entry = {"name": name, "shape": list(shape),
                     "dtype": _np_dtype_name(arr),
                     "spec": spec_to_json(PartitionSpec()),
                     "mesh": {}, "shards": []}
            blocks = []
            if sh is not None and spec_axes(sh.spec):
                entry["spec"] = spec_to_json(sh.spec)
                entry["mesh"] = {str(k): int(v)
                                 for k, v in sh.mesh.shape.items()}
                t = _as_torch(arr).contiguous()
                if sh.mesh.size > 1:
                    parts = [torch.empty_like(t)
                             for _ in range(sh.mesh.size)]
                    dist.all_gather(parts, t)
                else:
                    parts = [t]
                seen = set()
                for r, part in enumerate(parts):
                    index = sh.index(shape, r)
                    key = _index_key(index)
                    if key in seen:
                        continue    # replicas: one payload per block
                    seen.add(key)
                    blocks.append((index, _to_numpy(part)))
            else:
                full = tuple(slice(0, int(d)) for d in shape)
                blocks.append((full, _to_numpy(arr)))
            for k, (index, data) in enumerate(blocks):
                fname = f"{li:04d}_{k:04d}.shard"
                payloads[fname] = dumps({"data": data})
                entry["shards"].append({"file": fname,
                                        "index": _index_json(index)})
            manifest["leaves"].append(entry)
        return manifest, payloads

    # -- restore side ------------------------------------------------------
    def _target_spec(self, name, saved_spec, shape, mesh):
        if self._specs is not None:
            sp = (self._specs(name) if callable(self._specs)
                  else self._specs.get(name))
            if sp is not None:
                return _fit_spec_to_mesh(_as_spec(sp), shape, mesh, name)
        return _fit_spec_to_mesh(saved_spec, shape, mesh, name)

    def load_shard_state(self, manifest: dict, payloads: Dict[str, object]):
        """Rebuild the tree on the live mesh and apply it (through
        ``setter`` when given, else replacing ``self.tree``).  Payload
        values may be raw bytes or already-decoded payload dicts.
        Returns the rebuilt tree."""
        from ..framework_io import loads
        from ..utils import monitor

        def data_of(fname):
            p = payloads[fname]
            if isinstance(p, (bytes, bytearray)):
                p = loads(bytes(p))
            d = p["data"]
            return d.numpy() if isinstance(d, torch.Tensor) else np.asarray(d)

        sep = manifest.get("sep", self._sep)
        mesh = self._mesh or get_mesh()
        items: List[Tuple[str, object]] = []
        for entry in manifest["leaves"]:
            name = entry["name"]
            shape = tuple(int(d) for d in entry["shape"])
            dtype = entry["dtype"]
            saved_spec = spec_from_json(entry["spec"])
            saved_mesh = {k: int(v) for k, v in entry["mesh"].items()}
            shards = [(tuple(slice(a, b) for a, b in sh["index"]),
                       sh["file"]) for sh in entry["shards"]]
            if mesh is None:
                items.append((name, _to_tensor(_assemble(
                    shape, dtype, [(i, data_of(f)) for i, f in shards]),
                    dtype)))
                continue
            target = self._target_spec(name, saved_spec, shape, mesh)
            sharding = NamedSharding(mesh, target)
            mine = _index_key(sharding.index(shape))
            by_key = {_index_key(i): f for i, f in shards}
            if (saved_mesh == {str(k): int(v)
                               for k, v in mesh.shape.items()}
                    and tuple(target) == tuple(saved_spec)
                    and mine in by_key):
                block = _to_tensor(data_of(by_key[mine]), dtype)
                monitor.stat_add("sharding.restore.gather_free")
            else:
                full = _assemble(shape, dtype,
                                 [(i, data_of(f)) for i, f in shards])
                block = _to_tensor(full[sharding.index(shape)], dtype)
                monitor.stat_add("sharding.restore.resharded")
            if spec_axes(target):
                block.sharding = sharding
                block.global_shape = shape
            items.append((name, block))
        tree = named_tree_unflatten(items, sep=sep)
        if self._setter is not None:
            self._setter(tree)
        else:
            self.tree = tree
        return tree


def _to_tensor(a: np.ndarray, dtype: str) -> torch.Tensor:
    from ..core.dtype import convert_dtype
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(convert_dtype(dtype))


def _assemble(shape, dtype, shards) -> np.ndarray:
    if len(shards) == 1 and tuple(shards[0][1].shape) == tuple(shape):
        return shards[0][1]
    out = np.empty(shape, shards[0][1].dtype if shards else np.float32)
    for index, data in shards:
        out[index] = data
    return out
