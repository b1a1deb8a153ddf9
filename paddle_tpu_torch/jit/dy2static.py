"""dy2static AST conversion: Python ``if``/``while`` on tensor
predicates -> ``cond``/``while_loop`` (the counterpart of
``paddle_tpu/jit/dy2static.py``; the AST passes are the same).

A converted function runs eagerly under ``jit.to_static`` and is
captured by ``torch.export`` under ``jit.save``.  The runtime helpers
below route every TENSOR predicate through :mod:`..ops.control_flow`:
eagerly that reads the predicate and runs one branch (or loops in
Python, each iteration on torch's tape), and while ``torch.export``
traces it lowers to ``torch.cond`` and torch's ``while_loop``, so the
saved graph keeps both branches and a data-dependent trip count.
Python (non-tensor) predicates keep Python's semantics exactly.
Anything the transformer cannot prove convertible is left untouched; a
tensor ``if`` left in the code then raises the tensor-bool TypeError
inside ``to_static`` (``core.tensor``), pointing at paddle.cond.

The patterns converted:

1. ``if cond: <assignments>  else: <assignments>`` where both branches
   assign the same simple names -> both branches become closures
   returning those names, dispatched through :func:`_jst_cond`;
2. ``if cond: return A`` followed by ``return B`` (and the two-armed
   ``if/else`` with lone returns) -> ``return _jst_cond(cond, ...)``;
3. ``while <test>: <assign-only body>`` -> carried-variable closures
   dispatched through :func:`_jst_while`;
4. ``for i in range(...): <assign-only body>`` -> the same, with a
   synthetic counter carry (``range`` over a tensor bound works after
   conversion);
5. exit-ifs -- ``if c: [assignments;] break|continue|return <expr>`` --
   at any position in the loop body, any number of them: statements
   after an exit-if become the else-branch of a nested ``_jst_cond``,
   break/return ride a carried done-flag in the loop test, and an early
   ``return`` carries a value slot surfaced as ``if flag: return
   value`` after the loop;
6. calls to user functions (bare names resolvable at conversion time)
   are routed through ``_jst_call``: the callee is converted too,
   lazily and memoized;
7. ``print``, ``int/float/bool(x)``, ``assert`` and ``and``/``or``/
   ``not`` route through converters that keep Python's semantics for
   Python values and act on tensors as tensors.

Loop-carried variables follow the reference's rule: every assigned name
that is read by the loop test, read before it is written in the body, or
read after the loop must be bound before the loop.  While exporting,
the carried values are tensors (a Python number becomes a 0-d tensor).
"""
from __future__ import annotations

import ast
import functools
import inspect
import itertools
import sys
import textwrap
import types
from typing import Callable, List, Optional, Set

import torch

__all__ = ["convert_control_flow", "_jst_cond", "_jst_while"]

_SERIALS = itertools.count(1)


def _is_tensor(v) -> bool:
    return isinstance(v, torch.Tensor)


def _wrap(t):
    from ..core.tensor import wrap
    return wrap(t)


def _as_tensor(v, like):
    from ..ops.control_flow import scalar_tensor
    return v if _is_tensor(v) else scalar_tensor(v, like.device)


def _jst_cond(pred, true_fn, false_fn):
    """Runtime dispatch for converted ifs: ``ops.control_flow.cond`` on
    a tensor predicate, Python's branch on any other."""
    if _is_tensor(pred):
        from ..ops.control_flow import cond
        return cond(pred, true_fn, false_fn)
    return true_fn() if pred else false_fn()


def _logical(op, a, b):
    like = a if _is_tensor(a) else b
    return _wrap(op(_as_tensor(a, like).bool(), _as_tensor(b, like).bool()))


def _jst_not(x):
    if _is_tensor(x):
        return _wrap(torch.logical_not(x))
    return not x


def _jst_and(a, b):
    if _is_tensor(a) or _is_tensor(b):
        return _logical(torch.logical_and, a, b)
    return bool(a) and bool(b)


def _jst_or(a, b):
    if _is_tensor(a) or _is_tensor(b):
        return _logical(torch.logical_or, a, b)
    return bool(a) or bool(b)


def _jst_land(l_fn, r_fn):
    """``a and b`` thunked so the right operand only evaluates when
    Python would evaluate it; tensor operands give
    ``torch.logical_and``, Python ones keep Python's ``and`` (returning
    the operand, not a bool)."""
    a = l_fn()
    if _is_tensor(a):
        return _logical(torch.logical_and, a, r_fn())
    if not a:
        return a
    b = r_fn()
    if _is_tensor(b):
        return _logical(torch.logical_and, True, b)
    return b


def _jst_lor(l_fn, r_fn):
    """``a or b``, as :func:`_jst_land`."""
    a = l_fn()
    if _is_tensor(a):
        return _logical(torch.logical_or, a, r_fn())
    if a:
        return a
    b = r_fn()
    if _is_tensor(b):
        return _logical(torch.logical_or, False, b)
    return b


def _jst_lt(a, b):
    return a < b


def _jst_while(cond_fn, body_fn, init):
    """Runtime dispatch for converted loops: a Python loop when the
    predicate and every carried value are Python values,
    ``ops.control_flow.while_loop`` when any is a tensor."""
    vals = tuple(init)
    c = cond_fn(*vals)
    if _is_tensor(c) or any(_is_tensor(v) for v in vals):
        from ..ops.control_flow import while_loop
        out = while_loop(cond_fn, lambda *a: tuple(body_fn(*a)),
                         list(vals))
        return tuple(out)
    while c:
        vals = tuple(body_fn(*vals))
        c = cond_fn(*vals)
    return vals


def _loads(node) -> Set[str]:
    return {n.id for n in ast.walk(node)
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)}


def _assigned_names(stmts: List[ast.stmt]):
    """Analyse a branch body of simple assignments.

    Returns ``(assigned, prebind)`` — the simple names the body assigns,
    and the subset it READS before assigning (incl. ``x = x + 1`` /
    ``x += 1``), which the branch closure receives as default-argument
    snapshots.  Returns ``None`` for anything non-trivial (attribute or
    subscript targets, nested control flow)."""
    all_assigned: Set[str] = set()
    for s in stmts:
        if isinstance(s, ast.Assign):
            for t in s.targets:
                if isinstance(t, ast.Name):
                    all_assigned.add(t.id)
                elif isinstance(t, ast.Tuple) and all(
                        isinstance(e, ast.Name) for e in t.elts):
                    all_assigned.update(e.id for e in t.elts)
                else:
                    return None
        elif isinstance(s, ast.AugAssign):
            if not isinstance(s.target, ast.Name):
                return None
            all_assigned.add(s.target.id)
        elif not isinstance(s, ast.Expr):
            return None
    assigned_so_far: Set[str] = set()
    prebind: Set[str] = set()
    for s in stmts:
        if isinstance(s, ast.Assign):
            prebind |= (_loads(s.value) & all_assigned) - assigned_so_far
            for t in s.targets:
                if isinstance(t, ast.Name):
                    assigned_so_far.add(t.id)
                else:
                    assigned_so_far.update(e.id for e in t.elts)
        elif isinstance(s, ast.AugAssign):
            if s.target.id not in assigned_so_far:
                prebind.add(s.target.id)
            prebind |= (_loads(s.value) & all_assigned) - assigned_so_far
            assigned_so_far.add(s.target.id)
        elif isinstance(s, ast.Expr):
            prebind |= (_loads(s) & all_assigned) - assigned_so_far
    return all_assigned, prebind


class _IfElseTransformer(ast.NodeTransformer):
    """reference: dygraph_to_static/ifelse_transformer.py."""

    def __init__(self):
        self.count = 0
        self.converted = 0

    # -- pattern 2: early return --------------------------------------------
    def _convert_return_pair(self, test, a_ret, b_ret):
        self.converted += 1
        t = ast.Lambda(
            args=ast.arguments(posonlyargs=[], args=[], kwonlyargs=[],
                               kw_defaults=[], defaults=[]),
            body=a_ret.value or ast.Constant(None))
        f = ast.Lambda(
            args=ast.arguments(posonlyargs=[], args=[], kwonlyargs=[],
                               kw_defaults=[], defaults=[]),
            body=b_ret.value or ast.Constant(None))
        call = ast.Call(func=ast.Name("_jst_cond", ast.Load()),
                        args=[test, t, f], keywords=[])
        return ast.Return(value=call)

    def _rewrite_body(self, body: List[ast.stmt],
                      bound: Set[str]) -> List[ast.stmt]:
        """Rewrite one statement list, tracking ``bound`` — names
        DEFINITELY bound at each point (needed to know whether a branch's
        read-before-write names can be prebound as argument defaults)."""
        out: List[ast.stmt] = []
        i = 0
        while i < len(body):
            s = body[i]
            if isinstance(s, ast.If):
                nxt = body[i + 1] if i + 1 < len(body) else None
                # `if c: return A` / `return B`  (tail follows the if)
                if (len(s.body) == 1 and isinstance(s.body[0], ast.Return)
                        and not s.orelse and isinstance(nxt, ast.Return)):
                    out.append(self._convert_return_pair(
                        s.test, s.body[0], nxt))
                    i += 2
                    continue
                # `if c: return A else: return B`
                if (len(s.body) == 1 and isinstance(s.body[0], ast.Return)
                        and len(s.orelse) == 1
                        and isinstance(s.orelse[0], ast.Return)):
                    out.append(self._convert_return_pair(
                        s.test, s.body[0], s.orelse[0]))
                    i += 1
                    continue
                conv = self._convert_assign_if(s, bound)
                if conv is not None:
                    out.extend(conv)
                    for t in conv:
                        if isinstance(t, ast.Assign):
                            bound |= _stores(t)
                    i += 1
                    continue
                # unconverted if: recurse; only names assigned in BOTH
                # arms are definitely bound after it
                s.body = self._rewrite_body(s.body, set(bound))
                s.orelse = self._rewrite_body(s.orelse, set(bound))
                bs = set()
                for t in s.body:
                    bs |= _stores(t)
                os_ = set()
                for t in s.orelse:
                    os_ |= _stores(t)
                bound |= (bs & os_) if s.orelse else set()
                out.append(s)
                i += 1
                continue
            if isinstance(s, (ast.While, ast.For)):
                # loop bodies: rewrite with a copy (their stores are only
                # conditionally bound afterwards)
                s.body = self._rewrite_body(s.body, set(bound))
                s.orelse = self._rewrite_body(s.orelse, set(bound))
                out.append(s)
                i += 1
                continue
            out.append(s)
            if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
                bound.add(s.name)     # not the names stored INSIDE it
            else:
                bound |= _stores(s)
            i += 1
        return out

    # -- pattern 1: both-branch assignments ---------------------------------
    def _convert_assign_if(self, node: ast.If,
                           bound: Set[str]) -> Optional[List[ast.stmt]]:
        ra = _assigned_names(node.body)
        if ra is None:
            return None
        if node.orelse:
            rb = _assigned_names(node.orelse)
            if rb is None:
                return None
        else:
            # single-arm if: synthesize an identity else — legal only
            # when every assigned name is provably bound before the if
            # (the else branch "assigns" each name to itself)
            rb = (ra[0], set(ra[0]))
        (a, pre_a), (b, pre_b) = ra, rb
        if not a or a != b:
            return None
        prebind = sorted(pre_a | pre_b)
        if any(p not in bound for p in prebind):
            # a read-before-write name not provably bound before the if:
            # the default-argument snapshot would evaluate eagerly and
            # raise where plain Python (branch not taken) would not
            return None
        targets = sorted(a)
        self.count += 1
        n = self.count
        ret = ast.Return(value=ast.Tuple(
            elts=[ast.Name(t, ast.Load()) for t in targets],
            ctx=ast.Load()))

        def mk(name, stmts):
            # names read before assignment arrive as default-argument
            # snapshots (`def t(s=s): s = s + x; ...`), sidestepping the
            # closure-local UnboundLocalError
            return ast.FunctionDef(
                name=name,
                args=ast.arguments(
                    posonlyargs=[],
                    args=[ast.arg(arg=p) for p in prebind],
                    kwonlyargs=[], kw_defaults=[],
                    defaults=[ast.Name(p, ast.Load()) for p in prebind]),
                body=list(stmts) + [ret], decorator_list=[])

        call = ast.Call(func=ast.Name("_jst_cond", ast.Load()),
                        args=[node.test,
                              ast.Name(f"__jst_true_{n}", ast.Load()),
                              ast.Name(f"__jst_false_{n}", ast.Load())],
                        keywords=[])
        assign = ast.Assign(
            targets=[ast.Tuple(
                elts=[ast.Name(t, ast.Store()) for t in targets],
                ctx=ast.Store())],
            value=call)
        self.converted += 1
        return [mk(f"__jst_true_{n}", node.body),
                mk(f"__jst_false_{n}", node.orelse), assign]

    def visit_FunctionDef(self, node):
        self.generic_visit(node)   # nested defs rewrite themselves
        args = node.args
        bound = {a.arg for a in (args.posonlyargs + args.args
                                 + args.kwonlyargs)}
        for extra in (args.vararg, args.kwarg):
            if extra is not None:
                bound.add(extra.arg)
        node.body = self._rewrite_body(node.body, bound)
        return node


def _stores(node) -> Set[str]:
    return {n.id for n in ast.walk(node)
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store)}


class _LoopTransformer(ast.NodeTransformer):
    """reference: loop_transformer.py + break_continue_transformer.py.

    Converts ``while``/``for-range`` whose bodies are assignment-only
    (after the if-transformer has run) into carried-closure ``_jst_while``
    dispatch, with a single leading ``if c: break/continue`` or trailing
    ``if c: break`` lowered to a carried done-flag + predicated updates.
    """

    _OK_STMTS = (ast.Assign, ast.AugAssign, ast.Expr, ast.FunctionDef)

    def __init__(self):
        self.count = 0
        self.converted = 0
        self._prior_stores: Set[str] = set()

    # -- analysis ---------------------------------------------------------
    def _body_ok(self, stmts) -> bool:
        for s in stmts:
            if self._exit_kind(s):
                # exit-ifs are handled by _emit's branch nesting; their
                # payloads are assignment-only by construction
                continue
            if not isinstance(s, self._OK_STMTS):
                return False
            if isinstance(s, ast.Expr) and not isinstance(
                    s.value, ast.Constant):
                # converted print/assert statements are safe inside a
                # loop body (they act on tensors as tensors)
                if (isinstance(s.value, ast.Call)
                        and isinstance(s.value.func, ast.Name)
                        and s.value.func.id in ("_jst_print",
                                                "_jst_assert")):
                    continue
                # any other bare expression is almost always a
                # side-effecting call (list.append, dict update):
                # running it inside a loop closure would leak tensors
                # into Python state — leave such loops to plain Python
                return False
            if isinstance(s, ast.Assign):
                for t in s.targets:
                    if isinstance(t, ast.Name):
                        continue
                    if isinstance(t, ast.Tuple) and all(
                            isinstance(e, ast.Name) for e in t.elts):
                        continue
                    return False
            if isinstance(s, ast.AugAssign) and not isinstance(
                    s.target, ast.Name):
                return False
            # no hidden control flow inside expressions — but do NOT
            # descend into nested FunctionDefs: the if-transformer's
            # generated branch closures legitimately contain Return
            stack = list(ast.iter_child_nodes(s)) if not isinstance(
                s, ast.FunctionDef) else []
            while stack:
                n = stack.pop()
                if isinstance(n, (ast.Break, ast.Continue, ast.Return,
                                  ast.While, ast.For, ast.If, ast.Yield,
                                  ast.YieldFrom, ast.Await)):
                    return False
                if not isinstance(n, (ast.FunctionDef,
                                      ast.AsyncFunctionDef, ast.Lambda)):
                    stack.extend(ast.iter_child_nodes(n))
        return True

    @staticmethod
    def _exit_kind(s):
        """'break' / 'continue' / 'return' when ``s`` is an exit-if —
        ``if pred: [assignments...;] break|continue|return <expr>`` with
        no else — otherwise None (reference:
        break_continue_transformer.py, return_transformer.py)."""
        if not (isinstance(s, ast.If) and not s.orelse and s.body):
            return None
        *payload, last = s.body
        if not all(isinstance(q, (ast.Assign, ast.AugAssign))
                   for q in payload):
            return None
        if isinstance(last, ast.Break):
            return "break"
        if isinstance(last, ast.Continue):
            return "continue"
        if isinstance(last, ast.Return) and last.value is not None:
            return "return"
        return None

    def _carried(self, test, body_stmts, after_loads):
        """Loop-carried names: assigned in body AND (read by the test,
        read before written in the body — exit-if predicates and
        payloads included — or read after the loop)."""
        assigned: Set[str] = set()
        for s in body_stmts:
            assigned |= _stores(s)
        live: Set[str] = set()
        written: Set[str] = set()
        for s in body_stmts:
            if isinstance(s, ast.Assign):
                live |= (_loads(s.value) & assigned) - written
                for t in s.targets:
                    written |= _stores(t)
            elif isinstance(s, ast.AugAssign):
                live.add(s.target.id)
                live |= (_loads(s.value) & assigned) - written
                written.add(s.target.id)
            else:
                # exit-ifs land here: their predicate and payload reads
                # count as live (they re-evaluate every iteration), and
                # their conditional stores never count as written
                live |= (_loads(s) & assigned) - written
        if test is not None:
            live |= _loads(test) & assigned
        live |= after_loads & assigned
        # only live names ride in the carry (they must be bound before the
        # loop, the reference's loop-var rule); write-before-read temps
        # stay body-local
        return sorted(live)

    # -- codegen ----------------------------------------------------------
    def _emit(self, stmts, state, k, ind, uid):
        """Emit loop-body source for ``stmts`` with exit-ifs at ANY
        position (reference: break_continue_transformer.py /
        return_transformer.py generality).  Statements after an exit-if
        become the ELSE branch of a ``_jst_cond`` over the exit
        predicate — nesting reproduces Python's 'skip the rest of this
        iteration' semantics exactly, for eager (short-circuit) and
        tensor (``cond``) alike.  ``state`` names are threaded through
        branch closures via default-arg snapshots; plain temps flow by
        lexical capture."""
        lines = []
        j = next((i for i, s in enumerate(stmts)
                  if self._exit_kind(s)), None)
        for s in stmts[:len(stmts) if j is None else j]:
            for ln in ast.unparse(ast.fix_missing_locations(s)).splitlines():
                lines.append(ind + ln)
        if j is None:
            return lines
        ex = stmts[j]
        kind = self._exit_kind(ex)
        d = uid[0]
        uid[0] += 1
        p = f"__jst_p_{k}_{d}"
        names = ", ".join(state)
        tup = f"({names},)" if len(state) == 1 else f"({names})"
        defaults = ", ".join(f"{n}={n}" for n in state)
        lines.append(f"{ind}{p} = ({ast.unparse(ex.test)})")
        lines.append(f"{ind}def __jst_then_{k}_{d}({defaults}):")
        for s in ex.body[:-1]:
            for ln in ast.unparse(s).splitlines():
                lines.append(f"{ind}    {ln}")
        if kind in ("break", "return"):
            lines.append(f"{ind}    __jst_done_{k} = True")
        if kind == "return":
            lines.append(f"{ind}    __jst_rf_{k} = True")
            rv = ast.unparse(ex.body[-1].value)
            lines.append(f"{ind}    __jst_rv_{k} = ({rv})")
        lines.append(f"{ind}    return {tup}")
        lines.append(f"{ind}def __jst_else_{k}_{d}({defaults}):")
        rest = self._emit(stmts[j + 1:], state, k, ind + "    ", uid)
        lines.extend(rest)
        lines.append(f"{ind}    return {tup}")
        lines.append(f"{ind}{tup} = _jst_cond({p}, __jst_then_{k}_{d}, "
                     f"__jst_else_{k}_{d})")
        return lines

    # -- conversion -------------------------------------------------------
    def _convert(self, node, after_loads, tail_is_return=False):
        is_for = isinstance(node, ast.For)
        if node.orelse:
            return None
        body = list(node.body)
        if not self._body_ok(body):
            return None
        kinds = [self._exit_kind(s) for s in body]
        has_break = "break" in kinds
        has_return = "return" in kinds
        ret_exprs = [s.body[-1].value for s, kd in zip(body, kinds)
                     if kd == "return"]
        if has_return and not tail_is_return:
            # the surfaced `if flag: return value` is only fusable when
            # the loop is immediately followed by the function's
            # trailing return — otherwise a tensor flag would hit a
            # plain Python if; leave the loop to eager/loud handling
            return None

        if is_for:
            # for <name> in range(...)
            if not (isinstance(node.target, ast.Name)
                    and isinstance(node.iter, ast.Call)
                    and isinstance(node.iter.func, ast.Name)
                    and node.iter.func.id == "range"
                    and 1 <= len(node.iter.args) <= 3
                    and not node.iter.keywords):
                return None
            ivar = node.target.id
            if ivar in after_loads:
                # python leaves i at the LAST value; our carry leaves it
                # one step past — bail rather than deviate
                return None
            ra = node.iter.args
            start = ast.unparse(ra[0]) if len(ra) >= 2 else "0"
            stop = ast.unparse(ra[1] if len(ra) >= 2 else ra[0])
            if len(ra) == 3:
                if not (isinstance(ra[2], ast.Constant)
                        and isinstance(ra[2].value, int)
                        and ra[2].value > 0):
                    return None
                step = str(ra[2].value)
            else:
                step = "1"
            test_src = None
        else:
            test_src = ast.unparse(node.test)

        carried = self._carried(node.test if not is_for else None, body,
                                after_loads)
        if is_for and ivar in carried:
            carried.remove(ivar)
        if not carried:
            return None

        assigned: Set[str] = set()
        for s in body:
            assigned |= _stores(s)
        # names whose ONLY body assignment sits inside an exit-if payload
        # but that ride the carry (read after the loop) need a PRE-loop
        # binding for the carry init — without a visible one the init
        # tuple would raise UnboundLocalError where eager code worked;
        # bail (prior_stores: names assigned earlier in the enclosing
        # block, plus the function's parameters)
        non_exit_stores: Set[str] = set()
        for s, kd in zip(body, kinds):
            if kd is None:
                non_exit_stores |= _stores(s)
        payload_only = (assigned - non_exit_stores) & set(carried)
        if payload_only - self._prior_stores:
            return None
        for e in ret_exprs:
            # the rv carry init evaluates the return expr PRE-loop: only
            # carried body names (pre-bound by the loop-var rule) and the
            # enclosing scope are available there — a body-local temp or
            # the loop index would NameError
            loads = _loads(e)
            if loads & (assigned - set(carried)):
                return None
            if is_for and ivar in loads:
                return None

        self.count += 1
        k = self.count
        done = f"__jst_done_{k}"
        ctr = f"__jst_i_{k}"
        needs_done = has_break or has_return

        state = list(carried)
        if needs_done:
            state.append(done)
        if has_return:
            state += [f"__jst_rf_{k}", f"__jst_rv_{k}"]
        args = ([ctr] if is_for else []) + state
        argl = ", ".join(args)
        atup = f"({argl},)" if len(args) == 1 else f"({argl})"

        lines = []
        if is_for:
            lines.append(f"{ctr} = {start}")
            lines.append(f"__jst_n_{k} = {stop}")
        if needs_done:
            lines.append(f"{done} = False")
        if has_return:
            # the rv carry needs a shape/dtype-compatible init: the
            # return expr evaluated with PRE-loop values (verified above
            # to read only carried — hence pre-bound — or outer names);
            # never observed unless the flag is set
            lines.append(f"__jst_rf_{k} = False")
            lines.append(f"__jst_rv_{k} = ({ast.unparse(ret_exprs[0])})")
        # cond
        base_test = (f"_jst_lt({ctr}, __jst_n_{k})" if is_for
                     else f"({test_src})")
        cond_ret = (f"_jst_and({base_test}, _jst_not({done}))"
                    if needs_done else base_test)
        lines.append(f"def __jst_cond_{k}({argl}):")
        lines.append(f"    return {cond_ret}")
        # body: exit-ifs anywhere via _jst_cond nesting (_emit)
        lines.append(f"def __jst_body_{k}({argl}):")
        if is_for:
            lines.append(f"    {node.target.id} = {ctr}")
        lines.extend(self._emit(body, state, k, "    ", [0]))
        if is_for:
            lines.append(f"    {ctr} = {ctr} + {step}")
        lines.append(f"    return {atup}")
        # dispatch
        lines.append(f"{atup} = _jst_while(__jst_cond_{k}, "
                     f"__jst_body_{k}, {atup})")
        if has_return:
            # early return surfaces after the loop; the second if-pass
            # (convert_control_flow) fuses this with the function's
            # trailing return for tensor predicates
            lines.append(f"if __jst_rf_{k}:")
            lines.append(f"    return __jst_rv_{k}")
        src = "\n".join(lines)
        try:
            new_stmts = ast.parse(src).body
        except SyntaxError:  # pragma: no cover - defensive
            return None
        self.converted += 1
        return new_stmts

    def _rewrite(self, stmts, extra_after: Optional[Set[str]] = None,
                 prior: Optional[Set[str]] = None):
        out = []
        prior_stores: Set[str] = set(prior or ())
        for i, s in enumerate(stmts):
            if isinstance(s, (ast.While, ast.For)):
                after_loads: Set[str] = set(extra_after or ())
                for t in stmts[i + 1:]:
                    after_loads |= _loads(t)
                rest = stmts[i + 1:]
                tail_is_return = (len(rest) == 1
                                  and isinstance(rest[0], ast.Return)
                                  and rest[0].value is not None)
                self._prior_stores = prior_stores
                conv = self._convert(s, after_loads,
                                     tail_is_return=tail_is_return)
                if conv is not None:
                    out.extend(conv)
                    prior_stores |= _stores(s)
                    continue
            prior_stores |= _stores(s)
            out.append(s)
        return out

    def visit_FunctionDef(self, node):
        self.generic_visit(node)
        params = {a.arg for a in (node.args.args
                                  + node.args.posonlyargs
                                  + node.args.kwonlyargs)}
        node.body = self._rewrite(node.body, prior=params)
        return node

    def visit_While(self, node):
        # convert inner loops first; a converted inner loop inside an
        # unconverted (Python) outer loop is still a win
        self.generic_visit(node)
        node.body = self._rewrite(node.body,
                                  extra_after=_loads(node))
        return node

    def visit_For(self, node):
        self.generic_visit(node)
        node.body = self._rewrite(node.body,
                                  extra_after=_loads(node))
        return node


def _jst_print(*args, **kw):
    """``print``: eagerly it prints the values; under ``torch.export``
    it prints once, while the graph is captured (the graph holds no
    print)."""
    return print(*args, **kw)


def _jst_cast(x, ty):
    """``int/float/bool(x)``: a tensor becomes a tensor of int64,
    float32 or bool (as the cast transformer lowers a traced value);
    any other value keeps Python's builtin."""
    if _is_tensor(x):
        dtype = {"bool": torch.bool, "int": torch.int64,
                 "float": torch.float32}[ty]
        return _wrap(torch.Tensor.to(x, dtype))
    return {"bool": bool, "int": int, "float": float}[ty](x)


def _jst_assert(test, msg_fn=None):
    """``assert``: a Python predicate keeps Python's assert (``msg_fn``
    is a thunk, evaluated only on failure); a tensor predicate is read
    when it runs, and while ``torch.export`` captures the graph it
    becomes an assertion node of the graph."""
    def _msg():
        return (msg_fn() if callable(msg_fn) else msg_fn) \
            if msg_fn is not None else "dy2static assert failed"

    if not _is_tensor(test):
        if not test:
            raise AssertionError(_msg())
        return None
    ok = torch.Tensor.all(test)
    if torch.compiler.is_exporting():
        torch._assert_async(ok, _msg())
    elif not torch.Tensor.item(ok):
        raise AssertionError(_msg())
    return None


class _LogicalTransformer(ast.NodeTransformer):
    """reference: logical_transformer.py — `a and b` / `a or b` / `not a`
    on tensors would hit the tensor-bool error; rewrite them to thunked
    converters that keep exact Python short-circuit semantics for Python
    values and give torch's logical ops on tensors."""

    def __init__(self):
        self.converted = 0

    @staticmethod
    def _thunk(expr):
        return ast.Lambda(
            args=ast.arguments(posonlyargs=[], args=[], kwonlyargs=[],
                               kw_defaults=[], defaults=[]),
            body=expr)

    def visit_BoolOp(self, node):
        self.generic_visit(node)
        name = "_jst_land" if isinstance(node.op, ast.And) else "_jst_lor"
        out = node.values[0]
        for rhs in node.values[1:]:
            out = ast.Call(func=ast.Name(id=name, ctx=ast.Load()),
                           args=[self._thunk(out), self._thunk(rhs)],
                           keywords=[])
        self.converted += 1
        return out

    def visit_UnaryOp(self, node):
        self.generic_visit(node)
        if isinstance(node.op, ast.Not):
            self.converted += 1
            return ast.Call(func=ast.Name(id="_jst_not", ctx=ast.Load()),
                            args=[node.operand], keywords=[])
        return node


class _BuiltinTransformer(ast.NodeTransformer):
    """reference: print_transformer.py + cast_transformer.py +
    assert_transformer.py — `print(...)`, `int/float/bool(x)`, and
    `assert` route through runtime converters that keep Python's
    semantics for Python values and act on tensors as tensors.

    Names the function SHADOWS (params, local assignments, or module
    globals/closure bindings) are left untouched — rewriting them would
    silently hijack user callables."""

    _CASTS = {"int", "float", "bool"}

    def __init__(self, shadowed=frozenset()):
        self.converted = 0
        self._shadowed = shadowed

    def visit_Call(self, node):
        self.generic_visit(node)
        if not isinstance(node.func, ast.Name):
            return node
        name = node.func.id
        if name in self._shadowed:
            return node
        if name == "print":
            node.func = ast.Name(id="_jst_print", ctx=ast.Load())
            self.converted += 1
        elif (name in self._CASTS and len(node.args) == 1
                and not node.keywords):
            node = ast.Call(
                func=ast.Name(id="_jst_cast", ctx=ast.Load()),
                args=[node.args[0], ast.Constant(value=name)],
                keywords=[])
            self.converted += 1
        return node

    def visit_Assert(self, node):
        self.generic_visit(node)
        args = [node.test]
        if node.msg is not None:
            # lazy message thunk: Python evaluates the msg expression
            # only when the assert FAILS
            args.append(ast.Lambda(
                args=ast.arguments(posonlyargs=[], args=[],
                                   kwonlyargs=[], kw_defaults=[],
                                   defaults=[]),
                body=node.msg))
        self.converted += 1
        return ast.Expr(value=ast.Call(
            func=ast.Name(id="_jst_assert", ctx=ast.Load()),
            args=args, keywords=[]))


import weakref

# weak keys: dynamically created helpers (per-step closures, factory
# products) must stay collectable — a strong cache would pin every
# function object (and its closed-over arrays) for the process lifetime
_CALL_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_SKIP_ROOTS = {"paddle_tpu_torch", "numpy", "np", "builtins", "math",
               "functools", "itertools", "torch"}


def _convertible_user_fn(f) -> bool:
    import types
    if not isinstance(f, types.FunctionType):
        return False
    mod = (getattr(f, "__module__", "") or "").split(".")[0]
    return mod not in _SKIP_ROOTS


def _jst_call(f):
    """Runtime hook for converted call sites (reference:
    call_transformer.py convert_call): user helper functions get
    control-flow conversion too, lazily and memoized; anything else
    (builtins, library fns, shadowed names) passes through untouched."""
    if not _convertible_user_fn(f):
        return f
    conv = _CALL_CACHE.get(f)
    if conv is None:
        conv = convert_control_flow(f)
        _CALL_CACHE[f] = conv
    return conv


class _CallTransformer(ast.NodeTransformer):
    """reference: call_transformer.py — wrap bare-name calls that resolve
    (at conversion time) to plain user functions in ``_jst_call`` so
    tensor control flow inside helpers converts as well."""

    def __init__(self, resolver):
        self.converted = 0
        self._resolve = resolver

    def visit_Call(self, node):
        self.generic_visit(node)
        if (isinstance(node.func, ast.Name)
                and not node.func.id.startswith(("_jst", "__jst"))
                and self._resolve(node.func.id)):
            node.func = ast.Call(
                func=ast.Name(id="_jst_call", ctx=ast.Load()),
                args=[node.func], keywords=[])
            self.converted += 1
        return node


def _shadowed_builtins(fdef, env0) -> Set[str]:
    """Names the function shadows (params, local stores, module/closure
    bindings of print/int/float/bool) — the builtin transformer must not
    rewrite calls through them."""
    shadowed = {a.arg for a in (fdef.args.args + fdef.args.posonlyargs
                                + fdef.args.kwonlyargs)}
    shadowed |= {n.id for n in ast.walk(fdef)
                 if isinstance(n, ast.Name)
                 and isinstance(n.ctx, ast.Store)}
    shadowed |= {n for n in ("print", "int", "float", "bool")
                 if env0.get(n) is not None}
    return shadowed


def _decoration_env(fn) -> dict:
    """Globals + snapshot of closure cells — the name environment both
    the builtin-shadow scan and the call transformer resolve against."""
    env0 = dict(fn.__globals__)
    if fn.__closure__:
        try:
            env0.update({k: c.cell_contents
                         for k, c in zip(fn.__code__.co_freevars,
                                         fn.__closure__)})
        except ValueError:
            pass
    return env0


def _transform_tree(fn):
    """Parse ``fn``'s source and run the full transformer pipeline
    WITHOUT compiling or executing anything.

    Returns ``(tree, fdef, counters)`` — the mutated module tree, its
    FunctionDef, and per-transformer conversion counts — or ``None``
    when the source is unavailable / not a plain function def.  Shared
    by :func:`convert_control_flow` (which compiles the result) and
    jit/lint.py (which diffs the tree against the original to find what
    stayed unconverted)."""
    try:
        src = textwrap.dedent(inspect.getsource(fn))
        tree = ast.parse(src)
    except (OSError, TypeError, SyntaxError):
        return None
    fdef = tree.body[0]
    if not isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return None
    fdef.decorator_list = []  # run undecorated (to_static wraps us)
    tr = _IfElseTransformer()
    tr.visit(tree)
    # print/cast/assert rewrite BEFORE loops so their statement forms
    # (whitelisted in _body_ok) don't block loop conversion.  Shadowed
    # builtin names (params, local stores, module/closure bindings)
    # stay untouched.
    env0 = _decoration_env(fn)
    bt = _BuiltinTransformer(
        shadowed=frozenset(_shadowed_builtins(fdef, env0)))
    bt.visit(tree)
    lg = _LogicalTransformer()
    lg.visit(tree)
    lt = _LoopTransformer()
    lt.visit(tree)
    tr2 = _IfElseTransformer()
    if lt.converted:
        # second if-pass: fuses loop-generated `if __jst_rf: return rv`
        # early-return surfacing with the function's trailing return
        tr2.visit(tree)

    # nested calls (resolved against the same decoration-time env the
    # builtin-shadow scan used)
    ct = _CallTransformer(
        lambda name: _convertible_user_fn(env0.get(name)))
    ct.visit(tree)
    counters = {"ifelse": tr.converted + tr2.converted,
                "loops": lt.converted, "builtins": bt.converted,
                "logical": lg.converted, "calls": ct.converted}
    return tree, fdef, counters


def convert_control_flow(fn: Callable) -> Callable:
    """Return ``fn`` with convertible tensor-``if`` patterns rewritten to
    paddle.cond dispatch; returns ``fn`` unchanged when no pattern
    converts or the source is unavailable (lambdas, C funcs, REPL)."""
    res = _transform_tree(fn)
    if res is None:
        return fn
    tree, fdef, counters = res
    # builtin/logical-only conversions recompile ONLY closure-free
    # functions: the recompile snapshots closure cells, and freezing
    # live closures just to route a print or an `and` is a bad trade
    soft = ((counters["builtins"] + counters["logical"])
            if not fn.__closure__ else 0)
    if not (counters["ifelse"] or counters["loops"]
            or counters["calls"] or soft):
        return fn
    ast.fix_missing_locations(tree)
    try:
        code = compile(tree, f"<dy2static {fn.__qualname__}>", "exec")
    except (ValueError, SyntaxError):  # pragma: no cover - defensive
        return fn
    glb = dict(fn.__globals__)
    glb.update(_jst_cond=_jst_cond, _jst_while=_jst_while,
               _jst_and=_jst_and,
               _jst_or=_jst_or, _jst_not=_jst_not, _jst_lt=_jst_lt,
               _jst_call=_jst_call, _jst_print=_jst_print,
               _jst_cast=_jst_cast, _jst_assert=_jst_assert,
               _jst_land=_jst_land, _jst_lor=_jst_lor)
    # snapshot closure cells into globals (documented limitation: the
    # converted function sees decoration-time closure values)
    if fn.__closure__:
        try:
            glb.update({k: c.cell_contents
                        for k, c in zip(fn.__code__.co_freevars,
                                        fn.__closure__)})
        except ValueError:  # empty cell (helper defined later): skip
            return fn
    # the converted code runs in a module of its own, registered under
    # its name while the converted function lives: torch's control-flow
    # ops trace their branches with dynamo, which looks a function's
    # globals up through sys.modules[__name__]
    mod = types.ModuleType(f"{__name__}._converted_{next(_SERIALS)}")
    mod.__dict__.update({k: v for k, v in glb.items()
                         if k not in ("__name__", "__spec__", "__loader__")})
    sys.modules[mod.__name__] = mod
    loc: dict = {}
    exec(code, mod.__dict__, loc)
    new_fn = loc[fdef.name]
    functools.update_wrapper(new_fn, fn)
    weakref.finalize(new_fn, sys.modules.pop, mod.__name__, None)
    return new_fn
