"""dy2static lint: static diagnosis of what to_static will NOT convert
(a copy of ``paddle_tpu/jit/lint.py``; it reads only ``ast``).

Reference: the error-reporting tier of dygraph_to_static
(error.py + origin_info.py map transformed code back to user
file:line).  The converter (dy2static.py) is deliberately conservative
— anything it cannot prove convertible is left untouched and only fails
LOUDLY when it runs under ``to_static`` or ``jit.save``.  This lint runs
the SAME transformer pipeline purely statically (the function is never
executed) and reports, with file:line anchors:

- ``D2S101`` tensor-dependent ``if``/``while``/``for`` the converter
  leaves unconverted (these raise the tensor-bool TypeError the first
  time a tensor hits the test under ``to_static``);
- ``D2S102`` side-effecting bare-call statements inside tensor-dependent
  loop bodies (``list.append`` etc. — exactly what blocks loop
  conversion, per ``_LoopTransformer._body_ok``);
- ``D2S103`` shadowed builtins (``print``/``int``/``float``/``bool``
  rebound by a param, local store, or module/closure binding), which the
  builtin transformer therefore skips rewriting;
- ``D2S104`` host-sync calls on traced tensors — the same hazard the
  Program analyzer's host-transfer pass reports on recorded graphs,
  caught here earlier at the AST level.  ``.numpy()`` / ``.item()`` /
  ``.tolist()`` are errors: nothing rewrites them, so a graph that
  ``jit.save`` captures cannot hold them (and eagerly each one waits
  for the card).  ``float()``/``int()``/``bool()`` are warnings: the
  cast transformer silently lowers them to a tensor cast — the code
  runs, but it never yields the Python scalar it reads as.

"Tensor-dependent" is a static taint over the AST: function parameters
are assumed tensors; taint flows through assignments, attributes,
calls-on-tainted, and arithmetic.  Tests that cannot be a traced-truth
value (``is None``, ``isinstance``, ``len``) are excluded — they stay
concrete at trace time and are safe in plain Python form.
"""
from __future__ import annotations

import ast
import inspect
import textwrap
from typing import Callable, List, Optional, Set

from .dy2static import (_decoration_env, _shadowed_builtins,
                        _transform_tree)

__all__ = ["LintDiagnostic", "lint"]

# calls that produce concrete (non-traced) values even on tensor args
_CONCRETE_FNS = {"isinstance", "issubclass", "hasattr", "getattr",
                 "callable", "len", "type", "id", "repr", "str"}
# methods that force a device->host sync (and concretize a tracer)
_HOST_SYNC_METHODS = {"numpy", "item", "tolist"}
# builtin conversions that concretize a traced truth/scalar value
_HOST_SYNC_BUILTINS = {"float", "int", "bool"}
# attributes that are concrete Python metadata at trace time — control
# flow over them (`if x.shape[0] > 1`, `for i in range(x.ndim)`) is safe
_CONCRETE_ATTRS = {"shape", "ndim", "dtype", "name"}
_CONCRETE_CMP = (ast.Is, ast.IsNot, ast.In, ast.NotIn)


class LintDiagnostic:
    """One finding, anchored to the user's source."""

    __slots__ = ("file", "line", "col", "code", "severity", "message",
                 "function")

    def __init__(self, file: str, line: int, col: int, code: str,
                 severity: str, message: str, function: str = ""):
        self.file = file
        self.line = line
        self.col = col
        self.code = code
        self.severity = severity
        self.message = message
        self.function = function

    def __str__(self):
        return (f"{self.file}:{self.line}:{self.col}: {self.code} "
                f"[{self.severity}] {self.message}")

    def __repr__(self):
        return f"LintDiagnostic({self!s})"

    def to_dict(self) -> dict:
        """JSON-able record (tools/lint_program.py --format json)."""
        return {s: getattr(self, s) for s in self.__slots__}


# -- taint ------------------------------------------------------------------

def _names_read(node) -> Set[str]:
    return {n.id for n in ast.walk(node)
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)}


def _tensor_taint(fdef: ast.FunctionDef) -> Set[str]:
    """Names that may hold tensors: parameters seed the set; assignments
    whose value reads a tainted name propagate it.  Iterated to fixpoint
    (loops assign before the reader appears textually earlier)."""
    tainted = {a.arg for a in (fdef.args.args + fdef.args.posonlyargs
                               + fdef.args.kwonlyargs)}
    for extra in (fdef.args.vararg, fdef.args.kwarg):
        if extra is not None:
            tainted.add(extra.arg)
    changed = True
    while changed:
        changed = False
        for n in ast.walk(fdef):
            if isinstance(n, ast.Assign):
                if _names_read(n.value) & tainted:
                    for t in n.targets:
                        for nm in ast.walk(t):
                            if (isinstance(nm, ast.Name)
                                    and isinstance(nm.ctx, ast.Store)
                                    and nm.id not in tainted):
                                tainted.add(nm.id)
                                changed = True
            elif isinstance(n, ast.AugAssign):
                if (isinstance(n.target, ast.Name)
                        and _names_read(n.value) & tainted
                        and n.target.id not in tainted):
                    tainted.add(n.target.id)
                    changed = True
    return tainted


def _tensorish(expr, tainted: Set[str]) -> bool:
    """Could ``expr`` evaluate to a traced tensor (so that truth-testing
    it raises)?  Conservative on structure, but excludes expressions
    whose VALUE is always concrete (`is None`, isinstance, len)."""
    if isinstance(expr, ast.Name):
        return expr.id in tainted
    if isinstance(expr, ast.Attribute):
        if expr.attr in _CONCRETE_ATTRS:
            return False
        return _tensorish(expr.value, tainted)
    if isinstance(expr, ast.Subscript):
        return _tensorish(expr.value, tainted)
    if isinstance(expr, ast.Call):
        f = expr.func
        if isinstance(f, ast.Name) and f.id in _CONCRETE_FNS:
            return False
        if isinstance(f, ast.Attribute):      # x.sum(), x.mean()...
            return _tensorish(f.value, tainted)
        return any(_tensorish(a, tainted) for a in expr.args)
    if isinstance(expr, ast.Compare):
        if all(isinstance(op, _CONCRETE_CMP) for op in expr.ops):
            return False
        return (_tensorish(expr.left, tainted)
                or any(_tensorish(c, tainted) for c in expr.comparators))
    if isinstance(expr, ast.BoolOp):
        return any(_tensorish(v, tainted) for v in expr.values)
    if isinstance(expr, ast.UnaryOp):
        return _tensorish(expr.operand, tainted)
    if isinstance(expr, ast.BinOp):
        return (_tensorish(expr.left, tainted)
                or _tensorish(expr.right, tainted))
    if isinstance(expr, ast.IfExp):
        return (_tensorish(expr.body, tainted)
                or _tensorish(expr.orelse, tainted))
    return False


def _is_generated(node) -> bool:
    """Transformer-emitted control flow (`if __jst_rf_k: return ...`)
    must not be reported as the user's.  Only ``if`` is ever emitted —
    loops lower to ``_jst_while`` calls — so For/While are always user
    code; only the TEST is inspected (a converted print/cast in the
    body must not mask the user's construct), and only the generated
    ``__jst*`` names count (``_jst_land``/``_jst_lor`` appear in USER
    tests after the logical transformer ran)."""
    if not isinstance(node, ast.If):
        return False
    for n in ast.walk(node.test):
        if isinstance(n, ast.Name) and n.id.startswith("__jst"):
            return True
    return False


# -- lint core --------------------------------------------------------------

def _surviving_control_flow(tree) -> List[ast.stmt]:
    """If/While/For statements still present AFTER the transformer
    pipeline ran — i.e. what to_static will execute as plain Python."""
    out = []
    for n in ast.walk(tree):
        if isinstance(n, (ast.If, ast.While, ast.For)) and \
                not _is_generated(n):
            out.append(n)
    return out


def _unwrap(fn) -> Optional[Callable]:
    from .static_function import StaticFunction
    if isinstance(fn, StaticFunction):
        fn = fn._fn
    seen = set()
    while hasattr(fn, "__wrapped__") and id(fn) not in seen:
        seen.add(id(fn))
        fn = fn.__wrapped__
    if inspect.ismethod(fn):
        fn = fn.__func__
    return fn if callable(fn) else None


def lint(fn) -> List[LintDiagnostic]:
    """Statically lint ``fn`` (a plain function, method, or
    ``to_static``-wrapped StaticFunction) for dy2static hazards.  The
    function is parsed and analysed, never called."""
    fn = _unwrap(fn)
    if fn is None:
        return []
    try:
        file = inspect.getsourcefile(fn) or "<unknown>"
        src_lines, start = inspect.getsourcelines(fn)
    except (OSError, TypeError):
        return []
    name = getattr(fn, "__qualname__", getattr(fn, "__name__", "<fn>"))

    # original tree: line anchors, taint, side-effect + shadow scans
    try:
        orig = ast.parse(textwrap.dedent("".join(src_lines)))
    except SyntaxError:
        return []
    if not orig.body or not isinstance(
            orig.body[0], (ast.FunctionDef, ast.AsyncFunctionDef)):
        return []
    fdef0 = orig.body[0]

    # transformed tree: what the converter actually leaves behind
    res = _transform_tree(fn)
    if res is None:
        converted_tree = orig  # nothing converts; everything survives
    else:
        converted_tree = res[0]

    def anchor(node) -> tuple:
        return (start + node.lineno - 1, node.col_offset)

    diags: List[LintDiagnostic] = []
    tainted = _tensor_taint(fdef0)

    # -- D2S101: surviving tensor-dependent control flow ------------------
    survivors = _surviving_control_flow(converted_tree)
    surviving_lines = {s.lineno for s in survivors}
    for node in ast.walk(fdef0):
        if isinstance(node, ast.If) and node.lineno in surviving_lines \
                and _tensorish(node.test, tainted):
            line, col = anchor(node)
            diags.append(LintDiagnostic(
                file, line, col, "D2S101", "error",
                f"tensor-dependent `if` is not convertible and will "
                f"raise at trace time "
                f"(test: `{ast.unparse(node.test)}`); restructure both "
                f"branches to assign the same names, or use "
                f"paddle.static.nn.cond", function=name))
        elif isinstance(node, ast.While) \
                and node.lineno in surviving_lines \
                and _tensorish(node.test, tainted):
            line, col = anchor(node)
            diags.append(LintDiagnostic(
                file, line, col, "D2S101", "error",
                f"tensor-dependent `while` is not convertible and will "
                f"raise at trace time "
                f"(test: `{ast.unparse(node.test)}`); make the body "
                f"assignment-only, or use paddle.static.nn.while_loop",
                function=name))
        elif isinstance(node, ast.For) and node.lineno in surviving_lines:
            it = node.iter
            over_range = (isinstance(it, ast.Call)
                          and isinstance(it.func, ast.Name)
                          and it.func.id == "range")
            if over_range and any(_tensorish(a, tainted)
                                  for a in it.args):
                line, col = anchor(node)
                diags.append(LintDiagnostic(
                    file, line, col, "D2S101", "error",
                    f"`for` over a tensor-valued `range` bound is not "
                    f"convertible (`{ast.unparse(it)}`); make the body "
                    f"assignment-only so the loop converter can carry "
                    f"it, or use paddle.static.nn.while_loop",
                    function=name))
            elif not over_range and _tensorish(it, tainted):
                line, col = anchor(node)
                diags.append(LintDiagnostic(
                    file, line, col, "D2S101", "error",
                    f"`for` iterating a tensor "
                    f"(`{ast.unparse(it)}`) is never converted; index "
                    f"with a converted range loop or vectorise",
                    function=name))

    # -- D2S102: side effects in tensor-dependent loop bodies -------------
    for loop in ast.walk(fdef0):
        if not isinstance(loop, (ast.While, ast.For)):
            continue
        loop_tainted = (
            _tensorish(loop.test, tainted) if isinstance(loop, ast.While)
            else _tensorish(loop.iter, tainted)
            or (isinstance(loop.iter, ast.Call)
                and isinstance(loop.iter.func, ast.Name)
                and loop.iter.func.id == "range"
                and any(_tensorish(a, tainted) for a in loop.iter.args)))
        if not loop_tainted:
            continue
        for s in loop.body:
            if (isinstance(s, ast.Expr)
                    and isinstance(s.value, ast.Call)
                    and not (isinstance(s.value.func, ast.Name)
                             and s.value.func.id in ("print",))):
                line, col = anchor(s)
                diags.append(LintDiagnostic(
                    file, line, col, "D2S102", "warning",
                    f"side-effecting statement "
                    f"`{ast.unparse(s.value)}` in a tensor-dependent "
                    f"loop body blocks conversion (mutating Python "
                    f"state from a traced loop leaks tracers); carry "
                    f"values through loop variables instead",
                    function=name))

    # -- D2S104: host-sync calls on traced tensors ------------------------
    env0 = _decoration_env(fn)
    shadowed_all = _shadowed_builtins(fdef0, env0)
    for n in ast.walk(fdef0):
        if not isinstance(n, ast.Call):
            continue
        f = n.func
        if isinstance(f, ast.Attribute) and f.attr in _HOST_SYNC_METHODS \
                and _tensorish(f.value, tainted):
            line, col = anchor(n)
            diags.append(LintDiagnostic(
                file, line, col, "D2S104", "error",
                f"host-sync call `{ast.unparse(n)}` on a traced tensor: "
                f"under to_static this concretizes the tracer (TypeError "
                f"at trace time), and in eager TPU code it stalls the "
                f"async dispatch pipeline with a device->host sync; "
                f"return the tensor and convert OUTSIDE the compiled "
                f"function", function=name))
        elif (isinstance(f, ast.Name) and f.id in _HOST_SYNC_BUILTINS
                and f.id not in shadowed_all and n.args
                and _tensorish(n.args[0], tainted)):
            line, col = anchor(n)
            diags.append(LintDiagnostic(
                file, line, col, "D2S104", "warning",
                f"`{f.id}(...)` on a traced tensor "
                f"(`{ast.unparse(n)}`) does not produce a Python "
                f"{f.id} under to_static: the cast transformer lowers "
                f"it to a tensor astype, so code expecting a host "
                f"scalar (formatting, dict keys, plain-Python math) "
                f"misbehaves — and in eager TPU code the same call "
                f"stalls the pipeline with a device->host sync; keep "
                f"the value a tensor, or convert outside the compiled "
                f"function", function=name))

    # -- D2S103: shadowed builtins ----------------------------------------
    shadowed = shadowed_all & {"print", "int", "float", "bool"}
    if shadowed:
        for n in ast.walk(fdef0):
            if (isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                    and n.func.id in shadowed):
                line, col = anchor(n)
                diags.append(LintDiagnostic(
                    file, line, col, "D2S103", "warning",
                    f"`{n.func.id}(...)` calls a SHADOWED builtin "
                    f"(rebound by a param, local assignment, or "
                    f"module/closure binding), so dy2static will not "
                    f"lower it for traced tensors; rename the "
                    f"shadowing binding", function=name))
    diags.sort(key=lambda d: (d.line, d.col, d.code))
    return diags
