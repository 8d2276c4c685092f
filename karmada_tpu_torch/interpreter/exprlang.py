"""Sandboxed expression language for declarative interpreter customizations.

The port's own copy of ``karmada_tpu/interpreter/exprlang.py``.

Ref: pkg/resourceinterpreter/customized/declarative/luavm/lua.go:46-316 —
the reference embeds a gopher-lua VM so a ResourceInterpreterCustomization
CR can carry arbitrary per-kind logic (conditional status math, replica
derivation across fields, health predicates). The path-DSL
(interpreter/declarative.py) covers the common shapes; this module closes
the expression-completeness gap with a restricted-Python evaluator:

- scripts are parsed with ``ast`` and validated against a node whitelist at
  registration time (no imports, no attribute access to dunders, no
  exec/eval, no comprehension of arbitrary builtins);
- execution walks the AST directly (never CPython ``eval``/``exec``), so
  the sandbox boundary is this interpreter, not CPython's; a fuel counter
  bounds runaway loops (the VM-pool + instruction-budget analogue of the
  reference's lua.go:279-287 context cancellation);
- dict values support attribute-style access (``obj.spec.replicas`` ==
  ``obj["spec"]["replicas"]``) so ported reference scripts keep their
  shape; missing fields read as ``None`` (Lua nil semantics) instead of
  raising, which is what interpreter scripts overwhelmingly want;
- the function-per-operation contract mirrors the reference exactly:
  ``GetReplicas(observedObj)``, ``ReviseReplica(desiredObj, replica)``,
  ``Retain(desiredObj, observedObj)``, ``AggregateStatus(desiredObj,
  statusItems)``, ``InterpretHealth(observedObj)``,
  ``ReflectStatus(observedObj)``, ``GetDependencies(desiredObj)``.

A small ``kube`` helper namespace provides the reference's kube.lua
equivalents (getResourceQuantity, accuratePodRequirements,
getPodDependencies).
"""

from __future__ import annotations

import ast
import math
from typing import Any, Callable, Optional

MAX_FUEL = 500_000  # AST-step budget per invocation
MAX_ITERATIONS = 100_000  # per-loop bound
# Single-value size ceiling (chars / elements). Fuel meters AST steps, not
# the cost of one step: every op that can grow a value at C speed (seq
# concat, repetition, extend/replace/join) is pre-checked against this cap
# BEFORE allocating, so `s = s + s` doubling cannot outrun the fuel meter.
MAX_VALUE_SIZE = 10**7

_ALLOWED_NODES = (
    ast.Module, ast.FunctionDef, ast.arguments, ast.arg, ast.Return,
    ast.If, ast.For, ast.While, ast.Break, ast.Continue, ast.Pass,
    ast.Assign, ast.AugAssign, ast.Expr,
    ast.BoolOp, ast.BinOp, ast.UnaryOp, ast.Compare, ast.IfExp,
    ast.Call, ast.keyword,
    ast.Attribute, ast.Subscript, ast.Slice, ast.Index if hasattr(ast, "Index") else ast.Slice,
    ast.Name, ast.Load, ast.Store, ast.Constant,
    ast.Dict, ast.List, ast.Tuple, ast.Set,
    ast.ListComp, ast.DictComp, ast.GeneratorExp, ast.comprehension,
    ast.JoinedStr, ast.FormattedValue,
    ast.And, ast.Or, ast.Not, ast.USub, ast.UAdd,
    ast.Add, ast.Sub, ast.Mult, ast.Div, ast.FloorDiv, ast.Mod, ast.Pow,
    ast.Eq, ast.NotEq, ast.Lt, ast.LtE, ast.Gt, ast.GtE,
    ast.In, ast.NotIn, ast.Is, ast.IsNot,
)


class ScriptError(Exception):
    """Raised for invalid scripts (registration time) and runtime faults
    (bad field math, fuel exhaustion) — the configmanager surfaces these on
    the customization CR, mirroring the reference's Lua error conditions."""


class _Missing:
    """Lua-nil-style chainable missing value: attribute/index reads on a
    missing field stay missing, truthiness is False, equality only with
    None/missing."""

    _instance: Optional["_Missing"] = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __bool__(self):
        return False

    def __eq__(self, other):
        return other is None or isinstance(other, _Missing)

    def __ne__(self, other):
        return not self.__eq__(other)

    def __hash__(self):
        return hash(None)

    def __repr__(self):
        return "nil"


NIL = _Missing()


def _is_nil(v: Any) -> bool:
    return v is None or isinstance(v, _Missing)


def _de_nil(v: Any) -> Any:
    """Convert NIL back to None at the script boundary (recursively for
    containers the script built)."""
    if isinstance(v, _Missing):
        return None
    if isinstance(v, dict):
        return {k: _de_nil(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_de_nil(x) for x in v]
    if isinstance(v, tuple):
        return tuple(_de_nil(x) for x in v)
    return v


def _kube_get_resource_quantity(q: Any) -> float:
    """kube.getResourceQuantity: parse a k8s quantity into a float of its
    base unit (cpu quantities -> cores, memory -> bytes)."""
    from ..utils.quantity import parse_quantity

    if _is_nil(q):
        return 0.0
    if isinstance(q, (int, float)):
        return float(q)
    s = str(q)
    # cpu milli style handled by parse_quantity("cpu"); binary/decimal
    # suffixes by the memory parser — choose by suffix shape
    if s.endswith("m") and s[:-1].replace(".", "", 1).isdigit():
        return parse_quantity(s, "cpu") / 1000.0
    try:
        return float(s)
    except ValueError:
        return float(parse_quantity(s, "memory"))


def _kube_accurate_pod_requirements(template: Any) -> dict:
    from .native import pod_requests

    template = _de_nil(template) or {}
    return {"resourceRequest": pod_requests(template.get("spec") or {})}


def _kube_get_pod_dependencies(template: Any, namespace: Any = "") -> list:
    from .native import pod_spec_dependencies

    template = _de_nil(template) or {}
    return [
        {
            "apiVersion": d.api_version,
            "kind": d.kind,
            "namespace": d.namespace or (_de_nil(namespace) or ""),
            "name": d.name,
        }
        for d in pod_spec_dependencies(
            template.get("spec") or {}, _de_nil(namespace) or ""
        )
    ]


def _bounded_sum(iterable, start=0):
    # sum() with a sequence start concatenates at C speed in one AST step;
    # numeric sums over bounded iterables are fine, sequence accumulation
    # must respect the value-size cap
    if isinstance(start, (str, list, tuple)):
        items = list(iterable)
        total = len(start) + sum(
            len(x) for x in items if isinstance(x, (str, list, tuple))
        )
        if total > MAX_VALUE_SIZE:
            raise ScriptError("sum result too large")
        return sum(items, start)
    return sum(iterable, start)


_SAFE_BUILTINS: dict[str, Any] = {
    "len": lambda x: 0 if _is_nil(x) else len(x),
    "min": min,
    "max": max,
    "sum": _bounded_sum,
    "abs": abs,
    "round": round,
    "int": lambda x=0: 0 if _is_nil(x) else int(x),
    "float": lambda x=0.0: 0.0 if _is_nil(x) else float(x),
    "str": lambda x="": "" if _is_nil(x) else str(x),
    "bool": lambda x=False: bool(x),
    "sorted": sorted,
    # the fuel counter meters AST steps; an unbounded range handed to
    # sum/list/sorted would run at C speed outside it
    "range": lambda *a: _bounded_range(*a),
    "enumerate": enumerate,
    "any": any,
    "all": all,
    "dict": dict,
    "list": lambda x=(): [] if _is_nil(x) else list(x),
    "tuple": tuple,
    "set": set,
    "math": math,  # module access guarded by the attribute whitelist below
}

_MATH_ALLOWED = {"ceil", "floor", "sqrt", "inf", "nan", "pow", "log", "log2"}


class _Env:
    __slots__ = ("vars", "parent")

    def __init__(self, parent=None):
        self.vars: dict[str, Any] = {}
        self.parent = parent

    def get(self, name: str) -> Any:
        env = self
        while env is not None:
            if name in env.vars:
                return env.vars[name]
            env = env.parent
        if name in _SAFE_BUILTINS:
            return _SAFE_BUILTINS[name]
        raise ScriptError(f"name {name!r} is not defined")

    def set(self, name: str, value: Any) -> None:
        env = self
        while env is not None:
            if name in env.vars:
                env.vars[name] = value
                return
            env = env.parent
        self.vars[name] = value


class _Return(Exception):
    def __init__(self, value):
        self.value = value


class _Break(Exception):
    pass


class _Continue(Exception):
    pass


class _Function:
    __slots__ = ("node", "closure", "vm")

    def __init__(self, node: ast.FunctionDef, closure: "_Env", vm: "ExprVM"):
        self.node = node
        self.closure = closure
        self.vm = vm

    def __call__(self, *args):
        params = [a.arg for a in self.node.args.args]
        defaults = self.node.args.defaults
        env = _Env(self.closure)
        n_required = len(params) - len(defaults)
        for i, p in enumerate(params):
            if i < len(args):
                env.vars[p] = args[i]
            elif i >= n_required:
                env.vars[p] = self.vm._eval(defaults[i - n_required], self.closure)
            else:
                env.vars[p] = NIL  # Lua-style: missing args are nil
        try:
            for stmt in self.node.body:
                self.vm._exec(stmt, env)
        except _Return as r:
            return r.value
        return None


class ExprVM:
    """One validated script: namespace of user functions + evaluator."""

    def __init__(self, source: str, extra_globals: Optional[dict] = None):
        try:
            tree = ast.parse(source, mode="exec")
        except SyntaxError as e:
            raise ScriptError(f"script syntax error: {e}") from e
        self._validate(tree)
        self.fuel = MAX_FUEL  # top-level statements run at registration
        self.globals = _Env()
        self.globals.vars["kube"] = _KubeNamespace()
        if extra_globals:
            self.globals.vars.update(extra_globals)
        for stmt in tree.body:
            if isinstance(stmt, ast.FunctionDef):
                self.globals.vars[stmt.name] = _Function(stmt, self.globals, self)
            elif isinstance(stmt, (ast.Assign, ast.Expr)):
                self._exec(stmt, self.globals)
            else:
                raise ScriptError(
                    f"top level only allows function/assignment, got "
                    f"{type(stmt).__name__}"
                )

    # -- validation --------------------------------------------------------

    @staticmethod
    def _validate(tree: ast.AST) -> None:
        for node in ast.walk(tree):
            if not isinstance(node, _ALLOWED_NODES):
                raise ScriptError(
                    f"forbidden construct {type(node).__name__} in script"
                )
            if isinstance(node, ast.Attribute) and node.attr.startswith("_"):
                raise ScriptError(f"forbidden attribute {node.attr!r}")
            if isinstance(node, ast.Name) and node.id.startswith("__"):
                raise ScriptError(f"forbidden name {node.id!r}")
            if isinstance(node, ast.FunctionDef) and (
                node.decorator_list
                or node.args.vararg
                or node.args.kwarg
                or node.args.kwonlyargs
            ):
                raise ScriptError(
                    "decorators/varargs are not allowed in scripts"
                )

    # -- public ------------------------------------------------------------

    def has(self, name: str) -> bool:
        return name in self.globals.vars

    def call(self, name: str, *args) -> Any:
        fn = self.globals.vars.get(name)
        if not isinstance(fn, _Function):
            raise ScriptError(f"script defines no function {name!r}")
        self.fuel = MAX_FUEL
        try:
            return _de_nil(fn(*args))
        except (_Break, _Continue):
            raise ScriptError("break/continue outside loop")
        except ScriptError:
            raise
        except Exception as e:  # arithmetic on nil, bad indexes, ...
            raise ScriptError(f"script runtime error in {name}: {e}") from e

    # -- execution ---------------------------------------------------------

    def _burn(self) -> None:
        self.fuel -= 1
        if self.fuel <= 0:
            raise ScriptError("script exceeded its execution budget")

    def _exec(self, node: ast.stmt, env: _Env) -> None:
        self._burn()
        if isinstance(node, ast.Expr):
            self._eval(node.value, env)
        elif isinstance(node, ast.Assign):
            value = self._eval(node.value, env)
            for tgt in node.targets:
                self._assign(tgt, value, env)
        elif isinstance(node, ast.AugAssign):
            current = self._eval_target(node.target, env)
            value = self._apply_binop(node.op, current, self._eval(node.value, env))
            self._assign(node.target, value, env)
        elif isinstance(node, ast.Return):
            raise _Return(self._eval(node.value, env) if node.value else None)
        elif isinstance(node, ast.If):
            branch = node.body if self._eval(node.test, env) else node.orelse
            for stmt in branch:
                self._exec(stmt, env)
        elif isinstance(node, ast.While):
            count = 0
            while self._eval(node.test, env):
                count += 1
                if count > MAX_ITERATIONS:
                    raise ScriptError("while loop exceeded iteration bound")
                try:
                    for stmt in node.body:
                        self._exec(stmt, env)
                except _Break:
                    break
                except _Continue:
                    continue
        elif isinstance(node, ast.For):
            iterable = self._eval(node.iter, env)
            if _is_nil(iterable):
                iterable = ()
            count = 0
            for item in iterable:
                count += 1
                if count > MAX_ITERATIONS:
                    raise ScriptError("for loop exceeded iteration bound")
                self._assign(node.target, item, env)
                try:
                    for stmt in node.body:
                        self._exec(stmt, env)
                except _Break:
                    break
                except _Continue:
                    continue
            else:
                for stmt in node.orelse:
                    self._exec(stmt, env)
        elif isinstance(node, ast.FunctionDef):
            env.set(node.name, _Function(node, env, self))
        elif isinstance(node, ast.Break):
            raise _Break()
        elif isinstance(node, ast.Continue):
            raise _Continue()
        elif isinstance(node, ast.Pass):
            pass
        else:
            raise ScriptError(f"unsupported statement {type(node).__name__}")

    def _assign(self, target: ast.expr, value: Any, env: _Env) -> None:
        if isinstance(target, ast.Name):
            env.set(target.id, value)
        elif isinstance(target, ast.Attribute):
            obj = self._eval(target.value, env)
            if isinstance(obj, dict):
                obj[target.attr] = value
            else:
                raise ScriptError(
                    f"cannot set attribute {target.attr!r} on {type(obj).__name__}"
                )
        elif isinstance(target, ast.Subscript):
            obj = self._eval(target.value, env)
            key = self._eval(target.slice, env)
            obj[key] = value
        elif isinstance(target, (ast.Tuple, ast.List)):
            items = list(value)
            if len(items) != len(target.elts):
                raise ScriptError("unpack length mismatch")
            for tgt, item in zip(target.elts, items):
                self._assign(tgt, item, env)
        else:
            raise ScriptError(f"cannot assign to {type(target).__name__}")

    def _eval_target(self, target: ast.expr, env: _Env) -> Any:
        return self._eval(target, env)

    @staticmethod
    def _size_guard(left: Any, right: Any) -> None:
        """C-speed blowup guard: fuel meters AST steps, not the cost of one
        step, so big-int growth and sequence repetition must be bounded
        explicitly (x = x * x doubles digit count per fuel unit)."""
        if isinstance(left, int) and isinstance(right, int):
            if left.bit_length() + right.bit_length() > 1 << 16:
                raise ScriptError("integer operands too large")
        elif isinstance(left, (str, list, tuple)) and isinstance(right, int):
            if len(left) * max(right, 1) > MAX_VALUE_SIZE:
                raise ScriptError("sequence repetition too large")
        elif isinstance(right, (str, list, tuple)) and isinstance(left, int):
            if len(right) * max(left, 1) > MAX_VALUE_SIZE:
                raise ScriptError("sequence repetition too large")

    @staticmethod
    def _format_guard(fmt: str, args: Any) -> None:
        """'%999999999d' % 1 allocates ~1GB in one AST step. Bound the
        printf path: cap explicit width/precision digit runs in the format
        string, and cap the magnitude of int args when '*' (dynamic
        width/precision) appears."""
        import re

        if len(fmt) > MAX_VALUE_SIZE:
            raise ScriptError("format string too large")
        for width, precision in re.findall(
            r"%(?:\([^)]*\))?[-+ #0]*(\d*)(?:\.(\d*))?", fmt
        ):
            if (width and int(width) > 10**6) or (
                precision and int(precision) > 10**6
            ):
                raise ScriptError("format width too large")
        if "*" in fmt:
            seq = args if isinstance(args, tuple) else (args,)
            for a in seq:
                if isinstance(a, int) and abs(a) > 10**6:
                    raise ScriptError("dynamic format width too large")

    def _apply_binop(self, op: ast.operator, left: Any, right: Any) -> Any:
        if isinstance(op, ast.Add):
            if isinstance(left, (str, list, tuple)) and isinstance(
                right, (str, list, tuple)
            ):
                if len(left) + len(right) > MAX_VALUE_SIZE:
                    raise ScriptError("concatenation result too large")
            return left + right
        if isinstance(op, ast.Sub):
            return left - right
        if isinstance(op, ast.Mult):
            self._size_guard(left, right)
            return left * right
        if isinstance(op, ast.Div):
            return left / right
        if isinstance(op, ast.FloorDiv):
            return left // right
        if isinstance(op, ast.Mod):
            if isinstance(left, str):
                self._format_guard(left, right)
            return left % right
        if isinstance(op, ast.Pow):
            if abs(_num(right)) > 64:
                raise ScriptError("exponent too large")
            self._size_guard(left, left)
            return left ** right
        raise ScriptError(f"unsupported operator {type(op).__name__}")

    def _eval(self, node: ast.expr, env: _Env) -> Any:
        self._burn()
        if isinstance(node, ast.Constant):
            return node.value
        if isinstance(node, ast.Name):
            return env.get(node.id)
        if isinstance(node, ast.Attribute):
            obj = self._eval(node.value, env)
            return self._getattr(obj, node.attr)
        if isinstance(node, ast.Subscript):
            obj = self._eval(node.value, env)
            if isinstance(node.slice, ast.Slice):
                lo = self._eval(node.slice.lower, env) if node.slice.lower else None
                hi = self._eval(node.slice.upper, env) if node.slice.upper else None
                return obj[lo:hi]
            key = self._eval(node.slice, env)
            if _is_nil(obj):
                return NIL
            if isinstance(obj, dict):
                return obj.get(key, NIL)
            try:
                return obj[key]
            except (IndexError, KeyError, TypeError):
                return NIL
        if isinstance(node, ast.BinOp):
            return self._apply_binop(
                node.op, self._eval(node.left, env), self._eval(node.right, env)
            )
        if isinstance(node, ast.BoolOp):
            if isinstance(node.op, ast.And):
                result: Any = True
                for value in node.values:
                    result = self._eval(value, env)
                    if not result:
                        return result
                return result
            for value in node.values:
                result = self._eval(value, env)
                if result:
                    return result
            return result
        if isinstance(node, ast.UnaryOp):
            operand = self._eval(node.operand, env)
            if isinstance(node.op, ast.Not):
                return not operand
            if isinstance(node.op, ast.USub):
                return -operand
            return +operand
        if isinstance(node, ast.Compare):
            left = self._eval(node.left, env)
            for op, comparator in zip(node.ops, node.comparators):
                right = self._eval(comparator, env)
                if not self._compare(op, left, right):
                    return False
                left = right
            return True
        if isinstance(node, ast.IfExp):
            return (
                self._eval(node.body, env)
                if self._eval(node.test, env)
                else self._eval(node.orelse, env)
            )
        if isinstance(node, ast.Call):
            fn = self._eval(node.func, env)
            args = [self._eval(a, env) for a in node.args]
            kwargs = {kw.arg: self._eval(kw.value, env) for kw in node.keywords}
            if not callable(fn):
                raise ScriptError(f"{fn!r} is not callable")
            return fn(*args, **kwargs)
        if isinstance(node, ast.Dict):
            return {
                self._eval(k, env): self._eval(v, env)
                for k, v in zip(node.keys, node.values)
            }
        if isinstance(node, ast.List):
            return [self._eval(e, env) for e in node.elts]
        if isinstance(node, ast.Tuple):
            return tuple(self._eval(e, env) for e in node.elts)
        if isinstance(node, ast.Set):
            return {self._eval(e, env) for e in node.elts}
        if isinstance(node, (ast.ListComp, ast.GeneratorExp)):
            out = []
            self._comprehend(node.generators, 0, env, lambda e: out.append(
                self._eval(node.elt, e)))
            return out
        if isinstance(node, ast.DictComp):
            out: dict = {}
            self._comprehend(node.generators, 0, env, lambda e: out.__setitem__(
                self._eval(node.key, e), self._eval(node.value, e)))
            return out
        if isinstance(node, ast.JoinedStr):
            parts = []
            for value in node.values:
                if isinstance(value, ast.FormattedValue):
                    v = _de_nil(self._eval(value.value, env))
                    # only nil renders empty (Lua semantics); 0/False print
                    parts.append("" if v is None else str(v))
                else:
                    parts.append(str(self._eval(value, env)))
            return "".join(parts)
        raise ScriptError(f"unsupported expression {type(node).__name__}")

    def _comprehend(self, generators, i, env: _Env, emit: Callable) -> None:
        if i == len(generators):
            emit(env)
            return
        gen = generators[i]
        iterable = self._eval(gen.iter, env)
        if _is_nil(iterable):
            iterable = ()
        count = 0
        for item in iterable:
            count += 1
            if count > MAX_ITERATIONS:
                raise ScriptError("comprehension exceeded iteration bound")
            inner = _Env(env)
            self._assign(gen.target, item, inner)
            if all(self._eval(cond, inner) for cond in gen.ifs):
                self._comprehend(generators, i + 1, inner, emit)

    @staticmethod
    def _compare(op: ast.cmpop, left: Any, right: Any) -> bool:
        if isinstance(op, ast.Eq):
            return left == right
        if isinstance(op, ast.NotEq):
            return left != right
        if isinstance(op, (ast.Is,)):
            return _is_nil(left) and _is_nil(right) if (
                _is_nil(left) or _is_nil(right)
            ) else left is right
        if isinstance(op, ast.IsNot):
            return not ExprVM._compare(ast.Is(), left, right)
        if _is_nil(left) or _is_nil(right):
            return False  # ordered compare with nil is never true
        if isinstance(op, ast.Lt):
            return left < right
        if isinstance(op, ast.LtE):
            return left <= right
        if isinstance(op, ast.Gt):
            return left > right
        if isinstance(op, ast.GtE):
            return left >= right
        if isinstance(op, ast.In):
            return left in right
        if isinstance(op, ast.NotIn):
            return left not in right
        raise ScriptError(f"unsupported comparison {type(op).__name__}")

    def _getattr(self, obj: Any, attr: str) -> Any:
        self._burn()
        if _is_nil(obj):
            return NIL
        if isinstance(obj, dict):
            return obj.get(attr, NIL)
        if obj is math:
            if attr not in _MATH_ALLOWED:
                raise ScriptError(f"math.{attr} is not allowed")
            return getattr(math, attr)
        if isinstance(obj, _KubeNamespace):
            return obj.get(attr)
        # whitelisted methods on concrete value types
        tp = type(obj)
        allowed = _METHOD_WHITELIST.get(tp)
        if allowed is not None and attr in allowed:
            bounded = _BOUNDED_METHODS.get((tp, attr))
            if bounded is not None:
                return lambda *args: bounded(obj, *args)
            return getattr(obj, attr)
        raise ScriptError(
            f"attribute {attr!r} is not allowed on {tp.__name__}"
        )


def _bounded_extend(obj: list, iterable: Any) -> None:
    items = list(iterable)
    if len(obj) + len(items) > MAX_VALUE_SIZE:
        raise ScriptError("extend result too large")
    obj.extend(items)


def _bounded_replace(obj: str, old: str, new: str, count: int = -1) -> str:
    # pre-check the worst-case result length before the C-speed allocation:
    # s.replace(a, s) multiplies len(s) by the occurrence count in one step
    old = str(old)
    new = str(new)
    if not old:
        occurrences = len(obj) + 1
    else:
        occurrences = obj.count(old)
    if count >= 0:
        occurrences = min(occurrences, count)
    grown = len(obj) + occurrences * max(len(new) - len(old), 0)
    if grown > MAX_VALUE_SIZE:
        raise ScriptError("replace result too large")
    return obj.replace(old, new, count)


def _bounded_join(obj: str, iterable: Any) -> str:
    parts = [str(p) for p in iterable]
    total = sum(len(p) for p in parts) + len(obj) * max(len(parts) - 1, 0)
    if total > MAX_VALUE_SIZE:
        raise ScriptError("join result too large")
    return obj.join(parts)


# growth-capable whitelisted methods routed through pre-checked wrappers;
# everything else on the whitelist is size-bounded by its receiver already
_BOUNDED_METHODS: dict[tuple[type, str], Callable] = {
    (list, "extend"): _bounded_extend,
    (str, "replace"): _bounded_replace,
    (str, "join"): _bounded_join,
}


_METHOD_WHITELIST: dict[type, frozenset] = {
    # NOTE: str.format / format_map are deliberately absent — the format
    # mini-language performs real attribute traversal ("{0.__class__}") and
    # would tunnel through the dunder ban; f-strings are safe because this
    # evaluator renders them itself
    str: frozenset({
        "lower", "upper", "strip", "startswith", "endswith", "split",
        "replace", "join", "find", "rstrip", "lstrip", "title",
    }),
    list: frozenset({"append", "extend", "insert", "pop", "remove",
                     "index", "count", "sort", "reverse"}),
    dict: frozenset({"get", "keys", "values", "items", "update", "pop",
                     "setdefault"}),
    set: frozenset({"add", "discard", "union", "intersection"}),
    tuple: frozenset({"index", "count"}),
}


class _KubeNamespace:
    """The reference's kube.lua helper surface."""

    _FNS = {
        "getResourceQuantity": _kube_get_resource_quantity,
        "accuratePodRequirements": _kube_accurate_pod_requirements,
        "getPodDependencies": _kube_get_pod_dependencies,
    }

    def get(self, name: str):
        fn = self._FNS.get(name)
        if fn is None:
            raise ScriptError(f"kube.{name} is not provided")
        return fn


def _num(v: Any) -> float:
    try:
        return float(v)
    except (TypeError, ValueError):
        return 0.0


def _bounded_range(*args) -> range:
    r = range(*args)
    if len(r) > MAX_ITERATIONS:
        raise ScriptError("range too large")
    return r
