"""Three-mode circuit evaluator (reference: compiler/src/evaluator/eval.rs).

Modes:
  * Collect        -- register function/template definitions only
  * GenConstraints -- symbolic execution producing R1CS rows
  * GenWitness     -- concrete execution producing signal values

Semantics ported exactly from the reference, including lexical scope
chains with start barriers (scope.rs), lazy component expansion on last
input assignment (eval.rs:415-479, 1112-1143), type-sorted signal
declaration order (eval.rs:436-452 -- load-bearing for public input
indices), deferred input values (eval.rs:853-858), ``#[w]``-tagged
statement skipping in GenConstraints (eval.rs:42-44), and the
``dbg!``/``dbg_signals!`` debug intrinsics (eval.rs:289-313, 1505-1570).
"""

from __future__ import annotations

import hashlib
import os
import time
from dataclasses import dataclass, field
from typing import Optional, Union

from ..algebra import (
    FS,
    AlgebraError,
    SignalId,
    Value,
    eval_infix as alg_eval_infix,
    eval_prefix as alg_eval_prefix,
)
from ..lang import ast as A
from ..lang.parser import ParseError, parse
from .constraints import Constraints
from .signals import Signals


class EvalError(Exception):
    def __init__(self, kind: str, msg: str):
        super().__init__(f"{kind}({msg})")
        self.kind = kind
        self.msg = msg


def _err(kind: str, msg: str) -> EvalError:
    return EvalError(kind, msg)


# -- evaluator value types (reference: evaluator/types.rs) -------------------


class List:
    """Nested n-dimensional array of algebra Values."""

    __slots__ = ("items", "value")

    def __init__(self, items=None, value: Optional[Value] = None):
        # leaf: value is set; node: items is a list of List
        self.items = items
        self.value = value

    @staticmethod
    def new(sizes: list[int]) -> "List":
        if not sizes:
            return List(value=Value(FS.zero()))
        return List(items=[List.new(sizes[1:]) for _ in range(sizes[0])])

    def is_leaf(self) -> bool:
        return self.items is None

    def get(self, indexes: list[int]) -> "List":
        if not indexes:
            return self
        if self.is_leaf():
            raise _err("InvalidSelector", f"index at [{indexes[0]}] contains a value")
        if indexes[0] >= len(self.items):
            raise _err("InvalidSelector", f"index at [{indexes[0]}] too large")
        return self.items[indexes[0]].get(indexes[1:])

    def set(self, value: Value, indexes: list[int]) -> None:
        if self.is_leaf():
            raise _err("InvalidSelector", f"index at [{indexes[0]}] contains a value")
        if not indexes or indexes[0] >= len(self.items):
            raise _err("InvalidSelector", f"invalid index for {self!r}")
        if len(indexes) == 1:
            self.items[indexes[0]] = List(value=value)
        else:
            self.items[indexes[0]].set(value, indexes[1:])

    def __repr__(self) -> str:
        if self.is_leaf():
            return f"Algebra({self.value})"
        return f"List([{', '.join(repr(i) for i in self.items)}])"


#: ReturnValue = Bool | Algebra | List
ReturnValue = Union[bool, Value, List]


def rv_repr(rv: ReturnValue) -> str:
    if isinstance(rv, bool):
        return f"Bool({'true' if rv else 'false'})"
    if isinstance(rv, Value):
        return f"Algebra({rv})"
    return f"List({rv!r})"


def try_into_algebra(rv: ReturnValue) -> Value:
    if isinstance(rv, Value):
        return rv
    raise _err("InvalidType", f"Cannot convert to algebraic value {rv_repr(rv)}")


def try_into_bool(rv: ReturnValue) -> bool:
    if isinstance(rv, bool):
        return rv
    raise _err("InvalidType", f"Cannot convert to boolean value {rv_repr(rv)}")


def try_into_fs(rv: ReturnValue) -> FS:
    if isinstance(rv, Value) and isinstance(rv.v, FS):
        return rv.v
    raise _err("InvalidType", f"Cannot convert to scalar value {rv_repr(rv)}")


def try_into_u64(rv: ReturnValue) -> int:
    fs = try_into_fs(rv)
    n = fs.try_to_int()
    if n is None:
        raise _err("CannotConvertToU64", str(fs))
    return n


# -- scope values (reference: evaluator/scope.rs) ----------------------------


class _Sentinel:
    def __init__(self, name: str):
        self.name = name

    def __repr__(self) -> str:
        return self.name


UNDEF_VAR = _Sentinel("UndefVar")
UNDEF_COMPONENT = _Sentinel("UndefComponent")


@dataclass
class Function:
    args: list[str]
    stmt: A.Statement
    path: str

    def __repr__(self) -> str:
        return f"Function({','.join(self.args)})"


@dataclass
class Template:
    attrs: tuple[str, ...]
    args: list[str]
    stmt: A.Statement
    path: str

    def __repr__(self) -> str:
        return f"Template({','.join(self.args)})"


@dataclass
class Component:
    template: str
    path: str
    args: list[ReturnValue]
    # [] => already expanded; otherwise signal ids pending assignment
    pending_inputs: list[SignalId] = field(default_factory=list)

    def __repr__(self) -> str:
        return f"Component({self.template},pending={self.pending_inputs})"


#: ScopeValue = UNDEF_VAR | UNDEF_COMPONENT | bool | Value | Function
#:              | Template | Component | List
ScopeValue = Union[_Sentinel, bool, Value, Function, Template, Component, List]


def sv_repr(sv: ScopeValue) -> str:
    if isinstance(sv, bool):
        return f"Bool({'true' if sv else 'false'})"
    if isinstance(sv, Value):
        return f"Algebra({sv})"
    if isinstance(sv, List):
        return f"List({sv!r})"
    return repr(sv)


def sv_from_return(rv: ReturnValue) -> ScopeValue:
    return rv  # representations coincide


class Scope:
    """Lexical scope chain with start barriers (scope.rs:100-197).

    Lookups walk towards the root but stop at scopes flagged ``start``
    (function/template/component boundaries); ``root()`` skips to the
    global scope where functions/templates live.
    """

    __slots__ = ("start_flag", "prev", "pos", "vars", "return_value")

    def __init__(self, start: bool, prev: Optional["Scope"], pos: str):
        self.start_flag = start
        self.prev = prev
        self.pos = pos
        self.vars: dict[str, ScopeValue] = {}
        self.return_value: Optional[ReturnValue] = None

    def root(self) -> "Scope":
        it = self
        while it.prev is not None:
            it = it.prev
        return it

    def start(self) -> "Scope":
        it = self
        while not it.start_flag:
            it = it.prev
        return it

    def insert(self, k: str, v: ScopeValue) -> None:
        if k in self.vars:
            raise _err("AlreadyExists", k)
        self.vars[k] = v

    def _find(self, key: str) -> Optional["Scope"]:
        it = self
        while True:
            if key in it.vars:
                return it
            if it.prev is None or it.start_flag:
                return None
            it = it.prev

    def get(self, key: str) -> Optional[ScopeValue]:
        sc = self._find(key)
        return sc.vars[key] if sc is not None else None

    def set_existing(self, key: str, v: ScopeValue) -> None:
        sc = self._find(key)
        if sc is None:
            raise _err("NotFound", key)
        sc.vars[key] = v

    def contains_key(self, key: str) -> bool:
        return self._find(key) is not None

    def update(self, key: str, v: ScopeValue) -> None:
        self.set_existing(key, v)

    def set_return(self, v: ReturnValue) -> None:
        self.start().return_value = v

    def take_return(self) -> Optional[ReturnValue]:
        sc = self.start()
        v, sc.return_value = sc.return_value, None
        return v

    def has_return(self) -> bool:
        return self.start().return_value is not None

    def __repr__(self) -> str:
        lines = ["--------------------------------------------", self.pos,
                 f"  start: {str(self.start_flag).lower()}",
                 f"  return_value: {self.return_value}"]
        if self.prev is not None:
            for k in sorted(self.vars):
                lines.append(f"  {k}: {sv_repr(self.vars[k])}")
            lines.append(repr(self.prev))
        return "\n".join(lines)


# -- error context -----------------------------------------------------------


@dataclass
class ErrorContext:
    scope: str
    meta: A.Meta
    file: str
    component: str
    function: Optional[str]


class Mode:
    COLLECT = "collect"
    GEN_CONSTRAINTS = "gen_constraints"
    GEN_WITNESS = "gen_witness"


class Evaluator:
    def __init__(self, mode: str, signals: Optional[Signals] = None,
                 constraints: Optional[Constraints] = None):
        self.mode = mode
        self.signals = signals if signals is not None else Signals()
        self.constraints = constraints if constraints is not None else Constraints()
        self.current_file = ""
        self.current_component = ""
        self.current_function: Optional[str] = None
        self.processed_files: list[str] = []
        self.collected_asts: list[A.BodyElement] = []
        self.last_error: Optional[ErrorContext] = None
        self.path = "."
        self.deferred_signal_values: dict[str, Value] = {}
        self.debug = False
        self._last_constraint_t = time.monotonic()
        # optional witness-trace recorder (compiler/wtrace.py); when set,
        # deferred input values are wrapped as traced scalars so the run
        # records a replayable witness program
        self.wtrace = None

    # -- mode helpers -------------------------------------------------------

    def _skip_eval(self, meta: A.Meta) -> bool:
        return self.mode == Mode.GEN_CONSTRAINTS and meta.has_tag_w()

    def _must_process_root_decl(self) -> bool:
        return self.mode != Mode.COLLECT

    # -- public interface ---------------------------------------------------

    def eval_inline(self, scope: Scope, code: str) -> None:
        try:
            elements = parse(code)
        except ParseError as exc:
            self._register_error(exc.meta, scope)
            raise _err("Parse", exc.msg) from exc
        self._eval_body_elements(A.Meta(0, 0), scope, elements)
        self.collected_asts.extend(elements)

    def eval_template(self, scope: Scope, template_name: str) -> None:
        tpl = scope.get(template_name)
        if not isinstance(tpl, Template):
            raise _err("NotFound", f"template {template_name}")
        inner = Scope(True, scope, tpl.path)
        self._eval_statement(inner, tpl.stmt)

    def eval_file(self, path: str, filename: str) -> Scope:
        self.path = path
        scope = Scope(True, None, filename)
        self._eval_include(A.Meta(0, 0), scope, filename)
        return scope

    def eval_asts(self, asts: list[A.BodyElement]) -> Scope:
        """Evaluate pre-parsed ASTs (the pk-stored-program path,
        eval.rs:134-161): defs first, then root declarations."""
        scope = Scope(True, None, "")
        for be in asts:
            if isinstance(be, A.BFunctionDef):
                self._eval_function_def(be.meta, scope, be.name, be.args, be.stmt)
            elif isinstance(be, A.BTemplateDef):
                self._eval_template_def(be.meta, scope, be.name, be.args, be.stmt)
        for be in asts:
            if isinstance(be, A.BDeclaration):
                self._eval_statement(scope, be.decl)
        return scope

    def set_deferred_value(self, signal_full_name: str, value: Value) -> None:
        if self.wtrace is not None and isinstance(value.v, FS):
            value = Value(self.wtrace.input(signal_full_name, value.v))
        self.deferred_signal_values[signal_full_name] = value

    # -- error bookkeeping --------------------------------------------------

    def _register_error(self, meta: A.Meta, scope: Scope) -> None:
        if self.last_error is None:
            self.last_error = ErrorContext(
                scope=repr(scope),
                meta=meta,
                file=self.current_file,
                component=self.current_component,
                function=self.current_function,
            )

    def _guard(self, meta: A.Meta, scope: Scope, fn):
        """Run fn(), capturing the first error context (eval.rs:169-180)."""
        try:
            return fn()
        except (EvalError, AlgebraError):
            self._register_error(meta, scope)
            raise

    # -- expression dispatch ------------------------------------------------

    def _eval_expression(self, scope: Scope, e: A.Expression) -> ReturnValue:
        if isinstance(e, A.EFunctionCall):
            return self._eval_function_call(e.meta, scope, e.name, e.args)
        if isinstance(e, A.EVariable):
            return self._eval_variable(e.meta, scope, e.name)
        if isinstance(e, A.ENumber):
            return Value(FS(e.value))
        if isinstance(e, A.EPrefixOp):
            return self._eval_prefix_op(e.meta, scope, e.op, e.rhe)
        if isinstance(e, A.EInfixOp):
            return self._eval_infix_op(e.meta, scope, e.lhe, e.op, e.rhe)
        if isinstance(e, A.EArray):
            return self._eval_array(e.meta, scope, e.values)
        raise TypeError(e)

    def _eval_statement(self, scope: Scope, s: A.Statement) -> None:
        if isinstance(s, A.SIfThenElse):
            self._eval_if_then_else(s.meta, scope, s.xif, s.xthen, s.xelse)
        elif isinstance(s, A.SFor):
            self._eval_for(s.meta, scope, s.init, s.cond, s.step, s.stmt)
        elif isinstance(s, A.SWhile):
            self._eval_while(s.meta, scope, s.cond, s.stmt)
        elif isinstance(s, A.SReturn):
            self._eval_return(s.meta, scope, s.value)
        elif isinstance(s, A.SDeclaration):
            self._eval_declaration(s.meta, scope, s.xtype, s.stype, s.name, s.init)
        elif isinstance(s, A.SSubstitution):
            self._eval_substitution(s.meta, scope, s.name, s.op, s.value)
        elif isinstance(s, A.SBlock):
            self._eval_block(s.meta, scope, s.stmts)
        elif isinstance(s, A.SSignalLeft):
            self._eval_signal_left(s.meta, scope, s.name, s.op, s.value)
        elif isinstance(s, A.SSignalRight):
            self._eval_signal_right(s.meta, scope, s.value, s.op, s.name)
        elif isinstance(s, A.SSignalEq):
            self._eval_signal_eq(s.meta, scope, s.lhe, s.rhe)
        elif isinstance(s, A.SInternalCall):
            self._eval_internal_call(s.meta, scope, s.name, s.args)
        else:
            raise TypeError(s)

    def _eval_body_element(self, scope: Scope, be: A.BodyElement) -> None:
        if isinstance(be, A.BInclude):
            self._eval_include(be.meta, scope, be.path)
        elif isinstance(be, A.BFunctionDef):
            self._eval_function_def(be.meta, scope, be.name, be.args, be.stmt)
        elif isinstance(be, A.BTemplateDef):
            self._eval_template_def(be.meta, scope, be.name, be.args, be.stmt)
        elif isinstance(be, A.BDeclaration):
            self._eval_statement(scope, be.decl)
        else:
            raise TypeError(be)

    def _eval_body_elements(
        self, meta: A.Meta, scope: Scope, bes: list[A.BodyElement]
    ) -> None:
        def run():
            for be in bes:
                self._eval_body_element(scope, be)

        self._guard(meta, scope, run)

    # -- internal calls (dbg!) ----------------------------------------------

    def _eval_internal_call(
        self, meta: A.Meta, scope: Scope, name: str, params: list[A.Expression]
    ) -> None:
        def run():
            if name == "dbg_signals":
                for n in range(len(self.signals)):
                    print(repr(self.signals.get_by_id(n)))
            elif name == "dbg":
                print("DBG ", end="")
                for param in params:
                    self._dbg_print(scope, param)
                print()
            else:
                raise _err("NotFound", f"internal funcion {name}!")

        self._guard(meta, scope, run)

    def _dbg_print(self, scope: Scope, expr: A.Expression) -> None:
        if isinstance(expr, A.EVariable):
            var = expr.name
            if var.name == "CTX" and not var.sels:
                print(
                    f"CTX => {self.current_component} "
                    f"{self.current_file}:{expr.meta.start}"
                )
                return
            if var.name == "SCOPE" and not var.sels:
                print(repr(scope))
                return
            if var.name == "TRACEON" and not var.sels:
                self.debug = True
                return
            if var.name == "TRACEOFF" and not var.sels:
                self.debug = False
                return
            full_name = self._expand_selectors(scope, var)
            sv = scope.get(full_name)
            if isinstance(sv, Component):
                pending = ",".join(
                    f"{self.signals.get_by_id(s).full_name}"
                    for s in sv.pending_inputs
                )
                print(f"{full_name} => pending_inputs {{{pending}}} ")
                return
        value = self._eval_expression(scope, expr)
        if isinstance(value, Value):
            print(f"{expr.format()} => {self.signals.format(value)} ", end="")
        else:
            print(f"{expr.format()} => {rv_repr(value)} ", end="")

    # -- functions / templates ----------------------------------------------

    def _eval_function_call(
        self, meta: A.Meta, scope: Scope, name: str, params: list[A.Expression]
    ) -> ReturnValue:
        self._trace(meta, lambda: f"eval_function_call {name}")

        def run():
            fn = scope.root().get(name)
            if not isinstance(fn, Function):
                raise _err("NotFound", f"function {name}")
            if len(fn.args) != len(params):
                raise _err("InvalidParameter", name)

            func_scope = Scope(True, scope, f"{self.current_file}:{meta.start}")
            for arg, param in zip(fn.args, params):
                value = self._eval_expression(scope, param)
                func_scope.insert(arg, sv_from_return(value))

            saved_fn, self.current_function = self.current_function, name
            saved_file, self.current_file = self.current_file, fn.path
            try:
                self._eval_statement(func_scope, fn.stmt)
            finally:
                self.current_function = saved_fn
                self.current_file = saved_file

            ret = func_scope.take_return()
            if ret is None:
                raise _err("BadFunctionReturn", name)
            return ret

        return self._guard(meta, scope, run)

    def _eval_function_def(
        self, meta: A.Meta, scope: Scope, name: str, args: list[str],
        stmt: A.Statement,
    ) -> None:
        def run():
            scope.insert(name, Function(list(args), stmt, self.current_file))

        self._guard(meta, scope, run)

    def _eval_template_def(
        self, meta: A.Meta, scope: Scope, name: str, args: list[str],
        stmt: A.Statement,
    ) -> None:
        def run():
            scope.insert(
                name, Template(meta.attrs, list(args), stmt, self.current_file)
            )

        self._guard(meta, scope, run)

    # -- components ----------------------------------------------------------

    def _eval_component_decl(self, scope: Scope, var: A.VariableP) -> None:
        for selector_name in self._generate_selectors(scope, var):
            scope.insert(selector_name, UNDEF_COMPONENT)

    def _eval_component_inst(
        self, meta: A.Meta, scope: Scope, component_name: str, init: A.Expression
    ) -> None:
        self._trace(meta, lambda: f"eval_component_inst {component_name}")

        def run():
            bad_tpl = _err(
                "InvalidType",
                f"component {component_name} only can be initialized with "
                "existingtemplate",
            )
            if not isinstance(init, A.EFunctionCall):
                raise bad_tpl
            template_name, params = init.name, init.args
            tpl = scope.root().get(template_name)
            if not isinstance(tpl, Template):
                raise bad_tpl
            if len(tpl.args) != len(params):
                raise _err(
                    "InvalidParameter",
                    f"Invalid parameter count when instantiating {template_name}",
                )

            evalargs: list[ReturnValue] = []
            all_pending: list[SignalId] = []
            template_scope = Scope(True, scope, f"{self.current_file}:{meta.start}")
            for arg, param in zip(tpl.args, params):
                value = self._eval_expression(scope, param)
                evalargs.append(value)
                template_scope.insert(arg, sv_from_return(value))

            saved_comp = self.current_component
            saved_file = self.current_file
            self.current_component = self._expand_full_name(component_name)
            self.current_file = tpl.path
            try:
                if not isinstance(tpl.stmt, A.SBlock):
                    raise TypeError("template body must be a block")
                # declare signals sorted by type (eval.rs:436-452)
                sigdecls = [
                    s
                    for s in tpl.stmt.stmts
                    if isinstance(s, A.SDeclaration)
                    and s.xtype == A.VariableType.SIGNAL
                ]
                sigdecls.sort(key=lambda s: int(s.stype))
                for sd in sigdecls:
                    pending = self._eval_declaration_signals(
                        sd.meta, template_scope, sd.stype, sd.name
                    )
                    is_input = sd.stype in (
                        A.SignalType.PublicInput,
                        A.SignalType.PrivateInput,
                    )
                    is_not_main_in_genconstraints = not (
                        component_name == "main"
                        and self.mode == Mode.GEN_CONSTRAINTS
                    )
                    if is_input and is_not_main_in_genconstraints:
                        all_pending.extend(pending)
            finally:
                self.current_component = saved_comp
                self.current_file = saved_file

            component = Component(
                template=template_name,
                path=tpl.path,
                args=evalargs,
                pending_inputs=all_pending,
            )
            if scope.get(component_name) is None:
                raise _err("NotFound", component_name)
            scope.set_existing(component_name, component)

            if not all_pending:
                self._eval_component_expand(meta, scope, component_name)

        self._guard(meta, scope, run)

    def _eval_component_expand(
        self, meta: A.Meta, scope: Scope, component_name: str
    ) -> None:
        self._trace(meta, lambda: f"eval_component_expand {component_name}")

        component = scope.get(component_name)
        assert isinstance(component, Component)
        tpl = scope.root().get(component.template)
        assert isinstance(tpl, Template)

        template_scope = Scope(True, scope, f"{self.current_file}:{meta.start}")
        for arg, value in zip(tpl.args, component.args):
            template_scope.insert(arg, sv_from_return(value))

        saved_comp = self.current_component
        saved_file = self.current_file
        self.current_component = self._expand_full_name(component_name)
        self.current_file = tpl.path
        try:
            self._eval_statement(template_scope, tpl.stmt)
        finally:
            self.current_component = saved_comp
            self.current_file = saved_file

    # -- variables ------------------------------------------------------------

    def _eval_variable(
        self, meta: A.Meta, scope: Scope, var: A.VariableP
    ) -> ReturnValue:
        def run():
            # signal?
            name_sel = self._expand_selectors(scope, var)
            name_sel_full = self._expand_full_name(name_sel)
            signal = self.signals.get_by_name(name_sel_full)
            if signal is not None:
                if signal.value is not None and isinstance(signal.value.v, FS):
                    return Value(signal.value.v)
                return Value.from_signal(signal.id)

            # variable?
            sv = scope.get(var.name)
            if sv is None:
                raise _err("NotFound", name_sel)
            if isinstance(sv, Value):
                return sv
            if isinstance(sv, bool):
                return sv
            if isinstance(sv, List):
                indexes = []
                for sel in var.sels:
                    if not isinstance(sel, A.SelIndex):
                        raise _err("InvalidSelector", f"Invalid selector {sel}")
                    indexes.append(
                        try_into_u64(self._eval_expression(scope, sel.pos))
                    )
                node = sv.get(indexes)
                if node.is_leaf():
                    return node.value
                return node
            raise _err(
                "InvalidType",
                f"expected valid value from variable '{name_sel}' "
                f"(current is '{sv_repr(sv)}') [nameselfull={name_sel_full}]",
            )

        return self._guard(meta, scope, run)

    # -- operators -------------------------------------------------------------

    def _eval_prefix_op(
        self, meta: A.Meta, scope: Scope, op: str, rhe: A.Expression
    ) -> ReturnValue:
        def run():
            right = try_into_algebra(self._eval_expression(scope, rhe))
            return alg_eval_prefix(op, right)

        return self._guard(meta, scope, run)

    def _eval_infix_op(
        self, meta: A.Meta, scope: Scope, lhe: A.Expression, op: str,
        rhe: A.Expression,
    ) -> ReturnValue:
        def run():
            left = self._eval_expression(scope, lhe)
            right = self._eval_expression(scope, rhe)
            O = A.Opcode

            if op in (
                O.ADD, O.SUB, O.MUL, O.DIV, O.INTDIV, O.MOD, O.SHL, O.SHR,
                O.BITAND, O.BITOR, O.BITXOR, O.POW,
            ):
                return alg_eval_infix(
                    try_into_algebra(left), op, try_into_algebra(right)
                )
            if op == O.BOOLAND:
                return try_into_bool(left) and try_into_bool(right)
            if op == O.BOOLOR:
                return try_into_bool(left) or try_into_bool(right)
            if op == O.GREATER:
                return try_into_fs(left) > try_into_fs(right)
            if op == O.GREATEREQ:
                return try_into_fs(left) >= try_into_fs(right)
            if op == O.LESSER:
                return try_into_fs(left) < try_into_fs(right)
            if op == O.LESSEREQ:
                return try_into_fs(left) <= try_into_fs(right)
            if op in (O.EQ, O.NOTEQ):
                if isinstance(left, bool) and isinstance(right, bool):
                    eq = left == right
                elif (
                    isinstance(left, Value)
                    and isinstance(left.v, FS)
                    and isinstance(right, Value)
                    and isinstance(right.v, FS)
                ):
                    eq = left.v == right.v
                else:
                    raise _err(
                        "InvalidType",
                        f"Cannot compare {rv_repr(left)}=={rv_repr(right)}",
                    )
                return eq if op == O.EQ else not eq
            raise _err("NotYetImplemented", f"eval_infix_op '{op}'")

        return self._guard(meta, scope, run)

    def _eval_array(
        self, meta: A.Meta, scope: Scope, exprs: list[A.Expression]
    ) -> ReturnValue:
        def run():
            out = []
            for expr in exprs:
                v = self._eval_expression(scope, expr)
                if isinstance(v, Value):
                    out.append(List(value=v))
                elif isinstance(v, List):
                    out.append(v)
                else:
                    raise _err("InvalidType", f"array element {rv_repr(v)}")
            return List(items=out)

        return self._guard(meta, scope, run)

    # -- control flow ----------------------------------------------------------

    def _eval_if_then_else(
        self, meta, scope, xif, xthen, xelse
    ) -> None:
        if self._skip_eval(meta):
            return

        def run():
            cond = self._eval_expression(scope, xif)
            if not isinstance(cond, bool):
                raise _err("InvalidType", "if condition is not boolean")
            if cond:
                self._eval_statement(scope, xthen)
            elif xelse is not None:
                self._eval_statement(scope, xelse)

        self._guard(meta, scope, run)

    def _eval_for(self, meta, scope, init, cond, step, stmt) -> None:
        if self._skip_eval(meta):
            return
        inner = Scope(False, scope, f"{self.current_file}:{meta.start}")

        def run():
            self._eval_statement(inner, init)
            while True:
                c = self._eval_expression(inner, cond)
                if not isinstance(c, bool):
                    raise _err("InvalidType", "for loop condition is not boolean")
                if not c:
                    break
                self._eval_statement(inner, stmt)
                if inner.has_return():
                    break
                self._eval_statement(inner, step)

        self._guard(meta, inner, run)

    def _eval_while(self, meta, scope, cond, stmt) -> None:
        if self._skip_eval(meta):
            return
        inner = Scope(False, scope, f"{self.current_file}:{meta.start}")

        def run():
            while True:
                c = self._eval_expression(inner, cond)
                if not isinstance(c, bool):
                    raise _err("InvalidType", "while loop condition is not boolean")
                if not c:
                    break
                self._eval_statement(inner, stmt)
                if inner.has_return():
                    break

        self._guard(meta, inner, run)

    def _eval_return(self, meta, scope, expr) -> None:
        self._trace(meta, lambda: "eval_return")
        if self._skip_eval(meta):
            return

        def run():
            scope.set_return(self._eval_expression(scope, expr))

        self._guard(meta, scope, run)

    def _eval_block(self, meta, scope, stmts) -> None:
        if self._skip_eval(meta):
            return

        def run():
            inner = Scope(False, scope, f"{self.current_file}:{meta.start}")
            for stmt in stmts:
                self._eval_statement(inner, stmt)
                if inner.has_return():
                    break

        self._guard(meta, scope, run)

    # -- declarations -----------------------------------------------------------

    def _eval_declaration_signals(
        self, meta: A.Meta, scope: Scope, xtype: A.SignalType, var: A.VariableP
    ) -> list[SignalId]:
        pending: list[SignalId] = []
        for signal_name in self._generate_selectors(scope, var):
            full_name = self._expand_full_name(signal_name)
            if self.signals.get_by_name(full_name) is not None:
                raise _err("AlreadyExists", f"signal {full_name}")
            deferred = self.deferred_signal_values.pop(full_name, None)
            if deferred is not None:
                self.signals.insert(full_name, xtype, deferred)
            else:
                pending.append(self.signals.insert(full_name, xtype, None))
        return pending

    def _eval_declaration(
        self, meta, scope, xtype, stype, var: A.VariableP, init
    ) -> None:
        if self._skip_eval(meta):
            return
        if not self.current_component and not self._must_process_root_decl():
            return

        def run():
            if scope.contains_key(var.name):
                raise _err("AlreadyExists", var.name)

            if xtype == A.VariableType.VAR and init is None:
                if not var.sels:
                    scope.insert(var.name, UNDEF_VAR)
                else:
                    sizes = self._expand_indexes(scope, var.sels)
                    scope.insert(var.name, List.new(sizes))
            elif xtype == A.VariableType.VAR:
                op, expr = init
                if op != A.Opcode.ASSIG:
                    raise _err(
                        "InvalidType",
                        f"Unsupported type for var '{var.name}' declaration",
                    )
                value = self._eval_expression(scope, expr)
                if isinstance(value, (Value, bool, List)):
                    scope.insert(var.name, sv_from_return(value))
                else:
                    raise _err(
                        "InvalidType",
                        f"Unsupported type for var '{var.name}' declaration",
                    )
            elif xtype == A.VariableType.COMPONENT and init is not None:
                self._eval_component_decl(scope, var)
                var_w_selectors = self._expand_selectors(scope, var)
                self._eval_component_inst(meta, scope, var_w_selectors, init[1])
            elif xtype == A.VariableType.COMPONENT:
                self._eval_component_decl(scope, var)
            elif xtype == A.VariableType.SIGNAL:
                # top-level signal declarations are consumed during component
                # instantiation (eval.rs:935); nothing to do here
                pass
            else:
                raise _err("NotYetImplemented", f"eval_declaration {var}")

        self._guard(meta, scope, run)

    def _eval_substitution(
        self, meta, scope, var: A.VariableP, op: str, expr: A.Expression
    ) -> None:
        if self._skip_eval(meta):
            return

        def run():
            var_sel = self._expand_selectors(scope, var)
            if scope.get(var_sel) is UNDEF_COMPONENT:
                self._eval_component_inst(meta, scope, var_sel, expr)
                return

            right = try_into_algebra(self._eval_expression(scope, expr))
            if op == A.Opcode.ASSIG:
                value = right
            else:
                left = try_into_algebra(self._eval_variable(meta, scope, var))
                base = A.Opcode.ASSIG_BASE[op]
                value = alg_eval_infix(left, base, right)

            if not var.sels:
                scope.update(var.name, value)
            elif isinstance(var.sels[0], A.SelIndex):
                indexes = self._expand_indexes(scope, var.sels)
                sv = scope.get(var.name)
                if sv is None:
                    raise _err("NotFound", var.name)
                if not isinstance(sv, List):
                    raise _err("InvalidType", var.name)
                sv.set(value, indexes)

        self._guard(meta, scope, run)

    # -- signals ---------------------------------------------------------------

    def _eval_signal_left(
        self, meta, scope, signal: A.VariableP, op: str, expr: A.Expression
    ) -> None:
        self._trace(meta, lambda: f"eval_signal_left {signal.format()}")

        def run():
            # S <== e: in GenConstraints constrain-then-assign; in GenWitness
            # assign-then-check (eval.rs:1064-1160)
            if (
                self.mode == Mode.GEN_CONSTRAINTS
                and op == A.Opcode.SIGNAL_CONSTRAIN_LEFT
            ):
                self._eval_signal_eq(
                    meta, scope, A.EVariable(meta, signal), expr
                )

            if not self._skip_eval(meta):
                self._trace(meta, lambda: f"eval_signal_left <-- {signal.format()}")
                signal_sel = self._expand_selectors(scope, signal)
                signal_full = self._expand_full_name(signal_sel)
                sig = self.signals.get_by_name(signal_full)
                if sig is None:
                    raise _err("NotFound", f"Signal {signal_full}")
                signal_id = sig.id
                v = self._eval_expression(scope, expr)
                if not isinstance(v, Value):
                    raise _err("InvalidType", f"Cannot assign {rv_repr(v)} to signal")
                self.signals.update(signal_id, v)

                component_name = self._signal_component(scope, signal)
                if component_name is not None:
                    comp = scope.get(component_name)
                    if not isinstance(comp, Component):
                        raise _err(
                            "NotFound",
                            f"signal not found '{signal.name}' in scope {meta}",
                        )
                    needs_expansion = False
                    if comp.pending_inputs:
                        comp.pending_inputs = [
                            s for s in comp.pending_inputs if s != signal_id
                        ]
                        needs_expansion = not comp.pending_inputs
                    if needs_expansion:
                        self._trace(
                            meta,
                            lambda: f"eval_signal_left_lazy_eval {component_name}",
                        )
                        self._eval_component_expand(meta, scope, component_name)

            if (
                self.mode == Mode.GEN_WITNESS
                and op == A.Opcode.SIGNAL_CONSTRAIN_LEFT
            ):
                self._eval_signal_eq(
                    meta, scope, A.EVariable(meta, signal), expr
                )

        self._guard(meta, scope, run)

    def _eval_signal_right(
        self, meta, scope, expr: A.Expression, op: str, signal: A.VariableP
    ) -> None:
        self._trace(meta, lambda: f"eval_signal_right {signal.format()}")
        if self._skip_eval(meta):
            return
        if op == A.Opcode.SIGNAL_CONSTRAIN_RIGHT:
            self._eval_signal_left(
                meta, scope, signal, A.Opcode.SIGNAL_CONSTRAIN_LEFT, expr
            )
        elif op == A.Opcode.SIGNAL_WIRE_RIGHT:
            self._eval_signal_left(
                meta, scope, signal, A.Opcode.SIGNAL_WIRE_LEFT, expr
            )
        else:
            raise TypeError(op)

    def _eval_signal_eq(
        self, meta, scope, lhe: A.Expression, rhe: A.Expression
    ) -> None:
        self._trace(
            meta, lambda: f"eval_signal_eq {lhe.format()} {rhe.format()}"
        )

        def run():
            left = try_into_algebra(self._eval_expression(scope, lhe))
            right = try_into_algebra(self._eval_expression(scope, rhe))
            constrain = alg_eval_infix(left, A.Opcode.SUB, right)

            if self.mode == Mode.GEN_WITNESS:
                if not (isinstance(constrain.v, FS) and constrain.v.is_zero()):
                    raise _err(
                        "CannotTestConstrain",
                        f"{lhe.format()}==={rhe.format()} => "
                        f"{self.signals.format(left)}==="
                        f"{self.signals.format(right)}",
                    )
            elif self.mode == Mode.GEN_CONSTRAINTS:
                if isinstance(constrain.v, FS):
                    raise _err(
                        "CannotGenerateConstrain",
                        f"{self.signals.format(left)}==="
                        f"{self.signals.format(right)}",
                    )
                qeq = constrain.into_qeq()
                if self.debug:
                    count = self.constraints.push(
                        qeq, f"{self.current_file}:{meta.start}"
                    )
                else:
                    count = self.constraints.push(qeq, None)
                if count > 0 and count % 100_000 == 0:
                    now = time.monotonic()
                    dt = now - self._last_constraint_t
                    rate = int(100_000 / dt) if dt > 0 else 0
                    print(f"Generated {count} constrains, @ {rate} c/s")
                    self._last_constraint_t = now

        self._guard(meta, scope, run)

    # -- includes ---------------------------------------------------------------

    def _eval_include(self, meta, scope, filename: str) -> None:
        def run():
            full_path = os.path.join(self.path, filename)
            try:
                with open(full_path, "r") as f:
                    code = f.read()
            except OSError as exc:
                raise _err("Io", f"{full_path}: {exc}") from exc

            h = hashlib.blake2b(code.encode(), digest_size=64).hexdigest()
            if h in self.processed_files:
                return
            self.processed_files.append(h)

            saved_file = self.current_file
            saved_path = self.path
            self.current_file = full_path
            self.path = os.path.dirname(full_path) or "."
            try:
                try:
                    elements = parse(code)
                except ParseError as exc:
                    self._register_error(exc.meta, scope)
                    raise _err("Parse", exc.msg) from exc
                self._eval_body_elements(A.Meta(0, 0), scope, elements)
                self.collected_asts.extend(elements)
            finally:
                self.path = saved_path
                self.current_file = saved_file

        self._guard(meta, scope, run)

    # -- helpers ----------------------------------------------------------------

    def _trace(self, meta: A.Meta, f) -> None:
        if self.debug:
            print(f"*trace {f()} {self.current_file}:{meta.start}")

    def _generate_selectors(self, scope: Scope, var: A.VariableP) -> list[str]:
        """Expand ``a[2][3]`` decl into name-mangled instances
        ``a[0][0] .. a[1][2]`` (eval.rs:1383-1421)."""
        sizes = []
        for sel in var.sels:
            if not isinstance(sel, A.SelIndex):
                raise _err("InvalidType", f"selectors for {var.name}")
            sizes.append(try_into_u64(self._eval_expression(scope, sel.pos)))

        out: list[str] = []

        def rec(prefix: str, rest: list[int]) -> None:
            if not rest:
                out.append(prefix)
            else:
                for i in range(rest[0]):
                    rec(f"{prefix}[{i}]", rest[1:])

        rec(var.name, sizes)
        return out

    def _expand_selectors(
        self, scope: Scope, v: A.VariableP, limit: Optional[int] = None
    ) -> str:
        v_sel = v.name
        for i, sel in enumerate(v.sels):
            if limit is not None and i == limit:
                return v_sel
            if isinstance(sel, A.SelIndex):
                index = try_into_u64(self._eval_expression(scope, sel.pos))
                v_sel += f"[{index}]"
            else:
                v_sel += f".{sel.name}"
        return v_sel

    def _expand_indexes(self, scope: Scope, sels) -> list[int]:
        indexes = []
        for sel in sels:
            if not isinstance(sel, A.SelIndex):
                raise _err("InvalidSelector", f"Invalid selector {sel}")
            indexes.append(try_into_u64(self._eval_expression(scope, sel.pos)))
        return indexes

    def _signal_component(
        self, scope: Scope, signal: A.VariableP
    ) -> Optional[str]:
        """``a[1].b[2].c`` -> component prefix ``a[1].b[2]``
        (eval.rs:1469-1495)."""
        last_pin = len(signal.sels)
        found = False
        while not found and last_pin > 0:
            if isinstance(signal.sels[last_pin - 1], A.SelIndex):
                last_pin -= 1
            else:
                found = True
        if found:
            return self._expand_selectors(scope, signal, limit=last_pin - 1)
        return None

    def _expand_full_name(self, s: str) -> str:
        if not self.current_component:
            return s
        return f"{self.current_component}.{s}"
