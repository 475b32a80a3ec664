"""AST for the Za dialect of circom.

Node set mirrors the reference parse tree (parser/src/ast.rs):
expressions (6 variants), statements (11 variants), body elements
(4 variants), selectors (pin / index), plus Meta spans and ``#[...]``
attributes. The ``format()`` methods reproduce the reference
pretty-printer (parser/src/display.rs) so round-trip tests carry over.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum
from typing import Optional, Union


class Opcode:
    """Operator codes; ``.sym`` mapping matches display.rs:177-220.

    Values are short semantic names shared with the algebra module's dispatch.
    """

    MUL = "mul"
    DIV = "div"
    ADD = "add"
    SUB = "sub"
    POW = "pow"
    INTDIV = "intdiv"
    MOD = "mod"
    SHL = "shl"
    SHR = "shr"
    LESSEREQ = "lessereq"
    GREATEREQ = "greatereq"
    LESSER = "lesser"
    GREATER = "greater"
    EQ = "eq"
    NOTEQ = "noteq"
    BOOLOR = "boolor"
    BOOLAND = "booland"
    BITOR = "bor"
    BITAND = "band"
    BITXOR = "bxor"
    BOOLNOT = "boolnot"
    ASSIG = "assig"
    ASSIG_ADD = "assig_add"
    ASSIG_SUB = "assig_sub"
    ASSIG_MUL = "assig_mul"
    ASSIG_DIV = "assig_div"
    ASSIG_MOD = "assig_mod"
    ASSIG_SHL = "assig_shl"
    ASSIG_SHR = "assig_shr"
    ASSIG_BITAND = "assig_band"
    ASSIG_BITOR = "assig_bor"
    ASSIG_BITXOR = "assig_bxor"
    SIGNAL_WIRE_LEFT = "signal_wire_left"
    SIGNAL_WIRE_RIGHT = "signal_wire_right"
    SIGNAL_CONSTRAIN_LEFT = "signal_constrain_left"
    SIGNAL_CONSTRAIN_RIGHT = "signal_constrain_right"
    SIGNAL_CONSTRAIN_EQ = "signal_constrain_eq"

    SYM = {
        MUL: "*", DIV: "/", ADD: "+", SUB: "-", POW: "**", INTDIV: "\\",
        MOD: "%", SHL: "<<", SHR: ">>", LESSEREQ: "<=", GREATEREQ: ">=",
        LESSER: "<", GREATER: ">", EQ: "==", NOTEQ: "!=", BOOLOR: "||",
        BOOLAND: "&&", BITOR: "|", BITAND: "&", BITXOR: "^", BOOLNOT: "!",
        ASSIG: "=", ASSIG_ADD: "+=", ASSIG_SUB: "-=", ASSIG_MUL: "*=",
        ASSIG_DIV: "/=", ASSIG_MOD: "%=", ASSIG_SHL: "<<=", ASSIG_SHR: ">>=",
        ASSIG_BITAND: "&=", ASSIG_BITOR: "|=", ASSIG_BITXOR: "^=",
        SIGNAL_WIRE_LEFT: "<--", SIGNAL_WIRE_RIGHT: "-->",
        SIGNAL_CONSTRAIN_LEFT: "<==", SIGNAL_CONSTRAIN_RIGHT: "==>",
        SIGNAL_CONSTRAIN_EQ: "===",
    }

    #: maps assignment opcode -> underlying infix opcode
    ASSIG_BASE = {
        ASSIG_ADD: ADD, ASSIG_SUB: SUB, ASSIG_MUL: MUL, ASSIG_DIV: DIV,
        ASSIG_MOD: MOD, ASSIG_SHL: SHL, ASSIG_SHR: SHR,
        ASSIG_BITAND: BITAND, ASSIG_BITOR: BITOR, ASSIG_BITXOR: BITXOR,
    }


def opsym(op: str) -> str:
    return Opcode.SYM[op]


class SignalType(IntEnum):
    """Declaration order matters: signals are sorted by this enum when a
    component is instantiated (ast.rs:182-187 Ord derive; eval.rs:436-452)."""

    Output = 0
    PublicInput = 1
    PrivateInput = 2
    Internal = 3


class VariableType:
    VAR = "var"
    COMPONENT = "component"
    SIGNAL = "signal"  # paired with a SignalType


@dataclass
class Meta:
    """Source span (byte offsets into the preprocessed source) + attrs."""

    start: int = 0
    end: int = 0
    attrs: tuple[str, ...] = ()

    def has_tag(self, t: str) -> bool:
        return t in self.attrs

    def has_tag_w(self) -> bool:
        return self.has_tag("w")

    def has_tag_test(self) -> bool:
        return self.has_tag("test")


# -- selectors / variables ---------------------------------------------------


@dataclass
class SelPin:
    meta: Meta
    name: str

    def format(self) -> str:
        return f".{self.name}"


@dataclass
class SelIndex:
    meta: Meta
    pos: "Expression"

    def format(self) -> str:
        return f"[{self.pos.format()}]"


Selector = Union[SelPin, SelIndex]


@dataclass
class VariableP:
    meta: Meta
    name: str
    sels: list[Selector] = field(default_factory=list)

    def format(self) -> str:
        return self.name + "".join(s.format() for s in self.sels)

    def __repr__(self) -> str:
        return self.format()


# -- expressions -------------------------------------------------------------


@dataclass
class EFunctionCall:
    meta: Meta
    name: str
    args: list["Expression"]

    def format(self) -> str:
        return f"{self.name}({','.join(a.format() for a in self.args)})"


@dataclass
class EVariable:
    meta: Meta
    name: VariableP

    def format(self) -> str:
        return self.name.format()


@dataclass
class ENumber:
    meta: Meta
    value: int

    def format(self) -> str:
        return str(self.value)


@dataclass
class EPrefixOp:
    meta: Meta
    op: str
    rhe: "Expression"

    def format(self) -> str:
        return f"({opsym(self.op)} {self.rhe.format()})"


@dataclass
class EInfixOp:
    meta: Meta
    lhe: "Expression"
    op: str
    rhe: "Expression"

    def format(self) -> str:
        return f"({self.lhe.format()} {opsym(self.op)} {self.rhe.format()})"


@dataclass
class EArray:
    meta: Meta
    values: list["Expression"]

    def format(self) -> str:
        return f"[{','.join(v.format() for v in self.values)}]"


Expression = Union[EFunctionCall, EVariable, ENumber, EPrefixOp, EInfixOp, EArray]


# -- statements --------------------------------------------------------------


def _fmt_vartype(xtype: str, stype: Optional[SignalType]) -> str:
    if xtype == VariableType.VAR:
        return "var"
    if xtype == VariableType.COMPONENT:
        return "component"
    return {
        SignalType.Internal: "signal",
        SignalType.PublicInput: "signal input",
        SignalType.PrivateInput: "signal private input",
        SignalType.Output: "signal output",
    }[stype]


def _fmt_for_item(s: "Statement") -> str:
    # for-loop init/step items render without trailing ';' (display.rs:43-60)
    if isinstance(s, SDeclaration):
        head = f"{_fmt_vartype(s.xtype, s.stype)} {s.name.format()}"
        if s.init is not None:
            op, value = s.init
            return f"{head} {opsym(op)} {value.format()}"
        return head
    if isinstance(s, SSubstitution):
        return f"{s.name.format()} {opsym(s.op)} {s.value.format()}"
    raise ValueError(f"bad for item {s}")


@dataclass
class SIfThenElse:
    meta: Meta
    xif: Expression
    xthen: "Statement"
    xelse: Optional["Statement"]

    def format(self) -> str:
        if self.xelse is not None:
            return (
                f"if ({self.xif.format()}) {self.xthen.format()}"
                f" else {self.xelse.format()}"
            )
        return f"if ({self.xif.format()}) {self.xthen.format()}"


@dataclass
class SFor:
    meta: Meta
    init: "Statement"
    cond: Expression
    step: "Statement"
    stmt: "Statement"

    def format(self) -> str:
        return (
            f"for ({_fmt_for_item(self.init)};{self.cond.format()};"
            f"{_fmt_for_item(self.step)}) {self.stmt.format()}"
        )


@dataclass
class SWhile:
    meta: Meta
    cond: Expression
    stmt: "Statement"

    def format(self) -> str:
        return f"while ({self.cond.format()}) {self.stmt.format()}"


@dataclass
class SReturn:
    meta: Meta
    value: Expression

    def format(self) -> str:
        return f"return {self.value.format()};"


@dataclass
class SDeclaration:
    meta: Meta
    xtype: str  # VariableType.*
    stype: Optional[SignalType]
    name: VariableP
    init: Optional[tuple[str, Expression]]  # (Opcode, expr)

    def format(self) -> str:
        head = f"{_fmt_vartype(self.xtype, self.stype)} {self.name.format()}"
        if self.init is not None:
            op, value = self.init
            return f"{head} {opsym(op)} {value.format()};"
        return f"{head};"


@dataclass
class SSubstitution:
    meta: Meta
    name: VariableP
    op: str
    value: Expression

    def format(self) -> str:
        return f"{self.name.format()} {opsym(self.op)} {self.value.format()};"


@dataclass
class SBlock:
    meta: Meta
    stmts: list["Statement"]

    def format(self) -> str:
        return "{" + " ".join(s.format() for s in self.stmts) + "}"


@dataclass
class SSignalLeft:
    meta: Meta
    name: VariableP
    op: str  # SIGNAL_WIRE_LEFT | SIGNAL_CONSTRAIN_LEFT
    value: Expression

    def format(self) -> str:
        return f"{self.name.format()} {opsym(self.op)} {self.value.format()};"


@dataclass
class SSignalRight:
    meta: Meta
    value: Expression
    op: str  # SIGNAL_WIRE_RIGHT | SIGNAL_CONSTRAIN_RIGHT
    name: VariableP

    def format(self) -> str:
        return f"{self.value.format()} {opsym(self.op)} {self.name.format()};"


@dataclass
class SSignalEq:
    meta: Meta
    lhe: Expression
    op: str  # SIGNAL_CONSTRAIN_EQ
    rhe: Expression

    def format(self) -> str:
        return f"{self.lhe.format()} {opsym(self.op)} {self.rhe.format()};"


@dataclass
class SInternalCall:
    meta: Meta
    name: str
    args: list[Expression]

    def format(self) -> str:
        return f"{self.name}!({','.join(a.format() for a in self.args)});"


Statement = Union[
    SIfThenElse, SFor, SWhile, SReturn, SDeclaration, SSubstitution,
    SBlock, SSignalLeft, SSignalRight, SSignalEq, SInternalCall,
]


# -- body elements -----------------------------------------------------------


@dataclass
class BInclude:
    meta: Meta
    path: str

    def format(self) -> str:
        return f'include "{self.path}";'


@dataclass
class BFunctionDef:
    meta: Meta
    name: str
    args: list[str]
    stmt: Statement

    def format(self) -> str:
        return f"function {self.name}({','.join(self.args)}) {self.stmt.format()}"


@dataclass
class BTemplateDef:
    meta: Meta
    name: str
    args: list[str]
    stmt: Statement

    def format(self) -> str:
        return f"template {self.name}({','.join(self.args)}) {self.stmt.format()}"


@dataclass
class BDeclaration:
    meta: Meta
    decl: Statement

    def format(self) -> str:
        return self.decl.format()


BodyElement = Union[BInclude, BFunctionDef, BTemplateDef, BDeclaration]
