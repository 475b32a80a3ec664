"""bincode-compatible serialization of ASTs and constraints.

The reference proving key embeds serde+bincode encodings of the parsed
ASTs and each optimized QEQ (prover/src/groth16/format.rs:223-293).
This module reproduces the bincode v1 wire format for those types so pk
files are structurally interchangeable:

  * enum        -> u32 LE variant index
  * u64/usize   -> u64 LE
  * String/Vec  -> u64 LE length + contents
  * Option<T>   -> u8 0|1 + payload
  * BigInt      -> (Sign enum, BigUint = Vec<u32> LE little-endian limbs)
  * struct/tuple-> fields in declaration order

Variant indices follow the reference enum declaration order
(parser/src/ast.rs:61-236).
"""

from __future__ import annotations

import struct
from typing import Optional

from ..algebra import FS, LC, QEQ
from ..lang import ast as A

# enum variant orders from parser/src/ast.rs
_OPCODE_VARIANTS = [
    A.Opcode.MUL, A.Opcode.DIV, A.Opcode.ADD, A.Opcode.SUB, A.Opcode.POW,
    A.Opcode.INTDIV, A.Opcode.MOD, A.Opcode.SHL, A.Opcode.SHR,
    A.Opcode.LESSEREQ, A.Opcode.GREATEREQ, A.Opcode.LESSER, A.Opcode.GREATER,
    A.Opcode.EQ, A.Opcode.NOTEQ, A.Opcode.BOOLOR, A.Opcode.BOOLAND,
    A.Opcode.BITOR, A.Opcode.BITAND, A.Opcode.BITXOR, A.Opcode.BOOLNOT,
    A.Opcode.ASSIG, A.Opcode.ASSIG_ADD, A.Opcode.ASSIG_SUB, A.Opcode.ASSIG_MUL,
    A.Opcode.ASSIG_DIV, A.Opcode.ASSIG_MOD, A.Opcode.ASSIG_SHL,
    A.Opcode.ASSIG_SHR, A.Opcode.ASSIG_BITAND, A.Opcode.ASSIG_BITOR,
    A.Opcode.ASSIG_BITXOR, A.Opcode.SIGNAL_WIRE_LEFT, A.Opcode.SIGNAL_WIRE_RIGHT,
    A.Opcode.SIGNAL_CONSTRAIN_LEFT, A.Opcode.SIGNAL_CONSTRAIN_RIGHT,
    A.Opcode.SIGNAL_CONSTRAIN_EQ,
]
_OPCODE_INDEX = {op: i for i, op in enumerate(_OPCODE_VARIANTS)}

_SIGNALTYPE_VARIANTS = [
    A.SignalType.Output, A.SignalType.PublicInput,
    A.SignalType.PrivateInput, A.SignalType.Internal,
]
_SIGNALTYPE_INDEX = {s: i for i, s in enumerate(_SIGNALTYPE_VARIANTS)}


class Writer:
    def __init__(self):
        self.buf = bytearray()

    def u8(self, v: int):
        self.buf.append(v & 0xFF)

    def u32(self, v: int):
        self.buf += struct.pack("<I", v)

    def u64(self, v: int):
        self.buf += struct.pack("<Q", v)

    def string(self, s: str):
        b = s.encode()
        self.u64(len(b))
        self.buf += b

    def bytes(self) -> bytes:
        return bytes(self.buf)


class Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def u8(self) -> int:
        v = self.data[self.pos]
        self.pos += 1
        return v

    def u32(self) -> int:
        v = struct.unpack_from("<I", self.data, self.pos)[0]
        self.pos += 4
        return v

    def u64(self) -> int:
        v = struct.unpack_from("<Q", self.data, self.pos)[0]
        self.pos += 8
        return v

    def string(self) -> str:
        n = self.u64()
        s = self.data[self.pos : self.pos + n].decode()
        self.pos += n
        return s


# -- primitives ---------------------------------------------------------------


def _w_bigint(w: Writer, v: int):
    # num-bigint BigInt: (Sign, BigUint); Sign enum {Minus=0, NoSign=1, Plus=2}
    if v < 0:
        w.u32(0)
        v = -v
    elif v == 0:
        w.u32(1)
    else:
        w.u32(2)
    _w_biguint(w, v)


def _r_bigint(r: Reader) -> int:
    sign = r.u32()
    v = _r_biguint(r)
    return -v if sign == 0 else v


def _w_biguint(w: Writer, v: int):
    limbs = []
    while v:
        limbs.append(v & 0xFFFFFFFF)
        v >>= 32
    w.u64(len(limbs))
    for limb in limbs:
        w.u32(limb)


def _r_biguint(r: Reader) -> int:
    n = r.u64()
    v = 0
    for i in range(n):
        v |= r.u32() << (32 * i)
    return v


def _w_meta(w: Writer, m: A.Meta):
    w.u64(m.start)
    w.u64(m.end)
    w.u64(len(m.attrs))  # Attributes(Vec<String>)
    for a in m.attrs:
        w.string(a)


def _r_meta(r: Reader) -> A.Meta:
    start = r.u64()
    end = r.u64()
    n = r.u64()
    attrs = tuple(r.string() for _ in range(n))
    return A.Meta(start, end, attrs)


# -- selectors / variables ----------------------------------------------------


def _w_selector(w: Writer, s):
    if isinstance(s, A.SelPin):
        w.u32(0)
        _w_meta(w, s.meta)
        w.string(s.name)
    elif isinstance(s, A.SelIndex):
        w.u32(1)
        _w_meta(w, s.meta)
        _w_expr(w, s.pos)
    else:
        raise TypeError(s)


def _r_selector(r: Reader):
    v = r.u32()
    meta = _r_meta(r)
    if v == 0:
        return A.SelPin(meta, r.string())
    if v == 1:
        return A.SelIndex(meta, _r_expr(r))
    raise ValueError(f"bad selector variant {v}")


def _w_variable(w: Writer, v: A.VariableP):
    _w_meta(w, v.meta)
    w.string(v.name)
    w.u64(len(v.sels))
    for s in v.sels:
        _w_selector(w, s)


def _r_variable(r: Reader) -> A.VariableP:
    meta = _r_meta(r)
    name = r.string()
    n = r.u64()
    sels = [_r_selector(r) for _ in range(n)]
    return A.VariableP(meta, name, sels)


# -- expressions (ExpressionP variant order: FunctionCall, Variable, Number,
#    PrefixOp, InfixOp, Array -- ast.rs:61-90) --------------------------------


def _w_expr(w: Writer, e):
    if isinstance(e, A.EFunctionCall):
        w.u32(0)
        _w_meta(w, e.meta)
        w.string(e.name)
        w.u64(len(e.args))
        for a in e.args:
            _w_expr(w, a)
    elif isinstance(e, A.EVariable):
        w.u32(1)
        _w_meta(w, e.meta)
        _w_variable(w, e.name)
    elif isinstance(e, A.ENumber):
        w.u32(2)
        _w_meta(w, e.meta)
        _w_bigint(w, e.value)
    elif isinstance(e, A.EPrefixOp):
        w.u32(3)
        _w_meta(w, e.meta)
        w.u32(_OPCODE_INDEX[e.op])
        _w_expr(w, e.rhe)
    elif isinstance(e, A.EInfixOp):
        w.u32(4)
        _w_meta(w, e.meta)
        _w_expr(w, e.lhe)
        w.u32(_OPCODE_INDEX[e.op])
        _w_expr(w, e.rhe)
    elif isinstance(e, A.EArray):
        w.u32(5)
        _w_meta(w, e.meta)
        w.u64(len(e.values))
        for v in e.values:
            _w_expr(w, v)
    else:
        raise TypeError(e)


def _r_expr(r: Reader):
    v = r.u32()
    meta = _r_meta(r)
    if v == 0:
        name = r.string()
        n = r.u64()
        return A.EFunctionCall(meta, name, [_r_expr(r) for _ in range(n)])
    if v == 1:
        return A.EVariable(meta, _r_variable(r))
    if v == 2:
        return A.ENumber(meta, _r_bigint(r))
    if v == 3:
        op = _OPCODE_VARIANTS[r.u32()]
        return A.EPrefixOp(meta, op, _r_expr(r))
    if v == 4:
        lhe = _r_expr(r)
        op = _OPCODE_VARIANTS[r.u32()]
        return A.EInfixOp(meta, lhe, op, _r_expr(r))
    if v == 5:
        n = r.u64()
        return A.EArray(meta, [_r_expr(r) for _ in range(n)])
    raise ValueError(f"bad expression variant {v}")


# -- statements (StatementP variant order: IfThenElse, For, While, Return,
#    Declaration, Substitution, Block, SignalLeft, SignalRight, SignalEq,
#    InternalCall -- ast.rs:93-155) -------------------------------------------


def _w_vartype(w: Writer, xtype: str, stype: Optional[A.SignalType]):
    # VariableType {Empty, Var, Signal(SignalType), Component} (ast.rs:190-195)
    if xtype == A.VariableType.VAR:
        w.u32(1)
    elif xtype == A.VariableType.SIGNAL:
        w.u32(2)
        w.u32(_SIGNALTYPE_INDEX[stype])
    elif xtype == A.VariableType.COMPONENT:
        w.u32(3)
    else:
        raise TypeError(xtype)


def _r_vartype(r: Reader):
    v = r.u32()
    if v == 1:
        return A.VariableType.VAR, None
    if v == 2:
        return A.VariableType.SIGNAL, _SIGNALTYPE_VARIANTS[r.u32()]
    if v == 3:
        return A.VariableType.COMPONENT, None
    raise ValueError(f"bad variable type {v}")


def _w_opt_init(w: Writer, init):
    if init is None:
        w.u8(0)
    else:
        w.u8(1)
        op, expr = init
        w.u32(_OPCODE_INDEX[op])
        _w_expr(w, expr)


def _r_opt_init(r: Reader):
    if r.u8() == 0:
        return None
    op = _OPCODE_VARIANTS[r.u32()]
    return (op, _r_expr(r))


def _w_stmt(w: Writer, s):
    if isinstance(s, A.SIfThenElse):
        w.u32(0)
        _w_meta(w, s.meta)
        _w_expr(w, s.xif)
        _w_stmt(w, s.xthen)
        if s.xelse is None:
            w.u8(0)
        else:
            w.u8(1)
            _w_stmt(w, s.xelse)
    elif isinstance(s, A.SFor):
        w.u32(1)
        _w_meta(w, s.meta)
        _w_stmt(w, s.init)
        _w_expr(w, s.cond)
        _w_stmt(w, s.step)
        _w_stmt(w, s.stmt)
    elif isinstance(s, A.SWhile):
        w.u32(2)
        _w_meta(w, s.meta)
        _w_expr(w, s.cond)
        _w_stmt(w, s.stmt)
    elif isinstance(s, A.SReturn):
        w.u32(3)
        _w_meta(w, s.meta)
        _w_expr(w, s.value)
    elif isinstance(s, A.SDeclaration):
        w.u32(4)
        _w_meta(w, s.meta)
        _w_vartype(w, s.xtype, s.stype)
        _w_variable(w, s.name)
        _w_opt_init(w, s.init)
    elif isinstance(s, A.SSubstitution):
        w.u32(5)
        _w_meta(w, s.meta)
        _w_variable(w, s.name)
        w.u32(_OPCODE_INDEX[s.op])
        _w_expr(w, s.value)
    elif isinstance(s, A.SBlock):
        w.u32(6)
        _w_meta(w, s.meta)
        w.u64(len(s.stmts))
        for st in s.stmts:
            _w_stmt(w, st)
    elif isinstance(s, A.SSignalLeft):
        w.u32(7)
        _w_meta(w, s.meta)
        _w_variable(w, s.name)
        w.u32(_OPCODE_INDEX[s.op])
        _w_expr(w, s.value)
    elif isinstance(s, A.SSignalRight):
        w.u32(8)
        _w_meta(w, s.meta)
        _w_expr(w, s.value)
        w.u32(_OPCODE_INDEX[s.op])
        _w_variable(w, s.name)
    elif isinstance(s, A.SSignalEq):
        w.u32(9)
        _w_meta(w, s.meta)
        _w_expr(w, s.lhe)
        w.u32(_OPCODE_INDEX[s.op])
        _w_expr(w, s.rhe)
    elif isinstance(s, A.SInternalCall):
        w.u32(10)
        _w_meta(w, s.meta)
        w.string(s.name)
        w.u64(len(s.args))
        for a in s.args:
            _w_expr(w, a)
    else:
        raise TypeError(s)


def _r_stmt(r: Reader):
    v = r.u32()
    meta = _r_meta(r)
    if v == 0:
        xif = _r_expr(r)
        xthen = _r_stmt(r)
        xelse = _r_stmt(r) if r.u8() else None
        return A.SIfThenElse(meta, xif, xthen, xelse)
    if v == 1:
        return A.SFor(meta, _r_stmt(r), _r_expr(r), _r_stmt(r), _r_stmt(r))
    if v == 2:
        return A.SWhile(meta, _r_expr(r), _r_stmt(r))
    if v == 3:
        return A.SReturn(meta, _r_expr(r))
    if v == 4:
        xtype, stype = _r_vartype(r)
        name = _r_variable(r)
        init = _r_opt_init(r)
        return A.SDeclaration(meta, xtype, stype, name, init)
    if v == 5:
        name = _r_variable(r)
        op = _OPCODE_VARIANTS[r.u32()]
        return A.SSubstitution(meta, name, op, _r_expr(r))
    if v == 6:
        n = r.u64()
        return A.SBlock(meta, [_r_stmt(r) for _ in range(n)])
    if v == 7:
        name = _r_variable(r)
        op = _OPCODE_VARIANTS[r.u32()]
        return A.SSignalLeft(meta, name, op, _r_expr(r))
    if v == 8:
        value = _r_expr(r)
        op = _OPCODE_VARIANTS[r.u32()]
        return A.SSignalRight(meta, value, op, _r_variable(r))
    if v == 9:
        lhe = _r_expr(r)
        op = _OPCODE_VARIANTS[r.u32()]
        return A.SSignalEq(meta, lhe, op, _r_expr(r))
    if v == 10:
        name = r.string()
        n = r.u64()
        return A.SInternalCall(meta, name, [_r_expr(r) for _ in range(n)])
    raise ValueError(f"bad statement variant {v}")


# -- body elements (BodyElementP: Include, FunctionDef, TemplateDef,
#    Declaration -- ast.rs:158-179) -------------------------------------------


def _w_body_element(w: Writer, be):
    if isinstance(be, A.BInclude):
        w.u32(0)
        _w_meta(w, be.meta)
        w.string(be.path)
    elif isinstance(be, A.BFunctionDef):
        w.u32(1)
        _w_meta(w, be.meta)
        w.string(be.name)
        w.u64(len(be.args))
        for a in be.args:
            w.string(a)
        _w_stmt(w, be.stmt)
    elif isinstance(be, A.BTemplateDef):
        w.u32(2)
        _w_meta(w, be.meta)
        w.string(be.name)
        w.u64(len(be.args))
        for a in be.args:
            w.string(a)
        _w_stmt(w, be.stmt)
    elif isinstance(be, A.BDeclaration):
        w.u32(3)
        _w_meta(w, be.meta)
        _w_stmt(w, be.decl)
    else:
        raise TypeError(be)


def _r_body_element(r: Reader):
    v = r.u32()
    meta = _r_meta(r)
    if v == 0:
        return A.BInclude(meta, r.string())
    if v in (1, 2):
        name = r.string()
        n = r.u64()
        args = [r.string() for _ in range(n)]
        stmt = _r_stmt(r)
        cls = A.BFunctionDef if v == 1 else A.BTemplateDef
        return cls(meta, name, args, stmt)
    if v == 3:
        return A.BDeclaration(meta, _r_stmt(r))
    raise ValueError(f"bad body element variant {v}")


# -- public API ---------------------------------------------------------------


def serialize_asts(asts: list) -> bytes:
    w = Writer()
    w.u64(len(asts))
    for be in asts:
        _w_body_element(w, be)
    return w.bytes()


def deserialize_asts(data: bytes) -> list:
    r = Reader(data)
    n = r.u64()
    return [_r_body_element(r) for _ in range(n)]


def serialize_qeq(qeq: QEQ) -> bytes:
    w = Writer()
    for lc in (qeq.a, qeq.b, qeq.c):
        w.u64(len(lc.t))
        for s, c in lc.t:
            w.u64(s)          # SignalId = usize
            _w_biguint(w, c.v)  # FS(BigUint)
    return w.bytes()


def deserialize_qeq(data: bytes) -> QEQ:
    r = Reader(data)
    lcs = []
    for _ in range(3):
        n = r.u64()
        terms = []
        for _ in range(n):
            s = r.u64()
            c = _r_biguint(r)
            terms.append((s, FS(c)))
        lcs.append(LC(terms))
    return QEQ(lcs[0], lcs[1], lcs[2])
