"""Symbolic field algebra for the circuit evaluator.

The value lattice const / degree-1 / degree-2 used while interpreting
circuits:

  * ``FS``  -- field scalar mod the BN254 scalar field r
               (reference: compiler/src/algebra/fs.rs)
  * ``LC``  -- sparse linear combination ``sum_i coeff_i * signal_i``
               (reference: compiler/src/algebra/lc.rs)
  * ``QEQ`` -- quadratic row ``a*b + c`` with a/b/c linear combinations;
               the constraint semantics is ``a*b + c = 0``
               (reference: compiler/src/algebra/qeq.rs)
  * ``Value`` union + ``eval_infix`` / ``eval_prefix`` operator dispatch
               (reference: compiler/src/algebra/value.rs)

Host-side implementation on Python ints (arbitrary precision, exact);
the device engine (za_tpu_torch.engine) carries the same semantics in limb
form.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

# BN254 (a.k.a. BN128) scalar field modulus r
# (reference constant: compiler/src/algebra/fs.rs:15-16)
FIELD_R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
_FIELD_HALF = (FIELD_R - 1) // 2

SignalId = int
SIGNAL_ONE: SignalId = 0


class AlgebraError(Exception):
    """Invalid operation / format in the symbolic algebra layer."""


def _modinv(a: int, n: int) -> int:
    """Inverse of a mod n; raises AlgebraError when gcd(a, n) != 1."""
    try:
        return pow(a, -1, n)
    except ValueError as exc:
        raise AlgebraError(f"Cannot find inv of {a}") from exc


class FS:
    """Field scalar modulo r. Immutable.

    Mirrors the semantics of the reference FS type exactly, including the
    quirky operations defined on raw representatives rather than field
    elements (%, \\, <<, >>, &, |, ^ operate on the canonical integer
    representative in [0, r)).
    """

    __slots__ = ("v",)

    def __init__(self, v: int = 0):
        self.v = v % FIELD_R

    # -- constructors -------------------------------------------------------

    @staticmethod
    def parse(expr: str) -> "FS":
        """Parse decimal or 0x-hex string (reference fs.rs:43-55)."""
        try:
            if expr.startswith("0x"):
                return FS(int(expr[2:], 16))
            return FS(int(expr, 10))
        except ValueError as exc:
            raise AlgebraError(f"{expr} is not a valid number") from exc

    @staticmethod
    def zero() -> "FS":
        return FS(0)

    @staticmethod
    def one() -> "FS":
        return FS(1)

    # -- predicates ---------------------------------------------------------

    def is_zero(self) -> bool:
        return self.v == 0

    def is_one(self) -> bool:
        return self.v == 1

    def is_neg(self) -> bool:
        """True when the representative is > (r-1)/2 (fs.rs:72-74)."""
        return self.v > _FIELD_HALF

    def try_to_int(self) -> Optional[int]:
        """The u64-convertibility check of the reference (fs.rs:75-77)."""
        if self.v < (1 << 64):
            return self.v
        return None

    def _const_like(self, other: "FS") -> "FS":
        """Trace-promotion hook: the witness-trace recorder's TFS
        subclass (compiler/wtrace.py) overrides this so plain-left /
        traced-right named-method ops (div, mod, shl, ...) keep the
        trace. Identity for plain scalars."""
        return other

    # -- arithmetic ---------------------------------------------------------

    def __add__(self, o: "FS") -> "FS":
        return FS(self.v + o.v)

    def __mul__(self, o: "FS") -> "FS":
        return FS(self.v * o.v)

    def __neg__(self) -> "FS":
        return FS(FIELD_R - self.v)

    def __sub__(self, o: "FS") -> "FS":
        return FS(self.v - o.v)

    def inv(self) -> "FS":
        return FS(_modinv(self.v, FIELD_R))

    def div(self, o: "FS") -> "FS":
        """Field division (fs.rs:229-249)."""
        return FS(self.v * _modinv(o.v, FIELD_R))

    def intdiv(self, o: "FS") -> "FS":
        """Integer division on representatives (fs.rs:113-115)."""
        if o.v == 0:
            raise AlgebraError("Division by zero")
        return FS(self.v // o.v)

    def modulo(self, o: "FS") -> "FS":
        """Representative remainder (fs.rs:260-269)."""
        if o.v == 0:
            raise AlgebraError("Divison by zero")
        return FS(self.v % o.v)

    def pow(self, o: "FS") -> "FS":
        """Modular exponentiation (fs.rs:109-111)."""
        return FS(pow(self.v, o.v, FIELD_R))

    def shl(self, o: "FS") -> "FS":
        """Shift-left of the representative; rhs must fit usize
        (fs.rs:272-283; large shifts are memory-bounded here)."""
        if o.v >= (1 << 64):
            raise AlgebraError("Only can shl on 64 bit values")
        return FS(self.v << o.v)

    def shr(self, o: "FS") -> "FS":
        if o.v >= (1 << 64):
            raise AlgebraError("Only can shr on 64 bit values")
        return FS(self.v >> o.v)

    def __and__(self, o: "FS") -> "FS":
        return FS(self.v & o.v)

    def __or__(self, o: "FS") -> "FS":
        return FS(self.v | o.v)

    def __xor__(self, o: "FS") -> "FS":
        return FS(self.v ^ o.v)

    # -- comparison (on representatives, like the reference) ----------------

    def __eq__(self, o: object) -> bool:
        return isinstance(o, FS) and self.v == o.v

    def __lt__(self, o: "FS") -> bool:
        return self.v < o.v

    def __le__(self, o: "FS") -> bool:
        return self.v <= o.v

    def __gt__(self, o: "FS") -> bool:
        return self.v > o.v

    def __ge__(self, o: "FS") -> bool:
        return self.v >= o.v

    def __hash__(self) -> int:
        return hash(self.v)

    # -- formatting / serialization -----------------------------------------

    def format(self, plus_sign_at_start: bool) -> str:
        """Signed rendering used inside LC/QEQ formatting (fs.rs:78-86)."""
        if self.is_neg():
            return f"-{FIELD_R - self.v}"
        if plus_sign_at_start:
            return f"+{self.v}"
        return str(self.v)

    def __str__(self) -> str:
        return str(self.v)

    def __repr__(self) -> str:
        return self.format(False)

    def write_256_w32(self) -> bytes:
        """Witness serialization: 32 bytes = 8 big-endian 32-bit words in
        little-endian word order (fs.rs:116-126)."""
        be = self.v.to_bytes(32, "big")
        return b"".join(be[n * 4 : (n + 1) * 4] for n in range(7, -1, -1))


def fs_from(v) -> FS:
    if isinstance(v, FS):
        return v
    if isinstance(v, int):
        return FS(v)
    if isinstance(v, str):
        return FS.parse(v)
    raise AlgebraError(f"cannot build FS from {v!r}")


class LC:
    """Sparse linear combination: ordered list of (signal, coeff).

    Signal 0 (SIGNAL_ONE) is the constant-one signal. Term order follows
    insertion order like the reference (formatting parity depends on it).
    """

    __slots__ = ("t",)

    def __init__(self, terms: Optional[Iterable[tuple[SignalId, FS]]] = None):
        self.t: list[tuple[SignalId, FS]] = list(terms) if terms is not None else []

    @staticmethod
    def from_signal(signal: SignalId, fs: FS) -> "LC":
        return LC([(signal, fs)])

    @staticmethod
    def from_fs(fs: FS) -> "LC":
        return LC([(SIGNAL_ONE, fs)])

    @staticmethod
    def zero() -> "LC":
        return LC()

    def is_zero(self) -> bool:
        return all(c.is_zero() for _, c in self.t)

    def get(self, signal: SignalId) -> Optional[FS]:
        for s, c in self.t:
            if s == signal:
                return c
        return None

    def set(self, signal: SignalId, func: Callable[[Optional[FS]], FS]) -> None:
        for i, (s, c) in enumerate(self.t):
            if s == signal:
                self.t[i] = (s, func(c))
                return
        self.t.append((signal, func(None)))

    def rm(self, signal: SignalId) -> None:
        self.t = [(s, c) for s, c in self.t if s != signal]

    def __neg__(self) -> "LC":
        return LC([(s, -c) for s, c in self.t])

    def add_fs(self, rhs: FS) -> "LC":
        """LC + scalar folds into the ONE term (lc.rs:100-114)."""
        v = list(self.t)
        for i, (s, c) in enumerate(v):
            if s == SIGNAL_ONE:
                v[i] = (s, c + rhs)
                break
        else:
            v.append((SIGNAL_ONE, rhs))
        return LC([(s, c) for s, c in v if not c.is_zero()])

    def mul_fs(self, rhs: FS) -> "LC":
        if rhs.is_zero():
            return LC.zero()
        return LC([(s, c * rhs) for s, c in self.t])

    def add_lc(self, rhs: "LC") -> "LC":
        v = list(self.t)
        index = {s: i for i, (s, _) in enumerate(v)}
        for s, c in rhs.t:
            if s in index:
                i = index[s]
                v[i] = (s, v[i][1] + c)
            else:
                index[s] = len(v)
                v.append((s, c))
        return LC([(s, c) for s, c in v if not c.is_zero()])

    def mul_lc(self, rhs: "LC") -> "QEQ":
        return QEQ(LC(self.t), LC(rhs.t), LC.zero())

    def format(self, func: Callable[[SignalId], str]) -> str:
        """``2s1+3s2`` rendering (lc.rs:41-54)."""
        if not self.t:
            return "0"
        head_s, head_c = self.t[0]
        parts = [f"{head_c.format(False)}{func(head_s)}"]
        for s, c in self.t[1:]:
            parts.append(f"{c.format(True)}{func(s)}")
        return "".join(parts)

    def __str__(self) -> str:
        return self.format(lambda s: f"s{s}")

    def __repr__(self) -> str:
        return str(self)


class QEQ:
    """Quadratic constraint row ``a*b + c`` (semantics: a*b + c = 0)."""

    __slots__ = ("a", "b", "c")

    def __init__(self, a: LC, b: LC, c: LC):
        self.a, self.b, self.c = a, b, c

    @staticmethod
    def zero() -> "QEQ":
        return QEQ(LC.zero(), LC.zero(), LC.zero())

    @staticmethod
    def from_fs(fs: FS) -> "QEQ":
        return QEQ(LC.zero(), LC.zero(), LC.from_fs(fs))

    @staticmethod
    def from_lc(lc: LC) -> "QEQ":
        return QEQ(LC.zero(), LC.zero(), LC(lc.t))

    def is_zero(self) -> bool:
        return (self.a.is_zero() or self.b.is_zero()) and self.c.is_zero()

    def add_fs(self, rhs: FS) -> "QEQ":
        return QEQ(LC(self.a.t), LC(self.b.t), self.c.add_fs(rhs))

    def mul_fs(self, rhs: FS) -> "QEQ":
        """Scales a and c only (qeq.rs:74-84)."""
        return QEQ(self.a.mul_fs(rhs), LC(self.b.t), self.c.mul_fs(rhs))

    def add_lc(self, rhs: LC) -> "QEQ":
        return QEQ(LC(self.a.t), LC(self.b.t), self.c.add_lc(rhs))

    def __neg__(self) -> "QEQ":
        """Negates a and c only (qeq.rs:100-110)."""
        return QEQ(-self.a, LC(self.b.t), -self.c)

    def format(self, func: Callable[[SignalId], str]) -> str:
        def f(lc: LC) -> str:
            return lc.format(func) if lc.t else " "

        return f"[{f(self.a)}]*[{f(self.b)}]+[{f(self.c)}]"

    def __str__(self) -> str:
        return self.format(lambda s: f"s{s}")

    def __repr__(self) -> str:
        return str(self)


class Value:
    """Union FS | LC | QEQ — the symbolic degree lattice."""

    __slots__ = ("v",)

    def __init__(self, v):
        assert isinstance(v, (FS, LC, QEQ))
        self.v = v

    @staticmethod
    def from_signal(signal: SignalId) -> "Value":
        return Value(LC.from_signal(signal, FS.one()))

    @staticmethod
    def from_int(n: int) -> "Value":
        return Value(FS(n))

    def is_fs(self) -> bool:
        return isinstance(self.v, FS)

    def is_lc(self) -> bool:
        return isinstance(self.v, LC)

    def is_qeq(self) -> bool:
        return isinstance(self.v, QEQ)

    def into_qeq(self) -> QEQ:
        if isinstance(self.v, FS):
            return QEQ.from_fs(self.v)
        if isinstance(self.v, LC):
            return QEQ.from_lc(self.v)
        return self.v

    def try_to_signal(self) -> Optional[SignalId]:
        """Recognize 1-term coeff-1 LCs as bare signals (value.rs:31-38)."""
        if isinstance(self.v, LC) and len(self.v.t) == 1 and self.v.t[0][1].is_one():
            return self.v.t[0][0]
        return None

    def try_into_fs(self) -> Optional[FS]:
        return self.v if isinstance(self.v, FS) else None

    def __str__(self) -> str:
        return str(self.v)

    def __repr__(self) -> str:
        return str(self.v)


# -- operator dispatch -------------------------------------------------------

# opcode names shared with the parser AST (lang.ast.Opcode)


def eval_infix(lhv: Value, op: str, rhv: Value) -> Value:
    """Cross-degree operator table (value.rs:113-185).

    ``op`` is an Opcode name string: add/sub/mul/div/intdiv/mod/shl/shr/
    band/bor/bxor/pow.
    """
    l, r = lhv.v, rhv.v

    if op == "add":
        if isinstance(l, FS) and isinstance(r, FS):
            return Value(l + r)
        if isinstance(l, LC) and isinstance(r, LC):
            return Value(l.add_lc(r))
        if isinstance(l, FS) and isinstance(r, LC):
            return Value(r.add_fs(l))
        if isinstance(l, LC) and isinstance(r, FS):
            return Value(l.add_fs(r))
        if isinstance(l, FS) and isinstance(r, QEQ):
            return Value(r.add_fs(l))
        if isinstance(l, QEQ) and isinstance(r, FS):
            return Value(l.add_fs(r))
        if isinstance(l, LC) and isinstance(r, QEQ):
            return Value(r.add_lc(l))
        if isinstance(l, QEQ) and isinstance(r, LC):
            return Value(l.add_lc(r))

    elif op == "sub":
        if isinstance(l, FS) and isinstance(r, FS):
            return Value(l + (-r))
        if isinstance(l, LC) and isinstance(r, LC):
            return Value(l.add_lc(-r))
        if isinstance(l, FS) and isinstance(r, LC):
            return Value((-r).add_fs(l))
        if isinstance(l, LC) and isinstance(r, FS):
            return Value(l.add_fs(-r))
        if isinstance(l, FS) and isinstance(r, QEQ):
            return Value((-r).add_fs(l))
        if isinstance(l, QEQ) and isinstance(r, FS):
            return Value(l.add_fs(-r))
        if isinstance(l, LC) and isinstance(r, QEQ):
            return Value((-r).add_lc(l))
        if isinstance(l, QEQ) and isinstance(r, LC):
            return Value(l.add_lc(-r))

    elif op == "mul":
        if isinstance(l, FS) and isinstance(r, FS):
            return Value(l * r)
        if isinstance(l, LC) and isinstance(r, LC):
            return Value(l.mul_lc(r))
        if isinstance(l, LC) and isinstance(r, FS):
            return Value(l.mul_fs(r))
        if isinstance(l, FS) and isinstance(r, LC):
            return Value(r.mul_fs(l))
        if isinstance(l, QEQ) and isinstance(r, FS):
            return Value(l.mul_fs(r))
        if isinstance(l, FS) and isinstance(r, QEQ):
            return Value(r.mul_fs(l))

    elif isinstance(l, FS) and isinstance(r, FS):
        l = r._const_like(l)  # keep witness traces through named methods
        if op == "div":
            return Value(l.div(r))
        if op == "intdiv":
            return Value(l.intdiv(r))
        if op == "mod":
            return Value(l.modulo(r))
        if op == "shl":
            return Value(l.shl(r))
        if op == "shr":
            return Value(l.shr(r))
        if op == "band":
            return Value(l & r)
        if op == "bor":
            return Value(l | r)
        if op == "bxor":
            return Value(l ^ r)
        if op == "pow":
            return Value(l.pow(r))

    raise AlgebraError(f"Cannot apply operator {op} on {lhv} over {rhv}")


def eval_prefix(op: str, rhv: Value) -> Value:
    """Unary operators on values (value.rs:187-201)."""
    if op == "sub":
        return Value(-rhv.v) if not isinstance(rhv.v, FS) else Value(-rhv.v)
    raise AlgebraError(f"Cannot apply operator {op} on {rhv}")
