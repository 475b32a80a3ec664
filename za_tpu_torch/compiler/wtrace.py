"""Witness-program trace compiler.

The reference re-interprets the whole circuit AST for every proof
(prover/src/groth16/helper.rs:109 -> eval_asts); at 1M constraints the
tree-walking interpreter dominates end-to-end proving time (SURVEY.md
section 7, hard part 6). za-tpu instead *compiles* witness generation on
the first proof: one interpreted run records every field operation into a
linear tape (a straight-line witness program over the circuit inputs),
and subsequent proofs replay the tape with plain machine-int arithmetic
-- no AST, no scopes, no Python object churn.

Soundness: any place the recording run's *control flow* could depend on
input values (comparisons, zero tests, int conversions used as array
indexes / shift amounts / loop bounds) records a GUARD entry pinning the
decision taken. Replay re-evaluates each guard; a mismatch raises
:class:`TraceMismatch` and the caller falls back to the interpreter, so
a trace is only ever reused for inputs that drive the circuit down the
identical straight-line path. The `===` witness checks of the reference
(eval.rs:1195-1258) become zero-guards on the tape, so constraint
checking during witness generation is preserved on replay.

Mechanism: inputs are wrapped in :class:`TFS` (a traced FS). Every FS
operation involving a TFS routes through the recorder via operator
overrides (including reflected dunders, so `plain + traced` traces) and
the `FS._const_like` promotion hook used by `algebra.eval_infix` for the
named scalar methods (div/intdiv/mod/shl/shr/pow with a plain left
operand). Values that never touch an input stay plain FS and are baked
into the tape as constants.
"""

from __future__ import annotations

import hashlib
import json
from typing import Optional

from ..algebra import FIELD_R, FS, AlgebraError

R = FIELD_R

# tape opcodes (tuple layouts noted per op)
OP_INPUT = 0   # (op, input_index)
OP_CONST = 1   # (op, value)
OP_ADD = 2     # (op, a, b) ... binary ops
OP_SUB = 3
OP_MUL = 4
OP_DIV = 5
OP_INTDIV = 6
OP_MOD = 7
OP_SHL = 8
OP_SHR = 9
OP_BAND = 10
OP_BOR = 11
OP_BXOR = 12
OP_POW = 13
OP_NEG = 14    # (op, a)
OP_INV = 15    # (op, a)
# guards: replay must reproduce the recorded decision
OP_GUARD_CMP = 16   # (op, cmp, a, b, expected_bool)
OP_GUARD_ZERO = 17  # (op, a, expected_bool)
OP_GUARD_INT = 18   # (op, a, expected_int_or_None)

CMP_LT, CMP_LE, CMP_GT, CMP_GE, CMP_EQ = 0, 1, 2, 3, 4

_BINOP_NAMES = {
    "add": OP_ADD, "sub": OP_SUB, "mul": OP_MUL, "div": OP_DIV,
    "intdiv": OP_INTDIV, "mod": OP_MOD, "shl": OP_SHL, "shr": OP_SHR,
    "band": OP_BAND, "bor": OP_BOR, "bxor": OP_BXOR, "pow": OP_POW,
}


class TraceMismatch(Exception):
    """Replay diverged from the recorded control-flow path."""


class TraceRecorder:
    def __init__(self):
        self.tape: list[tuple] = []
        self.input_names: list[str] = []
        self._const_ids: dict[int, int] = {}

    # -- node constructors ---------------------------------------------------

    def _push(self, entry: tuple) -> int:
        self.tape.append(entry)
        return len(self.tape) - 1

    def input(self, name: str, fs: FS) -> "TFS":
        idx = len(self.input_names)
        self.input_names.append(name)
        return TFS(fs.v, self._push((OP_INPUT, idx)), self)

    def const_id(self, v: int) -> int:
        nid = self._const_ids.get(v)
        if nid is None:
            nid = self._push((OP_CONST, v))
            self._const_ids[v] = nid
        return nid

    def _nid(self, x: FS) -> int:
        if isinstance(x, TFS):
            return x.nid
        return self.const_id(x.v)

    def binop(self, opcode: int, l: FS, r: FS) -> "TFS":
        v = _apply_binop(opcode, l.v, r.v)
        return TFS(v, self._push((opcode, self._nid(l), self._nid(r))), self)

    def unop(self, opcode: int, a: FS) -> "TFS":
        v = _apply_unop(opcode, a.v)
        return TFS(v, self._push((opcode, self._nid(a))), self)

    # -- guards ----------------------------------------------------------------

    def guard_cmp(self, cmp: int, l: FS, r: FS, result: bool) -> None:
        self._push((OP_GUARD_CMP, cmp, self._nid(l), self._nid(r), result))

    def guard_zero(self, a: FS, result: bool) -> None:
        self._push((OP_GUARD_ZERO, self._nid(a), result))

    def guard_int(self, a: FS, result: Optional[int]) -> None:
        self._push((OP_GUARD_INT, self._nid(a), result))

    def finish(self, signals) -> "WitnessProgram":
        """Freeze into a program; `signals` is the recording run's
        Signals store (witness values plain-FS or TFS)."""
        meta = []
        nodes = []
        for s in signals.ids:
            meta.append((s.full_name, s.xtype))
            v = s.value.v if s.value is not None else None
            if isinstance(v, TFS):
                nodes.append(v.nid)
            elif isinstance(v, FS):
                nodes.append(-1 - self.const_id(v.v))  # encode const as -1-nid
            elif s.id == 0 and v is None:
                # the pre-inserted "one" signal never gets a value during
                # witness generation; it is the constant 1 by definition
                nodes.append(-1 - self.const_id(1))
            else:
                nodes.append(None)  # unset / non-scalar (replay rejects)
        return WitnessProgram(self.input_names, self.tape, meta, nodes)


def _apply_binop(op: int, a: int, b: int) -> int:
    """Plain-int mirror of the FS op semantics (algebra.py / fs.rs)."""
    if op == OP_ADD:
        return (a + b) % R
    if op == OP_SUB:
        return (a - b) % R
    if op == OP_MUL:
        return (a * b) % R
    if op == OP_DIV:
        try:
            return (a * pow(b, -1, R)) % R
        except ValueError as exc:
            raise AlgebraError(f"Cannot find inv of {b}") from exc
    if op == OP_INTDIV:
        if b == 0:
            raise AlgebraError("Division by zero")
        return a // b
    if op == OP_MOD:
        if b == 0:
            raise AlgebraError("Divison by zero")
        return a % b
    if op == OP_SHL:
        if b >= (1 << 64):
            raise AlgebraError("Only can shl on 64 bit values")
        return (a << b) % R
    if op == OP_SHR:
        if b >= (1 << 64):
            raise AlgebraError("Only can shr on 64 bit values")
        return a >> b
    if op == OP_BAND:
        return (a & b) % R
    if op == OP_BOR:
        return (a | b) % R
    if op == OP_BXOR:
        return (a ^ b) % R
    if op == OP_POW:
        return pow(a, b, R)
    raise TypeError(op)


def _apply_unop(op: int, a: int) -> int:
    if op == OP_NEG:
        return (R - a) % R
    if op == OP_INV:
        try:
            return pow(a, -1, R)
        except ValueError as exc:
            raise AlgebraError(f"Cannot find inv of {a}") from exc
    raise TypeError(op)


class TFS(FS):
    """A traced field scalar: concrete value + tape node id.

    Every operation records a tape entry via the owning recorder and
    returns a new TFS; comparisons / zero-tests / int conversions record
    guards (they leak the concrete value into Python control flow).
    """

    __slots__ = ("nid", "rec")

    def __init__(self, v: int, nid: int, rec: TraceRecorder):
        FS.__init__(self, v)
        self.nid = nid
        self.rec = rec

    # promotion hook: `plain.div(traced)` etc. route through
    # algebra.eval_infix, which calls r._const_like(l) first
    def _const_like(self, other: FS) -> "TFS":
        if isinstance(other, TFS):
            return other
        return TFS(other.v, self.rec.const_id(other.v), self.rec)

    # -- arithmetic (incl. reflected, so plain-op-traced traces too) --------

    def __add__(self, o: FS) -> "TFS":
        return self.rec.binop(OP_ADD, self, o)

    def __radd__(self, o: FS) -> "TFS":
        return self.rec.binop(OP_ADD, o, self)

    def __sub__(self, o: FS) -> "TFS":
        return self.rec.binop(OP_SUB, self, o)

    def __rsub__(self, o: FS) -> "TFS":
        return self.rec.binop(OP_SUB, o, self)

    def __mul__(self, o: FS) -> "TFS":
        return self.rec.binop(OP_MUL, self, o)

    def __rmul__(self, o: FS) -> "TFS":
        return self.rec.binop(OP_MUL, o, self)

    def __neg__(self) -> "TFS":
        return self.rec.unop(OP_NEG, self)

    def inv(self) -> "TFS":
        return self.rec.unop(OP_INV, self)

    def div(self, o: FS) -> "TFS":
        return self.rec.binop(OP_DIV, self, o)

    def intdiv(self, o: FS) -> "TFS":
        return self.rec.binop(OP_INTDIV, self, o)

    def modulo(self, o: FS) -> "TFS":
        return self.rec.binop(OP_MOD, self, o)

    def pow(self, o: FS) -> "TFS":
        return self.rec.binop(OP_POW, self, o)

    def shl(self, o: FS) -> "TFS":
        return self.rec.binop(OP_SHL, self, o)

    def shr(self, o: FS) -> "TFS":
        return self.rec.binop(OP_SHR, self, o)

    def __and__(self, o: FS) -> "TFS":
        return self.rec.binop(OP_BAND, self, o)

    def __rand__(self, o: FS) -> "TFS":
        return self.rec.binop(OP_BAND, o, self)

    def __or__(self, o: FS) -> "TFS":
        return self.rec.binop(OP_BOR, self, o)

    def __ror__(self, o: FS) -> "TFS":
        return self.rec.binop(OP_BOR, o, self)

    def __xor__(self, o: FS) -> "TFS":
        return self.rec.binop(OP_BXOR, self, o)

    def __rxor__(self, o: FS) -> "TFS":
        return self.rec.binop(OP_BXOR, o, self)

    # -- control-flow leaks: guard ------------------------------------------

    def __eq__(self, o: object) -> bool:
        if not isinstance(o, FS):
            return False
        res = self.v == o.v
        self.rec.guard_cmp(CMP_EQ, self, o, res)
        return res

    def __lt__(self, o: FS) -> bool:
        res = self.v < o.v
        self.rec.guard_cmp(CMP_LT, self, o, res)
        return res

    def __le__(self, o: FS) -> bool:
        res = self.v <= o.v
        self.rec.guard_cmp(CMP_LE, self, o, res)
        return res

    def __gt__(self, o: FS) -> bool:
        res = self.v > o.v
        self.rec.guard_cmp(CMP_GT, self, o, res)
        return res

    def __ge__(self, o: FS) -> bool:
        res = self.v >= o.v
        self.rec.guard_cmp(CMP_GE, self, o, res)
        return res

    __hash__ = FS.__hash__  # defining __eq__ clears it otherwise

    def is_zero(self) -> bool:
        res = self.v == 0
        self.rec.guard_zero(self, res)
        return res

    def try_to_int(self) -> Optional[int]:
        res = self.v if self.v < (1 << 64) else None
        self.rec.guard_int(self, res)
        return res

    def is_one(self) -> bool:
        # guarded even though no current evaluator branch uses it for
        # control flow -- the replay soundness invariant must not depend
        # on auditing future call sites
        res = self.v == 1
        self.rec.guard_cmp(CMP_EQ, self, FS(1), res)
        return res

    def is_neg(self) -> bool:
        from ..algebra import _FIELD_HALF

        res = self.v > _FIELD_HALF
        self.rec.guard_cmp(CMP_GT, self, FS(_FIELD_HALF), res)
        return res


_CMP_FN = {
    CMP_LT: lambda a, b: a < b,
    CMP_LE: lambda a, b: a <= b,
    CMP_GT: lambda a, b: a > b,
    CMP_GE: lambda a, b: a >= b,
    CMP_EQ: lambda a, b: a == b,
}


class WitnessProgram:
    """A frozen straight-line witness program: replayable tape + the
    signal table layout of the recording run."""

    VERSION = 1

    def __init__(self, input_names, tape, signals_meta, signal_nodes):
        self.input_names = list(input_names)
        self.tape = tape
        self.signals_meta = signals_meta    # [(full_name, xtype)] id-ordered
        self.signal_nodes = signal_nodes    # nid | -1-const_nid | None
        self._packed_cache = None

    # -- native replay ---------------------------------------------------------
    # The tape packs once per process into flat numpy arrays consumed
    # by the C interpreter (native/wtrace_replay.c, ~40x the Python
    # loop); Python replay remains the fallback when no compiler is
    # available (native/__init__.py returns None).

    def _packed(self):
        if self._packed_cache is not None:
            return self._packed_cache
        import numpy as np

        n = len(self.tape)
        op = np.zeros(n, np.uint8)
        a0 = np.zeros(n, np.int64)
        a1 = np.zeros(n, np.int64)
        a2 = np.zeros(n, np.int64)
        consts: list[int] = []
        for i, e in enumerate(self.tape):
            o = e[0]
            op[i] = o
            if o == OP_INPUT:
                a0[i] = e[1]
            elif o == OP_CONST:
                a0[i] = len(consts)
                consts.append(e[1])
            elif o == OP_GUARD_CMP:
                a0[i] = e[2]
                a1[i] = e[3]
                a2[i] = (e[1] << 1) | int(bool(e[4]))
            elif o == OP_GUARD_ZERO:
                a0[i] = e[1]
                a2[i] = int(bool(e[2]))
            elif o == OP_GUARD_INT:
                a0[i] = e[1]
                if e[2] is not None:
                    a1[i] = np.uint64(e[2]).astype(np.int64)
                    a2[i] = 1
            elif o in (OP_NEG, OP_INV):
                a0[i] = e[1]
            else:  # binary arithmetic
                a0[i] = e[1]
                a1[i] = e[2]
        cl = np.zeros((max(len(consts), 1), 4), np.uint64)
        mask = (1 << 64) - 1
        for j, v in enumerate(consts):
            for k in range(4):
                cl[j, k] = (v >> (64 * k)) & mask
        self._packed_cache = (op, a0, a1, a2, cl)
        return self._packed_cache

    def replay_limbs(self, inputs: dict[str, int]):
        """Native replay: per-node values as an (n, 4) u64 limb array,
        or None when the native library is unavailable.  Raises
        TraceMismatch on guard divergence / arithmetic error, exactly
        like replay_values."""
        from ..native import wtrace_lib

        lib = wtrace_lib()
        if lib is None:
            return None
        if set(inputs) != set(self.input_names):
            raise TraceMismatch("input name set differs from recording")
        import ctypes

        import numpy as np

        op, a0, a1, a2, cl = self._packed()
        mask = (1 << 64) - 1
        inp = np.zeros((max(len(self.input_names), 1), 4), np.uint64)
        for j, name in enumerate(self.input_names):
            v = inputs[name] % R
            for k in range(4):
                inp[j, k] = (v >> (64 * k)) & mask
        vals = np.empty((len(op), 4), np.uint64)
        err = ctypes.c_int64(-1)
        p = lambda arr, t: arr.ctypes.data_as(ctypes.POINTER(t))  # noqa: E731
        rc = lib.za_wtrace_replay(
            len(op),
            p(op, ctypes.c_uint8),
            p(a0, ctypes.c_int64), p(a1, ctypes.c_int64),
            p(a2, ctypes.c_int64),
            p(cl, ctypes.c_uint64), p(inp, ctypes.c_uint64),
            p(vals, ctypes.c_uint64),
            ctypes.byref(err),
        )
        if rc:
            kind = {1: "guard", 2: "arithmetic", 3: "opcode"}.get(
                rc, str(rc)
            )
            raise TraceMismatch(f"native {kind} divergence @{err.value}")
        return vals

    # -- direct-to-assignment replay -------------------------------------------

    def meta_signals(self):
        """A value-free Signals store with the recording run's layout
        (names + types): enough for R1CS.from_constraints, built once
        so repeat proves skip the 1M-object witness-store rebuild."""
        from .signals import Signals

        s = Signals()
        for name, xtype in self.signals_meta[1:]:
            s.insert(name, xtype, None)
        return s

    def run_z(self, inputs: dict[str, int], r1cs):
        """Replay straight into the R1CS variable assignment.

        Returns (z_limbs, z_head) where z_limbs is the (16, num_vars)
        u16-limb u32 array the engine consumes directly and z_head is
        the plain-int prefix z[0:num_inputs] (public inputs for the
        verifier).  Falls back to the Python tape when the native
        library is unavailable."""
        import numpy as np

        nv = r1cs.num_vars
        # var -> node map (cached): node >= 0 tape value, node < 0 const
        vmap = getattr(self, "_var_nodes", None)
        if vmap is None or len(vmap) != nv:
            vmap = np.full(nv, -1, np.int64)
            cvals = np.zeros((nv, 4), np.uint64)
            mask = (1 << 64) - 1
            for sid, node in enumerate(self.signal_nodes):
                v = (
                    r1cs.var_of_signal[sid]
                    if sid < len(r1cs.var_of_signal) else None
                )
                if v is None:
                    continue
                if node is None:
                    raise TraceMismatch(
                        f"signal {self.signals_meta[sid][0]} untraced"
                    )
                if node >= 0:
                    vmap[v] = node
                else:
                    cv = self.tape[-1 - node][1]
                    for k in range(4):
                        cvals[v, k] = (cv >> (64 * k)) & mask
            self._var_nodes = vmap
            self._var_consts = cvals
        cvals = self._var_consts

        vals = self.replay_limbs(inputs)
        if vals is None:  # Python fallback
            ints = self.replay_values(inputs)
            z = [0] * nv
            mask = (1 << 64) - 1
            zl = np.zeros((nv, 4), np.uint64)
            for v in range(nv):
                node = int(vmap[v])
                val = (
                    ints[node] if node >= 0
                    else int(
                        cvals[v, 0] | (int(cvals[v, 1]) << 64)
                        | (int(cvals[v, 2]) << 128)
                        | (int(cvals[v, 3]) << 192)
                    )
                )
                z[v] = val
                for k in range(4):
                    zl[v, k] = (val >> (64 * k)) & mask
            z_limbs = self._u64_to_limbs16(zl)
            return z_limbs, z[: r1cs.num_inputs]

        picked = np.where(
            (vmap >= 0)[:, None], vals[np.maximum(vmap, 0)], cvals
        )  # (nv, 4) u64
        z_limbs = self._u64_to_limbs16(picked)
        head = [
            int(picked[v, 0]) | (int(picked[v, 1]) << 64)
            | (int(picked[v, 2]) << 128) | (int(picked[v, 3]) << 192)
            for v in range(r1cs.num_inputs)
        ]
        return z_limbs, head

    @staticmethod
    def _u64_to_limbs16(zl):
        """(nv, 4) u64 -> (16, nv) u32 of 16-bit limbs (engine witness
        layout, engine/field.py)."""
        import numpy as np

        b = zl.astype("<u8").view(np.uint16).reshape(zl.shape[0], 16)
        return np.ascontiguousarray(b.T).astype(np.uint32)

    # -- replay ----------------------------------------------------------------

    def replay_values(self, inputs: dict[str, int]) -> list[int]:
        """Evaluate the tape; returns per-node values. Raises
        TraceMismatch on any guard divergence or arithmetic error (the
        caller falls back to the interpreter, which reproduces the real
        error / takes the other branch)."""
        if set(inputs) != set(self.input_names):
            raise TraceMismatch("input name set differs from recording")
        tape = self.tape
        vals = [0] * len(tape)
        cmp_fn = _CMP_FN
        try:
            for i, e in enumerate(tape):
                op = e[0]
                if op == OP_ADD:
                    vals[i] = (vals[e[1]] + vals[e[2]]) % R
                elif op == OP_MUL:
                    vals[i] = (vals[e[1]] * vals[e[2]]) % R
                elif op == OP_SUB:
                    vals[i] = (vals[e[1]] - vals[e[2]]) % R
                elif op == OP_CONST:
                    vals[i] = e[1]
                elif op == OP_INPUT:
                    vals[i] = inputs[self.input_names[e[1]]] % R
                elif op <= OP_POW:  # the rarer binary ops
                    vals[i] = _apply_binop(op, vals[e[1]], vals[e[2]])
                elif op == OP_NEG:
                    vals[i] = (R - vals[e[1]]) % R
                elif op == OP_INV:
                    vals[i] = _apply_unop(OP_INV, vals[e[1]])
                elif op == OP_GUARD_CMP:
                    if cmp_fn[e[1]](vals[e[2]], vals[e[3]]) != e[4]:
                        raise TraceMismatch(f"cmp guard @{i}")
                elif op == OP_GUARD_ZERO:
                    if (vals[e[1]] == 0) != e[2]:
                        raise TraceMismatch(f"zero guard @{i}")
                elif op == OP_GUARD_INT:
                    v = vals[e[1]]
                    got = v if v < (1 << 64) else None
                    if got != e[2]:
                        raise TraceMismatch(f"int guard @{i}")
                else:
                    raise TraceMismatch(f"bad opcode {op}")
        except AlgebraError as exc:
            raise TraceMismatch(f"arithmetic diverged: {exc}") from exc
        return vals

    def run(self, inputs: dict[str, int]):
        """Replay and rebuild a Signals store shaped like the recording
        run's, with this input's witness values."""
        from ..algebra import Value
        from .signals import Signals

        limbs = self.replay_limbs(inputs)  # native; None -> Python tape
        if limbs is None:
            vals = self.replay_values(inputs)

            def node_val(node):
                return vals[node]
        else:
            def node_val(node):
                row = limbs[node]
                return (
                    int(row[0]) | (int(row[1]) << 64)
                    | (int(row[2]) << 128) | (int(row[3]) << 192)
                )

        signals = Signals()
        for i, (full_name, xtype) in enumerate(self.signals_meta):
            node = self.signal_nodes[i]
            if node is None:
                raise TraceMismatch(f"signal {full_name} untraced")
            v = node_val(node) if node >= 0 else self.tape[-1 - node][1]
            if i == 0:
                signals.ids[0].value = Value(FS(v))  # pre-inserted "one"
            else:
                signals.insert(full_name, xtype, Value(FS(v)))
        return signals

    # -- persistence -------------------------------------------------------------
    # Data-only JSON serialization: a .wtrace sidecar may travel with a
    # distributable pk bundle, so loading one must never execute code
    # (pickle would). Everything in the file is ints/strings/bools/null.

    def dump(self, path: str, pk_digest: bytes) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(
                {
                    "version": self.VERSION,
                    "pk_digest": pk_digest.hex(),
                    "input_names": self.input_names,
                    "tape": [list(e) for e in self.tape],
                    "signals_meta": [
                        [name, int(xtype)] for name, xtype in self.signals_meta
                    ],
                    "signal_nodes": self.signal_nodes,
                },
                f,
                separators=(",", ":"),
            )

    @staticmethod
    def load(path: str, pk_digest: bytes) -> Optional["WitnessProgram"]:
        from ..lang.ast import SignalType

        try:
            with open(path, "r", encoding="utf-8") as f:
                d = json.load(f)
        except (OSError, ValueError):
            return None
        try:
            if d.get("version") != WitnessProgram.VERSION:
                return None
            if d.get("pk_digest") != pk_digest.hex():
                return None
            tape = [tuple(e) for e in d["tape"]]
            meta = [
                (name, SignalType(xtype)) for name, xtype in d["signals_meta"]
            ]
            return WitnessProgram(
                d["input_names"], tape, meta, d["signal_nodes"]
            )
        except (KeyError, TypeError, ValueError):
            return None


def pk_digest(pk_path: str) -> bytes:
    """Content hash binding a cached witness program to its proving key."""
    h = hashlib.blake2b(digest_size=32)
    with open(pk_path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.digest()
