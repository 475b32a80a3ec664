"""Compiled R1CS: the bridge from the constraint system to the prover.

Variable 0 is ONE, the public inputs follow, then every aux variable;
row k states ``a_rows[k] . z * b_rows[k] . z = c_rows[k] . z``.  An
R1CS comes from the circuit compiler (``from_constraints``: the main
public inputs in signal-id order, then every other non-ignored signal;
each QEQ row ``a*b + c = 0`` becomes ``a * b = -c``), arrives as rows
(``groth16.convert``), or is built directly, as synthetic benchmark
circuits are.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..algebra import FS, SignalId
from ..compiler.constraints import Constraints
from ..compiler.signals import Signals
from ..curve import R

#: sparse linear combination over variable indices: list of (var, coeff)
Row = list[tuple[int, int]]


@dataclass
class R1CS:
    """a_rows[k] . z * b_rows[k] . z = c_rows[k] . z  for all k."""

    num_inputs: int            # including ONE at index 0
    num_aux: int
    input_names: list[str]     # names of public inputs (without ONE)
    a_rows: list[Row]
    b_rows: list[Row]
    c_rows: list[Row]
    #: map signal id -> variable index (None = ignored signal)
    var_of_signal: list[Optional[int]] = field(repr=False,
                                               default_factory=list)

    @property
    def num_constraints(self) -> int:
        return len(self.a_rows)

    @property
    def num_vars(self) -> int:
        return self.num_inputs + self.num_aux

    @staticmethod
    def from_constraints(
        signals: Signals,
        constraints: Constraints,
        ignore_signals: list[SignalId],
    ) -> "R1CS":
        ignore = set(ignore_signals)
        var_of_signal: list[Optional[int]] = [None] * len(signals)
        var_of_signal[0] = 0

        input_names = []
        next_input = 1
        for n in range(1, len(signals)):
            if n in ignore:
                continue
            s = signals.get_by_id(n)
            if s.is_main_public_input():
                var_of_signal[n] = next_input
                input_names.append(s.full_name)
                next_input += 1
        num_inputs = next_input
        next_aux = num_inputs
        for n in range(1, len(signals)):
            if n in ignore or var_of_signal[n] is not None:
                continue
            var_of_signal[n] = next_aux
            next_aux += 1

        def conv(lc, negate=False) -> Row:
            out = []
            for s, coeff in lc.t:
                v = var_of_signal[s]
                if v is None:
                    raise ValueError(f"signal {s} not defined")
                out.append((v, (R - coeff.v) % R if negate else coeff.v))
            return out

        a_rows, b_rows, c_rows = [], [], []
        for k in range(len(constraints)):
            qeq = constraints.get(k)
            a_rows.append(conv(qeq.a))
            b_rows.append(conv(qeq.b))
            c_rows.append(conv(qeq.c, negate=True))  # a*b + c = 0 -> a*b = -c

        return R1CS(
            num_inputs=num_inputs,
            num_aux=next_aux - num_inputs,
            input_names=input_names,
            a_rows=a_rows,
            b_rows=b_rows,
            c_rows=c_rows,
            var_of_signal=var_of_signal,
        )

    def assignment_from_signals(self, signals: Signals) -> list[int]:
        """Full variable assignment z (z[0] = 1) from witness signals."""
        z = [0] * self.num_vars
        z[0] = 1
        for n in range(1, len(signals)):
            v = self.var_of_signal[n] if n < len(self.var_of_signal) else None
            if v is None:
                continue
            s = signals.get_by_id(n)
            if s is None or s.value is None or not isinstance(s.value.v, FS):
                raise ValueError(f"signal {n} has no scalar value")
            z[v] = s.value.v.v
        return z

    def eval_constraints(self, z: list[int]) -> tuple[list[int], list[int], list[int]]:
        """Az, Bz, Cz over the constraint rows (host reference of the
        device matvec)."""

        def dot(row: Row) -> int:
            return sum(c * z[v] for v, c in row) % R

        az = [dot(r) for r in self.a_rows]
        bz = [dot(r) for r in self.b_rows]
        cz = [dot(r) for r in self.c_rows]
        return az, bz, cz

    def is_satisfied(self, z: list[int]) -> bool:
        az, bz, cz = self.eval_constraints(z)
        return all((a * b - c) % R == 0 for a, b, c in zip(az, bz, cz))

    def densities(self) -> tuple[list[bool], list[bool]]:
        """Per-variable A/B density bitmaps (bellman's DensityTracker):
        a variable is A-dense if it appears with nonzero coefficient in
        any A row or is an input; B-dense if it appears in any B row.
        A pk's a/b query vectors may store only the dense entries."""
        a_d = [False] * self.num_vars
        b_d = [False] * self.num_vars
        for i in range(self.num_inputs):
            a_d[i] = True
        for row in self.a_rows:
            for var, coeff in row:
                if coeff % R:
                    a_d[var] = True
        for row in self.b_rows:
            for var, coeff in row:
                if coeff % R:
                    b_d[var] = True
        return a_d, b_d
