"""Constraint store + the reference R1CS satisfaction checker
(reference: compiler/src/types/constraint.rs)."""

from __future__ import annotations

from typing import Optional

from ..algebra import FS, LC, QEQ, Value
from .signals import Signals


class Constraints:
    def __init__(self):
        self.rows: list[QEQ] = []
        self.debug: list[Optional[str]] = []

    def __len__(self) -> int:
        return len(self.rows)

    def is_empty(self) -> bool:
        return not self.rows

    def get(self, i: int) -> QEQ:
        return self.rows[i]

    def get_debug(self, i: int) -> Optional[str]:
        return self.debug[i]

    def push(self, qeq: QEQ, debug: Optional[str] = None) -> int:
        self.rows.append(qeq)
        self.debug.append(debug)
        return len(self.rows) - 1

    def satisfies_with_signals(self, signals: Signals) -> None:
        """Evaluate every row's a,b,c over witness values; require
        a*b + c = 0. Raises ValueError with diagnostics on failure
        (constraint.rs:29-67). This is the host reference checker the device
        R1CS matvec (engine.r1cs) must replicate at scale."""

        def eval_lc(lc: LC) -> FS:
            acc = FS.zero()
            for s, v in lc.t:
                if s == 0:
                    s_val = FS.one()
                else:
                    sig = signals.get_by_id(s)
                    if sig is None or sig.value is None or not isinstance(
                        sig.value.v, FS
                    ):
                        raise ValueError(f"signal bad value {sig}")
                    s_val = sig.value.v
                acc = acc + (v * s_val)
            return acc

        for n, qeq in enumerate(self.rows):
            a = eval_lc(qeq.a)
            b = eval_lc(qeq.b)
            c = eval_lc(qeq.c)
            zero = (a * b) + c
            if not zero.is_zero():
                debug = self.get_debug(n) or ""
                raise ValueError(
                    f"constrain '{signals.format(Value(qeq))}' ({debug}) "
                    f"evals to non-zero ({zero!r})"
                )
