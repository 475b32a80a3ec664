"""Append-only signal arena (reference: compiler/src/types/signal.rs)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..algebra import FS, LC, QEQ, SignalId, Value
from ..lang.ast import SignalType


@dataclass
class Signal:
    id: SignalId
    xtype: SignalType
    full_name: str
    value: Optional[Value]

    def is_main_public_input(self) -> bool:
        """One dot in the full name and Output/PublicInput (signal.rs:58-62)."""
        return self.full_name.count(".") == 1 and self.xtype in (
            SignalType.Output,
            SignalType.PublicInput,
        )

    def is_main_input(self) -> bool:
        return self.full_name.count(".") == 1 and self.xtype in (
            SignalType.Output,
            SignalType.PublicInput,
            SignalType.PrivateInput,
        )

    def __repr__(self) -> str:
        return f"Signal {{ id: {self.id}, xtype: {self.xtype.name}, full_name: {self.full_name}, value: {self.value} }}"


class Signals:
    """Signal 0 is the auto-inserted constant-one signal (signal.rs:77-87)."""

    def __init__(self):
        self.ids: list[Signal] = []
        self.names: dict[str, SignalId] = {}
        self.insert("one", SignalType.PublicInput, None)

    def __len__(self) -> int:
        return len(self.ids)

    def get_by_id(self, id: SignalId) -> Optional[Signal]:
        if 0 <= id < len(self.ids):
            return self.ids[id]
        return None

    def get_by_name(self, full_name: str) -> Optional[Signal]:
        id = self.names.get(full_name)
        return self.ids[id] if id is not None else None

    def update(self, id: SignalId, value: Value) -> None:
        self.ids[id].value = value

    def insert(
        self, full_name: str, xtype: SignalType, value: Optional[Value]
    ) -> SignalId:
        id = len(self.ids)
        self.ids.append(Signal(id, xtype, full_name, value))
        self.names[full_name] = id
        return id

    def main_public_input_names(self) -> list[str]:
        return [
            s.full_name for s in self.ids[1:] if s.is_main_public_input()
        ]

    def main_input_ids(self) -> list[SignalId]:
        return [s.id for s in self.ids[1:] if s.is_main_input()]

    def to_string(self, id: SignalId) -> str:
        s = self.ids[id]
        value = f"Some({s.value})" if s.value is not None else "None"
        return f"{s.full_name}:{s.xtype.name}:{value}"

    def format(self, a: Value) -> str:
        """Render a Value with signal names instead of ids."""

        def sname(id: SignalId) -> str:
            s = self.get_by_id(id)
            return s.full_name if s is not None else "unwnown"

        if isinstance(a.v, FS):
            return str(a.v)
        if isinstance(a.v, LC):
            return a.v.format(sname)
        if isinstance(a.v, QEQ):
            return a.v.format(sname)
        raise TypeError(a)
