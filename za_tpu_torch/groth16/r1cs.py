"""Compiled R1CS: the bridge from the constraint system to the prover.

Variable 0 is ONE, the public inputs follow, then every aux variable;
row k states ``a_rows[k] . z * b_rows[k] . z = c_rows[k] . z``.  The
circuit compiler that builds these rows from source is not part of
this package: an R1CS arrives as rows (``groth16.convert``) or is
built directly, as synthetic benchmark circuits are.
"""

from __future__ import annotations

from dataclasses import dataclass

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

    @property
    def num_constraints(self) -> int:
        return len(self.a_rows)

    @property
    def num_vars(self) -> int:
        return self.num_inputs + self.num_aux

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
