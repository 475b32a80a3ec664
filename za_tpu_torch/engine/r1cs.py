"""R1CS sparse matvec over Fr on the device, and the satisfiability
check.

The A/B/C rows pack once per R1CS into COO triples (Montgomery
coefficient limbs, column, row), cached on the R1CS object (the
reference's engine._pack_rows / _r1cs_entries_rns).  A matvec is one
Montgomery product per entry, then per-row limb sums (index_add) and
one Montgomery reduction of the sums, at the domain size m: rows past
the constraints stay zero (the reference's _matvec_rns_jit).
"""

from __future__ import annotations

import numpy as np
import torch

from . import field as F

FR = F.FR
MAX_ROW = 1 << 16   # row sums of 16-bit limbs stay < 2^32


def pack_rows(rows, device):
    """Rows [(var, coeff), ...] -> (coeffs (16, nnz) l16 Montgomery,
    cols (nnz,), rowids (nnz,)) on ``device``."""
    coeffs, cols, rowids = [], [], []
    for k, row in enumerate(rows):
        if len(row) > MAX_ROW:
            raise ValueError(f"constraint row {k} longer than {MAX_ROW}")
        for var, coeff in row:
            coeffs.append(FR.to_mont_int(coeff % FR.modulus))
            cols.append(var)
            rowids.append(k)
    if not coeffs:
        coeffs, cols, rowids = [0], [0], [0]
    limbs = torch.from_numpy(F.ints_to_limbs(coeffs).astype(np.int64))
    return (limbs.to(device),
            torch.tensor(cols, dtype=torch.int64, device=device),
            torch.tensor(rowids, dtype=torch.int64, device=device))


def r1cs_entries(r1cs, device):
    """Packed (A, B, C) triples, cached on the r1cs per device."""
    cache = r1cs.__dict__.setdefault("_torch_entries", {})
    key = str(device)
    if key not in cache:
        cache[key] = tuple(pack_rows(rows, device) for rows in
                           (r1cs.a_rows, r1cs.b_rows, r1cs.c_rows))
    return cache[key]


def matvec(entries, z_mont: torch.Tensor, m: int) -> torch.Tensor:
    """(M z) for one packed matrix: z_mont (16, nv) l16 Montgomery ->
    (16, m) l16 Montgomery."""
    coeffs, cols, rowids = entries
    prod = FR.mul(coeffs, z_mont.index_select(1, cols))
    t = torch.zeros((2 * F.NLIMBS + 1, m), dtype=F.I64,
                    device=z_mont.device)
    t[:F.NLIMBS].index_add_(1, rowids, prod)
    # t holds V < 2^16 r: redc gives V / 2^256, the R^2 product restores V
    return FR.mul(FR.redc(t), FR.const(FR.r2, z_mont))


def satisfied(legs) -> bool:
    """Az o Bz == Cz on every row (Montgomery, canonical)."""
    az, bz, cz = legs
    return bool(torch.equal(FR.mul(az, bz), cz))
