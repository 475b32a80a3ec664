"""R1CS sparse matvec over Fr on the device, and the satisfiability
check.

The A/B/C rows pack once per R1CS and domain size into one CSR over
3 m output rows, leg k's rows at k m (``r1cs_csr``, cached on the R1CS
object; the reference's engine._r1cs_entries_rns).  A carries the
input-preservation rows az[n + i] = z_i (bellman layout) as entries of
coefficient 1, so the kernel has no special case.  Coefficients are
c R^2 mod r as l32 limbs: one Montgomery product with the plain witness
gives c z in Montgomery form.  ``matvec`` takes the witness as
``GpuEngine.witness_limbs_dev`` uploads it, (16, nv) 16-bit plain limbs
in int32, launches ``r1cs_matvec_fr`` (csrc/r1cs.cu, which packs the
limbs in registers) and returns the l32 (8, 3, m) legs that h(x)
transforms; rows past the constraints stay zero (the reference's
_matvec_rns_jit).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import field as F
from ._build import kernel

FR = F.FR
MAX_ROW = 1 << 16   # row sums of 16-bit limbs (plain version) stay < 2^32
#: rows with more entries take one warp of r1cs_matvec_fr, not one thread
#: (MV_WARP_ROW in csrc/r1cs.cu, which a test holds equal to this one)
WARP_ROW = 16
R1CS_MATVEC = kernel("r1cs_matvec_fr", "r1cs", "pppipipi")


class Csr(NamedTuple):
    """3 legs x m rows: row_ptr (3m + 1,) int32, cols (nnz,) int32,
    coeffs (8, nnz) int32 l32 c R^2 mod r."""
    row_ptr: torch.Tensor
    cols: torch.Tensor
    coeffs: torch.Tensor
    m: int


def pack_csr(legs, m: int, device) -> Csr:
    """Three row lists [[(var, coeff), ...], ...] -> their CSR over
    3 m rows (leg k at rows k m ...)."""
    coeffs, cols, lens = [], [], []
    r2 = FR.r2
    for k, rows in enumerate(legs):
        if len(rows) > m:
            raise ValueError(f"leg {k}: {len(rows)} rows, domain {m}")
        for i, row in enumerate(rows):
            if len(row) > MAX_ROW:
                raise ValueError(f"constraint row {i} longer than {MAX_ROW}")
            for var, coeff in row:
                coeffs.append(coeff % FR.modulus * r2 % FR.modulus)
                cols.append(var)
        lens += [len(row) for row in rows] + [0] * (m - len(rows))
    row_ptr = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=row_ptr[1:])
    if row_ptr[-1] >= 1 << 31:
        raise ValueError("more than 2^31 - 1 matrix entries")
    return Csr(torch.from_numpy(row_ptr.astype(np.int32)).to(device),
               torch.tensor(cols, dtype=torch.int32, device=device),
               torch.from_numpy(F.ints_to_l32(coeffs).copy()).reshape(
                   F.NL32, len(coeffs)).to(device), m)


def r1cs_csr(r1cs, m: int, device) -> Csr:
    """The A (with the input-preservation rows), B, C CSR of an R1CS at
    domain size m, cached on the r1cs per device and m."""
    cache = r1cs.__dict__.setdefault("_torch_csr", {})
    key = (str(device), m)
    if key not in cache:
        a = list(r1cs.a_rows) + [[(i, 1)] for i in range(r1cs.num_inputs)]
        cache[key] = pack_csr((a, r1cs.b_rows, r1cs.c_rows), m, device)
    return cache[key]


def _rows(csr: Csr) -> torch.Tensor:
    """Row id of each entry."""
    counts = (csr.row_ptr[1:] - csr.row_ptr[:-1]).to(F.I64)
    return torch.repeat_interleave(
        torch.arange(counts.numel(), device=counts.device), counts)


def matvec_plain(csr: Csr, z: torch.Tensor) -> torch.Tensor:
    """Plain witness z (16, nv) int32 16-bit limbs -> Montgomery legs
    (8, 3, m) l32: one product per entry, per-row limb sums
    (index_add), one Montgomery reduction of the sums and a product by
    R^2."""
    rows = 3 * csr.m
    prod = FR.mul(F.unpack(csr.coeffs),
                  z.to(F.I64).index_select(1, csr.cols.to(F.I64)))
    t = torch.zeros((2 * F.NLIMBS + 1, rows), dtype=F.I64, device=z.device)
    t[:F.NLIMBS].index_add_(1, _rows(csr), prod)
    # t holds V < 2^16 r: redc gives V / 2^256, the R^2 product restores V
    legs = FR.mul(FR.redc(t), FR.const(FR.r2, t))
    return F.pack(legs).reshape(F.NL32, 3, csr.m)


def matvec(csr: Csr, z: torch.Tensor) -> torch.Tensor:
    """The matvec kernel: one launch for the three legs, on the
    witness as uploaded, (16, nv) int32 16-bit plain limbs."""
    if z.device.type == "cpu":
        return matvec_plain(csr, z)
    if z.dtype != torch.int32 or z.dim() != 2 or z.shape[0] != F.NLIMBS:
        raise ValueError("matvec: int32 (16, nv) plain witness limbs")
    z = z.contiguous()
    out = torch.empty((F.NL32, 3, csr.m), dtype=torch.int32,
                      device=z.device)
    R1CS_MATVEC(csr.row_ptr, csr.cols, csr.coeffs, csr.cols.numel(), z,
                z.shape[1], out, 3 * csr.m)
    return out


def satisfied(legs: torch.Tensor) -> bool:
    """Az o Bz == Cz on every row of the l32 (8, 3, m) legs."""
    az, bz, cz = F.unpack(legs).unbind(1)
    return bool(torch.equal(FR.mul(az, bz), cz))
