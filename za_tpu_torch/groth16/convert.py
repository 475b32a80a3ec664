"""Carry parameters and constraint systems across as plain arrays.

``params_from_arrays`` takes a proving key in the raw query layout the
reference's pk parser produces (za_tpu/groth16/format.py RawG1Query /
RawG2Query): per G1 query ``x``, ``y``, ``z`` as (16, n) 16-bit plain
limbs with infinity as (0 : 1 : 0); per G2 query ``x0``, ``x1``,
``y0``, ``y1``, ``z0``; the verifying key's points as ints (None for
infinity); and ``domain_size``.  ``r1cs_from_arrays`` takes the A/B/C
rows as CSR arrays (row pointer, column, coefficient as 16 limbs of 16
bits) plus ``num_inputs``, ``num_aux`` and ``input_names``.
"""

from __future__ import annotations

import numpy as np

from ..curve import Fq2
from ..engine.field import limbs_to_ints
from .r1cs import R1CS
from .setup import Groth16Parameters, VerifyingKey

G1_KEYS = ("x", "y", "z")
G2_KEYS = ("x0", "x1", "y0", "y1", "z0")


class FormatError(Exception):
    """A proving key whose contents break its format: the reference's
    za_tpu/groth16/format.py FormatError.  Raw queries are parsed
    without per-point checks; staging checks them against the curve
    (engine.GpuEngine)."""


class RawG1Query:
    """G1 query vector as projective limb arrays x, y, z (16, n)."""

    def __init__(self, x, y, z):
        self.x, self.y, self.z = (np.asarray(a, np.uint32) for a in (x, y, z))

    def __len__(self):
        return self.x.shape[1]

    def expand(self, dense) -> "RawG1Query":
        """Density-filtered query -> one column per variable."""
        if len(self) == len(dense):
            return self
        idx = np.nonzero(np.asarray(dense, dtype=bool))[0]
        if len(idx) != len(self):
            raise ValueError("query length matches neither num_vars nor "
                             "the density count")
        out = {k: np.zeros((16, len(dense)), np.uint32) for k in G1_KEYS}
        out["y"][0] = 1
        for k in G1_KEYS:
            out[k][:, idx] = getattr(self, k)
        return RawG1Query(**out)

    def to_points(self) -> list:
        xs, ys = limbs_to_ints(self.x), limbs_to_ints(self.y)
        inf = self.z[0] == 0
        return [None if inf[j] else (xs[j], ys[j]) for j in range(len(self))]


class RawG2Query:
    """G2 query vector as limb arrays x0, x1, y0, y1, z0 (16, n)."""

    def __init__(self, x0, x1, y0, y1, z0):
        self.x0, self.x1, self.y0, self.y1, self.z0 = (
            np.asarray(a, np.uint32) for a in (x0, x1, y0, y1, z0))

    def __len__(self):
        return self.x0.shape[1]

    def expand(self, dense) -> "RawG2Query":
        if len(self) == len(dense):
            return self
        idx = np.nonzero(np.asarray(dense, dtype=bool))[0]
        if len(idx) != len(self):
            raise ValueError("query length matches neither num_vars nor "
                             "the density count")
        out = {k: np.zeros((16, len(dense)), np.uint32) for k in G2_KEYS}
        out["y0"][0] = 1
        for k in G2_KEYS:
            out[k][:, idx] = getattr(self, k)
        return RawG2Query(**out)

    def to_points(self) -> list:
        x0, x1, y0, y1 = (limbs_to_ints(getattr(self, k))
                          for k in G2_KEYS[:4])
        inf = self.z0[0] == 0
        return [None if inf[j] else (Fq2(x0[j], x1[j]), Fq2(y0[j], y1[j]))
                for j in range(len(self))]


def _g1(p):
    return None if p is None else (int(p[0]), int(p[1]))


def _g2(p):
    if p is None:
        return None
    (x0, x1), (y0, y1) = p
    return (Fq2(int(x0), int(x1)), Fq2(int(y0), int(y1)))


def params_from_arrays(d: dict) -> Groth16Parameters:
    vk = d["vk"]
    return Groth16Parameters(
        vk=VerifyingKey(
            alpha_g1=_g1(vk["alpha_g1"]), beta_g1=_g1(vk["beta_g1"]),
            beta_g2=_g2(vk["beta_g2"]), gamma_g2=_g2(vk["gamma_g2"]),
            delta_g1=_g1(vk["delta_g1"]), delta_g2=_g2(vk["delta_g2"]),
            ic=[_g1(p) for p in vk["ic"]],
        ),
        h=RawG1Query(**{k: d["h"][k] for k in G1_KEYS}),
        l=RawG1Query(**{k: d["l"][k] for k in G1_KEYS}),
        a=RawG1Query(**{k: d["a"][k] for k in G1_KEYS}),
        b_g1=RawG1Query(**{k: d["b_g1"][k] for k in G1_KEYS}),
        b_g2=RawG2Query(**{k: d["b_g2"][k] for k in G2_KEYS}),
        domain_size=int(d["domain_size"]),
    )


def _rows(csr: dict) -> list:
    ptr = np.asarray(csr["indptr"])
    cols = np.asarray(csr["indices"])
    coeffs = limbs_to_ints(csr["coeffs"])
    return [
        [(int(cols[j]), coeffs[j]) for j in range(ptr[k], ptr[k + 1])]
        for k in range(len(ptr) - 1)
    ]


def r1cs_from_arrays(d: dict) -> R1CS:
    return R1CS(
        num_inputs=int(d["num_inputs"]),
        num_aux=int(d["num_aux"]),
        input_names=list(d["input_names"]),
        a_rows=_rows(d["a"]),
        b_rows=_rows(d["b"]),
        c_rows=_rows(d["c"]),
    )
