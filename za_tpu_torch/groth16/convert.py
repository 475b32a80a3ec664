"""Carry parameters and constraint systems across as plain arrays.

``params_from_arrays`` takes a proving key in the raw query layout the
pk parser produces (``groth16.format`` RawG1Query / RawG2Query): per
G1 query ``x``, ``y``, ``z`` as (16, n) 16-bit plain limbs with
infinity as (0 : 1 : 0); per G2 query ``x0``, ``x1``, ``y0``, ``y1``,
``z0``; the verifying key's points as ints (None for
infinity); and ``domain_size``.  ``r1cs_from_arrays`` takes the A/B/C
rows as CSR arrays (row pointer, column, coefficient as 16 limbs of 16
bits) plus ``num_inputs``, ``num_aux`` and ``input_names``.
"""

from __future__ import annotations

import numpy as np

from ..curve import Fq2
from ..engine.field import limbs_to_ints
from .format import G1_KEYS, G2_KEYS, RawG1Query, RawG2Query
from .r1cs import R1CS
from .setup import Groth16Parameters, VerifyingKey


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
