"""Groth16 verification: e(A,B) = e(alpha,beta) * e(vk_x,gamma) * e(C,delta).

Implemented as a single pairing product with one final exponentiation
(bellman's verify_proof).
"""

from __future__ import annotations

from ..curve import (
    g1_add, g1_is_on_curve, g1_mul, g1_neg, g2_is_on_curve, multi_pairing,
)
from .prove import Proof
from .setup import VerifyingKey


def verify_proof(vk: VerifyingKey, proof: Proof, public_inputs: list[int]) -> bool:
    if len(public_inputs) + 1 != len(vk.ic):
        return False
    if not (
        g1_is_on_curve(proof.a)
        and g2_is_on_curve(proof.b)
        and g1_is_on_curve(proof.c)
    ):
        return False

    vk_x = vk.ic[0]
    for i, x in enumerate(public_inputs):
        vk_x = g1_add(vk_x, g1_mul(vk.ic[i + 1], x))

    # e(A,B) * e(-vk_x, gamma) * e(-C, delta) * e(-alpha, beta) == 1
    return multi_pairing(
        [
            (proof.a, proof.b),
            (g1_neg(vk_x), vk.gamma_g2),
            (g1_neg(proof.c), vk.delta_g2),
            (g1_neg(vk.alpha_g1), vk.beta_g2),
        ]
    ).is_one()
