"""Groth16 over BN254: R1CS, domain, setup, prover and verifier."""

from .prove import HostEngine, Proof, prove
from .r1cs import R1CS
from .setup import Groth16Parameters, VerifyingKey, generate_parameters
from .verify import verify_proof

__all__ = [
    "Groth16Parameters", "HostEngine", "Proof", "R1CS", "VerifyingKey",
    "generate_parameters", "prove", "verify_proof",
]
