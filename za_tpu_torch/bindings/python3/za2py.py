"""Python binding of the port: setup / prove / verify / verbose.

The surface of the reference's binding (bindings/python3/za2py.py) over
the port's helper (``za_tpu_torch.groth16.helper``).  ``setup`` and
``prove`` run on the card unless the caller asks for the host:
``engine="gpu"`` (the default) is one ``GpuEngine`` on CUDA, built at
first use and kept for the process; without a card they raise the CUDA
error and write nothing, they do not fall back to the host.
``engine="host"`` is the exact host code.
"""

import logging

from za_tpu_torch.groth16 import helper
from za_tpu_torch.groth16.format import flatten_json

ENGINES = ("gpu", "host")

_gpu = None


def _engine(name: str):
    """"gpu" -> the process's GpuEngine (built here at first use);
    "host" -> None, the helper's host engine."""
    global _gpu
    if name not in ENGINES:
        raise ValueError(f"unknown engine {name!r}: gpu or host")
    if name == "host":
        return None
    if _gpu is None:
        from za_tpu_torch.engine.engine import GpuEngine

        _gpu = GpuEngine()  # raises without a CUDA card
    return _gpu


def verbose(on: bool) -> None:
    logging.getLogger("za_tpu_torch").setLevel(
        logging.INFO if on else logging.WARNING
    )


def setup(circuit_path: str, pk_path: str, verifier_type: str,
          engine: str = "gpu") -> str:
    """Returns the verifier artifact (json or solidity)."""
    return helper.setup(circuit_path, pk_path, verifier_type,
                        engine=_engine(engine))


def prove(pk_path: str, inputs_json: str, engine: str = "gpu") -> str:
    """Returns proof.json for the given JSON input document."""
    return helper.prove(pk_path, flatten_json("main", inputs_json),
                        engine=_engine(engine))


def verify(verifying_key_json: str, proof_with_inputs: str) -> bool:
    return helper.verify(verifying_key_json, proof_with_inputs)
