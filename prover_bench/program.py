"""The system under test, za_tpu_torch, as the benchmark drives it: the
plain inputs turned into the port's objects (``GpuEngine`` from here),
one ``prove`` call, and its proof turned back into plain tuples.

Imported only once the harness has looked for the card (and, in a
traced run, set ``ZA_METRICS``), since the port reads that variable when
it is imported.
"""

from __future__ import annotations

import logging
import re

import torch

from za_tpu_torch.curve import Fq2
from za_tpu_torch.engine import _build
from za_tpu_torch.engine.engine import GpuEngine
from za_tpu_torch.groth16.format import RawG1Query, RawG2Query
from za_tpu_torch.groth16.prove import prove
from za_tpu_torch.groth16.r1cs import R1CS
from za_tpu_torch.groth16.setup import Groth16Parameters, VerifyingKey

STAGE_LINE = re.compile(r"^\[stage\] (\S+): ([0-9.]+)s(?: device ([0-9.]+)s)?$")


def r1cs(circuit: dict) -> R1CS:
    return R1CS(num_inputs=circuit["num_inputs"],
                num_aux=circuit["num_aux"],
                input_names=circuit["input_names"],
                a_rows=circuit["a"], b_rows=circuit["b"],
                c_rows=circuit["c"])


def _g2(p):
    return (Fq2(*p[0]), Fq2(*p[1]))


def params(pk: dict) -> Groth16Parameters:
    v = pk["vk"]
    vk = VerifyingKey(alpha_g1=v["alpha_g1"], beta_g1=v["beta_g1"],
                      beta_g2=_g2(v["beta_g2"]), gamma_g2=_g2(v["gamma_g2"]),
                      delta_g1=v["delta_g1"], delta_g2=_g2(v["delta_g2"]),
                      ic=list(v["ic"]))
    return Groth16Parameters(
        vk=vk, h=RawG1Query(**pk["h"]), l=RawG1Query(**pk["l"]),
        a=RawG1Query(**pk["a"]), b_g1=RawG1Query(**pk["b1"]),
        b_g2=RawG2Query(**pk["b2"]), domain_size=pk["m"])


def build_kernels() -> None:
    """Compile csrc/*.cu into the port's build directory, or find them
    built there."""
    _build.build_all()


def plain(proof) -> tuple:
    """The port's proof -> affine points as plain int tuples."""
    b = proof.b
    return (proof.a,
            None if b is None else ((b[0].c0, b[0].c1), (b[1].c0, b[1].c1)),
            proof.c)


def prove_once(prm, rc, z, r: int, s: int, eng):
    return prove(prm, rc, z, r=r, s=s, engine=eng)


class StageLines(logging.Handler):
    """Collects the engine's stage lines (engine/metrics.py, on under
    ZA_METRICS=1) as (name, wall seconds, device seconds or None)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines: list = []

    def emit(self, record):
        m = STAGE_LINE.match(record.getMessage())
        if m:
            self.lines.append((m.group(1), float(m.group(2)),
                               None if m.group(3) is None
                               else float(m.group(3))))

    def __enter__(self):
        log = logging.getLogger("za_tpu_torch.metrics")
        self._level = log.level
        log.setLevel(logging.INFO)
        log.addHandler(self)
        return self

    def __exit__(self, *exc):
        log = logging.getLogger("za_tpu_torch.metrics")
        log.removeHandler(self)
        log.setLevel(self._level)


def memory_peak_bytes(device) -> int:
    if torch.device(device).type != "cuda":
        return 0
    return torch.cuda.max_memory_allocated(device)
