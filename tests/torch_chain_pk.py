"""A proving key for a 30-constraint chain written to disk by za_tpu,
and the proof.json za_tpu's helper.prove makes from it: the fixture of
the port's helper tests.

The circuit is bench.py's multiplier chain at N = 30 without its output
signal: 30 constraints and 32 variables over a 32-point domain.  The
staged branch starts at 512 (groth16/prove.py STAGED_MIN); the tests
lower that gate to the chain's size (STAGED_GATE), so that every route
of the prover runs at a few dozen points, the plain versions' cost on
the CPU staying low.  The parameters come
from za_tpu's setup with fixed toxic waste and the windowed fixed-base
table of tests/test_torch_prove.py, which also records the discrete
log of every point it makes; za_tpu's prover then runs its MSMs as one
scalar multiplication each from those logs (an exact MSM of points
with known logs), so its proof.json costs seconds instead of minutes.
"""

import os
import shutil

from za_tpu.algebra import FS as ZFS
from za_tpu.compiler import Evaluator as ZEvaluator, Mode as ZMode
from za_tpu.compiler import optimize as z_optimize
from za_tpu.curve import R
from za_tpu.groth16 import format as zfmt
from za_tpu.groth16 import helper as zhelper
from za_tpu.groth16.prove import HostEngine as ZHostEngine
from za_tpu.groth16.r1cs import R1CS as ZR1CS
from za_tpu.groth16.setup import generate_parameters as z_generate_parameters
from test_torch_prove import TOXIC, ZG1, ZG2, _FixedBase, z_g1_mul, z_g2_mul

N = 30
# the staged gate the tests set: the chain's variable count
STAGED_GATE = N + 2
CIRCUIT = (
    "template chain(N) {\n"
    " signal input x;\n signal t[N];\n"
    " t[0] <== x * x;\n"
    " for (var i=1;i<N;i+=1) { t[i] <== t[i-1] * t[i-1] + i; }\n"
    "}\ncomponent main = chain(%d);\n" % N
)
INPUT_X = 987654321
RS = (13, 17)


def _g2_key(p):
    return (p[0].c0, p[0].c1, p[1].c0, p[1].c1)


class _LoggedFixedBase(_FixedBase):
    """The fixed-base table, each point it makes kept with its log."""

    def __init__(self):
        super().__init__()
        self.log1, self.log2 = {}, {}

    def fixed_base_g1(self, scalars):
        pts = super().fixed_base_g1(scalars)
        self.log1.update((p, s % R) for p, s in zip(pts, scalars)
                         if p is not None)
        return pts

    def fixed_base_g2(self, scalars):
        pts = super().fixed_base_g2(scalars)
        self.log2.update((_g2_key(p), s % R) for p, s in zip(pts, scalars)
                         if p is not None)
        return pts


class _LogEngine(ZHostEngine):
    """za_tpu's host engine with each MSM as sum_i s_i log(P_i) times
    the generator: the same group element as its point-by-point sum."""

    def __init__(self, table: _LoggedFixedBase):
        self.table = table

    def msm_g1(self, points, scalars):
        k = sum(self.table.log1[p] * s for p, s in zip(points, scalars)
                if p is not None)
        return z_g1_mul(ZG1, k % R)

    def msm_g2(self, points, scalars):
        k = sum(self.table.log2[_g2_key(p)] * s
                for p, s in zip(points, scalars) if p is not None)
        return z_g2_mul(ZG2, k % R)


def build(root) -> dict:
    """-> {"dir": a directory holding only proving.key, "pk_bytes",
    "inputs" (za_tpu's FS), "proof_json" (za_tpu's helper.prove with
    deterministic r, s = RS), "vk_json"}."""
    src = os.path.join(root, "src")
    os.makedirs(src)
    with open(os.path.join(src, "circuit.za"), "w") as f:
        f.write(CIRCUIT)
    ev = ZEvaluator(ZMode.GEN_CONSTRAINTS)
    ev.eval_file(src, "circuit.za")
    cons, removed = z_optimize(ev.constraints, ev.signals.main_input_ids())
    r1cs = ZR1CS.from_constraints(ev.signals, cons, removed)
    assert (r1cs.num_constraints, r1cs.num_vars) == (N, N + 2)
    table = _LoggedFixedBase()
    params = z_generate_parameters(r1cs, **TOXIC, engine=table)
    assert params.domain_size == 32
    pk_dir = os.path.join(root, "pk")
    os.makedirs(pk_dir)
    pk = os.path.join(pk_dir, "proving.key")
    with open(pk, "wb") as f:
        zfmt.write_pk(f, ev.collected_asts, cons, removed, params,
                      densities=r1cs.densities())
    with open(pk, "rb") as f:
        pk_bytes = f.read()
    # za_tpu proves in a copy, so its .wtrace stays out of pk_dir
    ref = os.path.join(root, "ref")
    shutil.copytree(pk_dir, ref)
    inputs = [("main.x", ZFS(INPUT_X))]
    proof_json = zhelper.prove(os.path.join(ref, "proving.key"), inputs,
                               engine=_LogEngine(table), deterministic_rs=RS)
    return {"dir": pk_dir, "ref_dir": ref, "pk_bytes": pk_bytes,
            "proof_json": proof_json,
            "vk_json": zfmt.vk_to_json(params.vk, ["main.x"])}


def port_inputs():
    from za_tpu_torch.algebra import FS

    return [("main.x", FS(INPUT_X))]
