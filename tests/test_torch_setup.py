"""The trusted setup on the port's engine, on the CPU, against za_tpu's
with zero tolerance (points compared normalized, values mod p).

* The plain fixed-base table and MSM (engine/fixed_base.py) at c = 4
  against za_tpu.engine.msm.fixed_base_table and fixed_base_msm, jitted
  as tests/test_engine.py's fixed-base test runs them; the G2 case is
  slow, as the reference's own fixed-base tests are.
* The table and MSM at c = 8 against za_tpu.curve.g1_mul / g2_mul on
  edge scalars (0, 1, 2, R - 1, 2^253 + 1, zero windows) and random
  ones; the digits at every window width against plain bit extraction
  and the reference's digits_from_limbs.
* GpuEngine(device="cpu").fixed_base_g1/g2 against za_tpu's host batch.
* generate_parameters with GpuEngine(device="cpu"), and without an
  engine, against za_tpu's host setup, field by field, and the
  density-filtered Parameters bytes of both writers.
"""

import io
import random

import jax
import numpy as np
import pytest
import torch

import za_tpu.engine.ec as ZEC
import za_tpu.engine.field as ZF
import za_tpu.engine.msm as ZMSM
from za_tpu.compiler import Evaluator as ZEvaluator, Mode as ZMode
from za_tpu.compiler import optimize as z_optimize
from za_tpu.compiler.evaluator import Scope as ZScope
from za_tpu.curve import (
    G1_GEN as ZG1, G2_GEN as ZG2, R, g1_mul as z_g1_mul, g2_mul as z_g2_mul,
)
from za_tpu.groth16 import format as zfmt
from za_tpu.groth16.r1cs import R1CS as ZR1CS
from za_tpu.groth16.setup import generate_parameters as z_generate_parameters
from za_tpu_torch.compiler import Evaluator, Mode, optimize
from za_tpu_torch.compiler.evaluator import Scope
from za_tpu_torch.curve import G1_GEN, G2_GEN
from za_tpu_torch.engine import ec, field as F, fixed_base as FB
from za_tpu_torch.engine.engine import GpuEngine
from za_tpu_torch.groth16 import format as fmt
from za_tpu_torch.groth16.r1cs import R1CS
from za_tpu_torch.groth16.setup import generate_parameters

from test_torch_frontend import CHAIN
from test_torch_prove import TOXIC, _one_thread  # noqa: F401 -- autouse

# scalars with every edge of the digits: zero, one, the top of Fr, the
# top window's bits (248-253), a scalar with most windows zero
EDGE = [0, 1, 2, R - 1, (1 << 253) + 1, (5 << 200) | 7, 1 << 248]


def _pt(p):
    """A host point of either package -> plain ints (None = infinity)."""
    if p is None or isinstance(p[0], int):
        return p
    return (p[0].c0, p[0].c1, p[1].c0, p[1].c1)


def _limbs(scalars) -> torch.Tensor:
    return torch.from_numpy(F.ints_to_limbs(scalars).astype(np.int32))


def _port_points(pts, is_g2):
    get = ec.g2_points_from_device if is_g2 else ec.g1_points_from_device
    return [_pt(p) for p in get(*pts)]


def _ref_points(pts, is_g2, lead=()):
    """za_tpu projective limb arrays, (16, *lead, n) leaves (lead
    indexed first in the table's (W, 16, B)) -> plain ints."""
    get = ZEC.g2_point_from_device if is_g2 else ZEC.g1_point_from_device
    leaves = jax.tree_util.tree_leaves(pts)
    arrs = [np.asarray(a) for a in leaves]
    out = []
    for idx in np.ndindex(*lead):
        cols = [a[idx] for a in arrs]
        for j in range(cols[0].shape[-1]):
            c = [x[:, j] for x in cols]
            p = (((c[0], c[1]), (c[2], c[3]), (c[4], c[5])) if is_g2
                 else tuple(c))
            out.append(_pt(get(*p)))
    return out


@pytest.mark.parametrize("is_g2", [
    False, pytest.param(True, marks=pytest.mark.slow)], ids=["g1", "g2"])
def test_plain_fixed_base_matches_reference(is_g2):
    """c = 4: every table entry and the MSM of edge and random scalars,
    normalized, equal the reference's (which adds the identity where
    the port copies or skips: the points agree, not the coordinates)."""
    c = 4
    ops = ZEC.G2_OPS if is_g2 else ZEC.G1_OPS
    zbase = (ZEC.g2_points_to_device([ZG2]) if is_g2
             else ZEC.g1_points_to_device([ZG1]))
    ztab = jax.jit(lambda b: ZMSM.fixed_base_table(b, ops, c))(zbase)
    scs = EDGE + [random.Random(3).randrange(R) for _ in range(3)]
    zout = jax.jit(lambda t, s: ZMSM.fixed_base_msm(t, s, ops, c))(
        ztab, ZF.ints_to_limbs(scs))

    base = ec.points_to_device([G2_GEN if is_g2 else G1_GEN], is_g2)
    tab = FB.fixed_base_table(base, c, is_g2)
    W = FB.windows(c)
    assert W == 64 and tab[0].shape[-1] == W << c
    assert _port_points(tab, is_g2) == _ref_points(ztab, is_g2, (W,))
    out = FB.fixed_base_msm(tab, _limbs(scs), c, is_g2)
    assert _port_points(out, is_g2) == _ref_points(zout, is_g2)


@pytest.fixture(scope="module")
def engine():
    """One CPU engine for the module: its c = 8 tables are built once."""
    return GpuEngine(device="cpu")


def _tables(engine, is_g2):
    (engine.fixed_base_g2 if is_g2 else engine.fixed_base_g1)([1])
    return engine._fb_tables[(is_g2, 8)]


@pytest.mark.parametrize("is_g2", [False, True], ids=["g1", "g2"])
def test_fixed_base_c8_matches_scalar_mul(engine, is_g2):
    """The engine's c = 8 table (32 x 256 entries) and the plain MSM on
    edge and random scalars equal za_tpu's scalar multiplication; Z is 0
    exactly for the scalar 0."""
    tab = _tables(engine, is_g2)
    assert tab[0].shape == ((8, 2) if is_g2 else (8,)) + (32 << 8,)
    scs = EDGE + [random.Random(4).randrange(R) for _ in range(4)]
    X, Y, Z = FB.fixed_base_msm(tab, _limbs(scs), 8, is_g2)
    mul, gen = (z_g2_mul, ZG2) if is_g2 else (z_g1_mul, ZG1)
    assert _port_points((X, Y, Z), is_g2) == [_pt(mul(gen, s)) for s in scs]
    zero = (Z == 0).flatten(0, -2).all(0)
    assert zero.tolist() == [s == 0 for s in scs]
    # entry w 2^8 + d is d 2^(8 w) G; d = 0 is the identity
    for w, d in ((0, 1), (0, 255), (5, 17), (31, 63), (31, 0)):
        e = w * 256 + d
        got = _port_points(tuple(t[..., e:e + 1] for t in tab), is_g2)
        assert got == [_pt(mul(gen, d << (8 * w)) if d else None)]


@pytest.mark.parametrize("c", [1, 3, 4, 5, 8, 13, 16])
def test_digits_cross_limbs(c):
    """Each window's unsigned digit, also where it spans two 16-bit
    limbs, against the scalar's bits and za_tpu's digits_from_limbs."""
    scs = EDGE + [random.Random(c).randrange(R) for _ in range(5)]
    got = FB.digits(_limbs(scs), c)
    W = FB.windows(c)
    assert got.shape == (W, len(scs)) and W * c >= 254 > (W - 1) * c
    want = [[(s >> (c * w)) & ((1 << c) - 1) for s in scs] for w in range(W)]
    assert got.tolist() == want
    with jax.disable_jit():
        ref = ZMSM.digits_from_limbs(ZF.ints_to_limbs(scs), c)
    assert np.asarray(ref).tolist() == want


def test_fixed_base_wrappers_check_arguments(engine):
    tab = _tables(engine, False)
    base = ec.points_to_device([G1_GEN], False)
    for c in (0, 17):
        with pytest.raises(ValueError, match="window"):
            FB.fixed_base_table(base, c, False)
    with pytest.raises(ValueError, match="base point"):
        FB.fixed_base_table(tuple(x.repeat(1, 2) for x in base), 8, False)
    with pytest.raises(ValueError, match="table"):
        FB.fixed_base_msm(tab, _limbs([1]), 7, False)   # a c = 8 table
    with pytest.raises(ValueError, match="table"):
        FB.fixed_base_msm(tab, _limbs([1]), 8, True)    # a G1 table
    for bad in (_limbs([1]).long(), _limbs([1])[:8]):
        with pytest.raises(ValueError, match="scalars"):
            FB.fixed_base_msm(tab, bad, 8, False)


@pytest.mark.parametrize("is_g2", [False, True], ids=["g1", "g2"])
def test_engine_fixed_base_matches_host_batch(engine, is_g2):
    """GpuEngine(device="cpu").fixed_base_g1/g2 against za_tpu's host
    batch (s mod R, then the scalar multiplication): scalars past R and
    negative ones reduce, multiples of R give None."""
    rng = random.Random(5 + is_g2)
    scs = EDGE + [R, R + 3, -2, 7 * R] + [rng.randrange(R)
                                         for _ in range(6)]
    fn = engine.fixed_base_g2 if is_g2 else engine.fixed_base_g1
    got = [_pt(p) for p in fn(scs)]
    mul, gen = (z_g2_mul, ZG2) if is_g2 else (z_g1_mul, ZG1)
    assert got == [_pt(mul(gen, s % R)) for s in scs]
    info = engine.fixed_base_info
    assert info["n"] == len(scs) and info["table_s"] < 1.0   # kept
    assert fn([]) == []


MUL = """
template t() {
    signal private input a;
    signal private input b;
    signal output c;
    c <== a * b;
}
component main = t();
"""


def _r1cs(evaluator, mode, scope, optimizer, r1cs_cls, text):
    ev = evaluator(mode.GEN_CONSTRAINTS)
    ev.eval_inline(scope(True, None, "root"), text)
    cons, removed = optimizer(ev.constraints, ev.signals.main_input_ids())
    return r1cs_cls.from_constraints(ev.signals, cons, removed)


def _params(p):
    vk = p.vk
    return ([_pt(q) for q in (vk.alpha_g1, vk.beta_g1, vk.beta_g2,
                              vk.gamma_g2, vk.delta_g1, vk.delta_g2)],
            [_pt(q) for q in vk.ic], p.domain_size,
            {k: [_pt(q) for q in getattr(p, k)]
             for k in ("h", "l", "a", "b_g1", "b_g2")})


@pytest.mark.parametrize("text", [MUL, CHAIN % 30], ids=["mul", "chain30"])
def test_generate_parameters_matches_reference(engine, text):
    """The port's setup on its CPU engine and on the host equals
    za_tpu's host setup with the same toxic waste, field by field
    (infinity where u_i(tau) = 0), and both packages write the same
    density-filtered Parameters bytes."""
    zr1cs = _r1cs(ZEvaluator, ZMode, ZScope, z_optimize, ZR1CS, text)
    r1cs = _r1cs(Evaluator, Mode, Scope, optimize, R1CS, text)
    want = z_generate_parameters(zr1cs, **TOXIC)
    t = {}
    on_engine = generate_parameters(r1cs, **TOXIC, engine=engine,
                                    timings=t)
    on_host = generate_parameters(r1cs, **TOXIC)
    assert _params(on_engine) == _params(on_host) == _params(want)
    # the steps' seconds, each batch in the reference's order with the
    # engine's split
    sizes = [len(on_engine.vk.ic), len(on_engine.l), len(on_engine.a),
             len(on_engine.b_g1), len(on_engine.h), len(on_engine.b_g2),
             3, 3]
    assert list(t["batches"]) == ["ic", "l", "a", "b_g1", "h", "b_g2",
                                  "vk_g1", "vk_g2"]
    assert [b["n"] for b in t["batches"].values()] == sizes
    assert t["qap_evals_s"] >= 0 and t["scalars_s"] >= 0
    # infinity for the variables outside A (b in the product)
    assert (None in on_engine.a) == (text == MUL)
    zbuf, buf = io.BytesIO(), io.BytesIO()
    zfmt.write_parameters(zbuf, want, densities=zr1cs.densities())
    fmt.write_parameters(buf, on_engine, densities=r1cs.densities())
    assert buf.getvalue() == zbuf.getvalue()
