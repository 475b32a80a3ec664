"""Staging checks raw pk queries against the curve, as the reference's
stage_params does with curve_check (za_tpu/engine/engine.py,
_assert_g1_on_curve / _assert_g2_on_curve): one point off the curve
(G1) or off the twist (G2) in a raw query makes
GpuEngine(device="cpu").stage_params raise FormatError, on the tree
route and on the dense route, exactly where the reference's
stage_params (TpuEngine(msm_style="rns"), the style that runs its
check) raises on the same arrays, with the same text.  Column by
column, the port's on-curve verdict (engine.ec.on_curve) equals
za_tpu.curve's on the same points.  The same arrays with the point put
back stage on both, and each of their columns passes the port's and
the reference's host curve equations."""

import random

import numpy as np
import pytest
import torch

import za_tpu.curve as ZC
from za_tpu.groth16 import format as ZFMT
from za_tpu.groth16.r1cs import R1CS as ZR1CS
from za_tpu.groth16.setup import (
    Groth16Parameters as ZParams, VerifyingKey as ZVerifyingKey,
)
import za_tpu_torch.engine.engine as engine_mod
from za_tpu_torch.curve import (
    G1_GEN, G2_GEN, Q, R, g1_is_on_curve, g1_mul, g2_is_on_curve,
    g2_mul,
)
from za_tpu_torch.engine import ec
from za_tpu_torch.engine.engine import GpuEngine
from za_tpu_torch.engine.field import ints_to_limbs, limbs_to_ints
from za_tpu_torch.groth16.convert import FormatError, RawG1Query, RawG2Query
from za_tpu_torch.groth16.r1cs import R1CS
from za_tpu_torch.groth16.setup import Groth16Parameters, VerifyingKey

N = 14           # constraints: 16 variables, domain 16, h of 15 points
BAD = 5          # the column made off the curve
G1_QUERIES = ("a", "b_g1", "l", "h")
QUERIES = G1_QUERIES + ("b_g2",)


def _rows(N):
    rows = [[(i + 1, 1)] for i in range(N)]
    return dict(num_inputs=2, num_aux=N, input_names=["main.x"],
                a_rows=rows, b_rows=rows,
                c_rows=[[(i + 2, 1)] for i in range(N)])


@pytest.fixture(scope="module")
def pk():
    """A raw pk of a 14-constraint chain: columns cycle through prime
    pools of 7 G1 and 5 G2 points; column 3 of every query is the
    identity (0 : 1 : 0)."""
    rng = random.Random(6)
    r1cs = R1CS(**_rows(N))
    nv = r1cs.num_vars
    g1 = [g1_mul(G1_GEN, rng.randrange(1, R)) for _ in range(7)]
    g2 = [g2_mul(G2_GEN, rng.randrange(1, R)) for _ in range(5)]

    def g1_query(k):
        pts = [None if j == 3 else g1[j % 7] for j in range(k)]
        return dict(zip("xyz", ec.g1_limb_coords(pts)))

    pts = [None if j == 3 else g2[j % 5] for j in range(nv)]
    arrays = {"a": g1_query(nv), "b_g1": g1_query(nv), "l": g1_query(N),
              "h": g1_query(15),
              "b_g2": dict(zip(("x0", "x1", "y0", "y1", "z0"),
                               ec.g2_limb_coords(pts)))}
    return r1cs, arrays


def _params(arrays):
    vk = VerifyingKey(alpha_g1=G1_GEN, beta_g1=G1_GEN, beta_g2=G2_GEN,
                      gamma_g2=G2_GEN, delta_g1=G1_GEN, delta_g2=G2_GEN,
                      ic=[G1_GEN] * 2)
    q = {k: (RawG2Query if k == "b_g2" else RawG1Query)(
        **{c: a.copy() for c, a in v.items()}) for k, v in arrays.items()}
    return Groth16Parameters(vk=vk, domain_size=16, **q)


def _zparams(arrays):
    """The same arrays as the reference's raw queries and parameters."""
    vk = ZVerifyingKey(alpha_g1=ZC.G1_GEN, beta_g1=ZC.G1_GEN,
                       beta_g2=ZC.G2_GEN, gamma_g2=ZC.G2_GEN,
                       delta_g1=ZC.G1_GEN, delta_g2=ZC.G2_GEN,
                       ic=[ZC.G1_GEN] * 2)
    q = {k: (ZFMT.RawG2Query if k == "b_g2" else ZFMT.RawG1Query)(
        **{c: a.copy() for c, a in v.items()}) for k, v in arrays.items()}
    return ZParams(vk=vk, domain_size=16, **q)


def _shift_y(arrays, query, delta):
    """A copy with y (G1) or y.c0 (G2) of column BAD plus delta."""
    out = {k: dict(v) for k, v in arrays.items()}
    key = "y0" if query == "b_g2" else "y"
    y = out[query][key].copy()
    v = limbs_to_ints(y[:, BAD:BAD + 1])[0]
    y[:, BAD] = ints_to_limbs([(v + delta) % Q])[:, 0]
    out[query][key] = y
    return out


def _stage(r1cs, arrays, route, monkeypatch):
    if route == "tree":
        monkeypatch.setattr(engine_mod, "TREE_MIN", 0)
    staged = GpuEngine(device="cpu").stage_params(_params(arrays), r1cs)
    assert ("g1abl" in staged) == (route == "tree")
    return staged


@pytest.fixture(scope="module")
def ref(pk):
    """The reference's stage_params on the same raw arrays: pk with the
    given queries' column BAD shifted -> its FormatError text, or None
    when it stages.  One engine, so each shape compiles once."""
    from za_tpu.engine.engine import TpuEngine

    r1cs, arrays = pk
    eng, zr1cs, seen = TpuEngine(msm_style="rns"), ZR1CS(**_rows(N)), {}

    def refusal(shifted=()):
        if shifted not in seen:
            bad = arrays
            for q in shifted:
                bad = _shift_y(bad, q, 1)
            try:
                eng.stage_params(_zparams(bad), zr1cs)
                seen[shifted] = None
            except ZFMT.FormatError as exc:
                seen[shifted] = str(exc)
        return seen[shifted]

    return refusal


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("route", ["tree", "dense"])
@pytest.mark.parametrize("query", QUERIES)
def test_off_curve_raw_point_is_refused(pk, ref, query, route,
                                        monkeypatch):
    r1cs, arrays = pk
    g = "g2" if query == "b_g2" else "g1"
    with pytest.raises(FormatError,
                       match=f"^pk {g} query point not on curve$") as exc:
        _stage(r1cs, _shift_y(arrays, query, 1), route, monkeypatch)
    assert ref((query,)) == str(exc.value)
    assert ref() is None


@pytest.mark.parametrize("shift", [0, 1])
@pytest.mark.parametrize("query", QUERIES)
def test_on_curve_columns_match_reference(pk, query, shift):
    """ec.on_curve's verdict on every column of a query, before and
    after column BAD is shifted, equals za_tpu.curve's on the reference
    raw query's points; only the shifted column is off the curve."""
    _, arrays = pk
    arrs = _shift_y(arrays, query, shift)[query]
    mont = GpuEngine(device="cpu")._mont
    if query == "b_g2":
        pts = [mont(np.stack([arrs[c + "0"], arrs[c + "1"]], axis=1))
               for c in "xy"]
        pts.append(mont(np.stack([arrs["z0"], np.zeros_like(arrs["z0"])],
                                 axis=1)))
        want = [ZC.g2_is_on_curve(p)
                for p in ZFMT.RawG2Query(**arrs).to_points()]
    else:
        pts = [mont(arrs[c]) for c in "xyz"]
        want = [ZC.g1_is_on_curve(p)
                for p in ZFMT.RawG1Query(**arrs).to_points()]
    got = ec.on_curve(*pts, query == "b_g2").tolist()
    assert got == want
    assert got == [not (shift and j == BAD) for j in range(len(want))]


@pytest.mark.parametrize("route", ["tree", "dense"])
def test_corrected_raw_pk_stages(pk, ref, route, monkeypatch):
    """Off-curve points in a and b_g2 are refused, by the port and the
    reference alike; put back, the same arrays stage, and every column
    is on the curve by both host equations (column 3 the identity
    (0 : 1 : 0))."""
    r1cs, arrays = pk
    bad = _shift_y(_shift_y(arrays, "a", 1), "b_g2", 1)
    with pytest.raises(FormatError) as exc:
        _stage(r1cs, bad, route, monkeypatch)
    assert ref(("a", "b_g2")) == str(exc.value)
    back = _shift_y(_shift_y(bad, "a", -1), "b_g2", -1)
    for q in arrays:
        for c in arrays[q]:
            assert np.array_equal(back[q][c], arrays[q][c])
    _stage(r1cs, back, route, monkeypatch)
    assert ref() is None
    params, zparams = _params(back), _zparams(back)
    for q in G1_QUERIES:
        pts = getattr(params, q).to_points()
        assert pts == getattr(zparams, q).to_points()
        for j, p in enumerate(pts):
            assert (p is None) == (j == 3)
            assert g1_is_on_curve(p) and ZC.g1_is_on_curve(p)
    zpts = zparams.b_g2.to_points()
    for j, p in enumerate(params.b_g2.to_points()):
        assert (p is None) == (j == 3) == (zpts[j] is None)
        assert g2_is_on_curve(p) and ZC.g2_is_on_curve(zpts[j])
