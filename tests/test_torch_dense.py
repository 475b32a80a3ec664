"""The port's dense MSM (za_tpu_torch.engine.msm_dense on CPU tensors:
the plain window sums, lane fold and Horner) against the reference's
dense MSMs and host curve arithmetic, with zero tolerance.

Per-lane window sums are compared before the lane fold, at the same
lane count L, as affine values mod q: the reference folds lanes by
roll-and-add and the port by fold-half, so only whole MSMs are compared
after the fold.  The reference runs with its RNS field ops where it can
(signed radix 16) and its limb Pallas kernel in interpret mode (radix 4,
G1); an interpreted G2 radix-4 kernel compiles for ~40 s here, so the
G2 radix-4 sums are held against za_tpu's host curve arithmetic."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import za_tpu.engine.ec as ZEC
import za_tpu.engine.field as ZF
import za_tpu.engine.msm as ZMSM
import za_tpu.engine.rns as RNS
from za_tpu.curve import (
    G1_GEN as ZG1, G2_GEN as ZG2, g1_add as z_g1_add, g1_mul as z_g1_mul,
    g2_add as z_g2_add, g2_mul as z_g2_mul,
)
from za_tpu.engine import pallas_msm as ZPM, pallas_msm_rns as ZPMR
from za_tpu_torch.curve import Fq2, Q, R
from za_tpu_torch.curve import g1_add as port_g1_add, g2_add as port_g2_add
from za_tpu_torch.engine import ec, msm_dense as MD
from za_tpu_torch.engine.engine import GpuEngine
from za_tpu_torch.groth16 import HostEngine


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_g2(p):
    return None if p is None else (Fq2(p[0].c0, p[0].c1),
                                   Fq2(p[1].c0, p[1].c1))


def _queries(rng, is_g2, M, n):
    """M queries of n za_tpu points (one identity each) and M scalar
    vectors with the edge values 0, 1 and r - 1."""
    mul, gen = (z_g2_mul, ZG2) if is_g2 else (z_g1_mul, ZG1)
    pts = [[mul(gen, rng.randrange(1, R)) for _ in range(n)]
           for _ in range(M)]
    scs = [[rng.randrange(R) for _ in range(n)] for _ in range(M)]
    for q, s in zip(pts, scs):
        q[3] = None
        s[:3] = [0, 1, R - 1]
    return pts, scs


def _affine(xs, ys, zs, is_g2):
    """Projective value lists mod q -> affine points (None at Z = 0)."""
    out = []
    for x, y, z in zip(xs, ys, zs):
        if is_g2:
            x, y, z = (Fq2(*v) for v in (x, y, z))
            if z.is_zero():
                out.append(None)
                continue
            zi = z.inv()
            out.append((x * zi, y * zi))
        elif z % Q == 0:
            out.append(None)
        else:
            zi = pow(z, -1, Q)
            out.append((x * zi % Q, y * zi % Q))
    return out


def _rns_values(c, is_g2):
    """Reference RNS leaves (35[, 2], W, M, L) -> values in (M, W, L)
    order (pairs for G2)."""
    c = np.asarray(c)

    def vals(a):  # (35, W, M, L)
        a = a.transpose(0, 2, 1, 3).reshape(RNS.N_CH, -1)
        return [RNS.RQ.from_mont_int(v) % Q for v in RNS.RQ.rns_to_ints(a)]

    if is_g2:
        return list(zip(vals(c[:, 0]), vals(c[:, 1])))
    return vals(c)


def _limb_values(c):
    """Reference limb leaves (16, W, M, L) -> values in (M, W, L) order."""
    a = np.asarray(c).transpose(0, 2, 1, 3).reshape(ZF.NLIMBS, -1)
    return [ZF.FQ.from_mont_int(v) % Q for v in ZF.limbs_to_ints(a)]


def _port_sums(sums, is_g2):
    """Port per-lane sums (*E, M, W, L) -> affine points, (M, W, L)
    order."""
    lead = (8, 2) if is_g2 else (8,)
    flat = (c.reshape(lead + (-1,)) for c in sums)
    return (ec.g2_points_from_device if is_g2
            else ec.g1_points_from_device)(*flat)


def _port_tables(pts, is_g2, style):
    eng = GpuEngine(device="cpu", msm_style=style)
    q = [[_port_g2(p) for p in qq] for qq in pts] if is_g2 else pts
    return eng, (eng.stage_g2_stacked if is_g2 else eng.stage_g1_stacked)(q)


@pytest.mark.parametrize("is_g2", [False, True], ids=["g1", "g2"])
def test_signed_window_sums_match_reference(is_g2):
    """(a) Per-lane signed radix-16 sums against the reference's
    msm.signed_window_sums (XLA, RNS field ops) at the same L."""
    rng = random.Random(60 + is_g2)
    M, n, L = 2, 16, 4
    pts, scs = _queries(rng, is_g2, M, n)
    eng, tabs = _port_tables(pts, is_g2, None)
    sc = eng._scalars(tabs, scs)
    got = _port_sums(MD.dense_window_sums(tabs, MD.digits(sc, 16), L), is_g2)

    if is_g2:
        rp = [ZEC.g2_points_to_rns(q) for q in pts]
        points = tuple(jnp.stack([p[i] for p in rp], axis=2) for i in range(3))
        ops = ZEC.make_g2_ops_rns()
    else:
        rp = [ZEC.g1_points_to_rns(q) for q in pts]
        points = tuple(jnp.stack([p[i] for p in rp], axis=1) for i in range(3))
        ops = ZEC.make_g1_ops_rns()
    rsc = jnp.stack([jnp.asarray(ZF.ints_to_limbs(s)) for s in scs], axis=1)
    ref = ZMSM.signed_window_sums(points, rsc, ops, 4, L)
    want = _affine(*(_rns_values(c, is_g2) for c in ref), is_g2)
    assert len(got) == M * 64 * L
    assert got == want


@pytest.mark.parametrize("is_g2", [False, True], ids=["g1", "g2"])
def test_segmented_sums_match_reference(is_g2):
    """(a) with segments: the port's plain sums at (L, S) = (2, 2) and
    (1, 4) against the reference's msm.signed_window_sums at S L = 4
    lanes (the shapes of the test above, so its compile is reused), lane
    l + s L of each window summed over s on the host, as affine values."""
    rng = random.Random(70 + is_g2)
    M, n, P = 2, 16, 4
    pts, scs = _queries(rng, is_g2, M, n)
    eng, tabs = _port_tables(pts, is_g2, None)
    d = MD.digits(eng._scalars(tabs, scs), 16)
    if is_g2:
        rp = [ZEC.g2_points_to_rns(q) for q in pts]
        points = tuple(jnp.stack([p[i] for p in rp], axis=2) for i in range(3))
        ops = ZEC.make_g2_ops_rns()
    else:
        rp = [ZEC.g1_points_to_rns(q) for q in pts]
        points = tuple(jnp.stack([p[i] for p in rp], axis=1) for i in range(3))
        ops = ZEC.make_g1_ops_rns()
    rsc = jnp.stack([jnp.asarray(ZF.ints_to_limbs(s)) for s in scs], axis=1)
    ref = ZMSM.signed_window_sums(points, rsc, ops, 4, P)
    lanes = _affine(*(_rns_values(c, is_g2) for c in ref), is_g2)
    add = port_g2_add if is_g2 else port_g1_add
    for L in (2, 1):
        S = P // L
        got = _port_sums(MD.dense_window_sums(tabs, d, L, S), is_g2)
        want = []
        for row in range(M * 64):       # (m, w) rows of P lanes each
            for j in range(L):
                acc = None
                for s in range(S):
                    acc = add(acc, lanes[row * P + j + s * L])
                want.append(acc)
        assert got == want


def test_signed_msm_matches_pallas_reference():
    """(b) One whole G1 MSM against the reference's fused Pallas kernel
    (interpret mode) at the size of its own test, and the host."""
    rng = random.Random(7)
    n = 64
    pts = [z_g1_mul(ZG1, rng.randrange(1, R)) for _ in range(n)]
    scs = [rng.randrange(R) for _ in range(n)]
    got = GpuEngine(device="cpu").msm_g1(pts, scs)

    staged = ZEC.g1_points_to_rns(pts)
    points = tuple(x[:, None] for x in staged)
    rsc = jnp.asarray(ZF.ints_to_limbs(scs))[:, None]
    X, Y, Z = ZPMR.msm_signed_dense_pallas(
        points, rsc, ZEC.make_g1_ops_rns(), lanes=64, interpret=True)
    want = ZEC.g1_point_from_rns(np.asarray(X), np.asarray(Y), np.asarray(Z))
    assert got == want == HostEngine().msm_g1(pts, scs)


def test_radix4_window_sums_match_pallas_reference():
    """(c) Per-lane radix-4 G1 sums against the reference's
    pallas_msm.dense_msm_window_sums (limb kernel, interpret mode)."""
    rng = random.Random(62)
    M, n, L = 1, 8, 8
    pts, scs = _queries(rng, False, M, n)
    eng, tabs = _port_tables(pts, False, "fused")
    sc = eng._scalars(tabs, scs)
    got = _port_sums(MD.dense_window_sums(tabs, MD.digits(sc, 4), L), False)

    points = tuple(jnp.asarray(c)[:, None]
                   for c in ZEC.g1_points_to_device(pts[0]))
    rsc = jnp.asarray(ZF.ints_to_limbs(scs[0]))[:, None]
    ref = ZPM.dense_msm_window_sums(points, rsc, ZEC.G1_OPS, False,
                                    lanes=L, interpret=True)
    want = _affine(*(_limb_values(c) for c in ref), False)
    assert len(got) == M * 127 * L
    assert got == want


def test_radix4_window_sums_g2_match_host():
    """(c) Per-lane radix-4 G2 sums against za_tpu's host arithmetic:
    S[w, l] = sum over points i = l mod L of digit_w(s_i) * P_i."""
    rng = random.Random(63)
    M, n, L = 1, 8, 4
    pts, scs = _queries(rng, True, M, n)
    eng, tabs = _port_tables(pts, True, "fused")
    sc = eng._scalars(tabs, scs)
    got = _port_sums(MD.dense_window_sums(tabs, MD.digits(sc, 4), L), True)
    want = []
    for w in range(127):
        for lane in range(L):
            acc = None
            for i in range(lane, n, L):
                d = (scs[0][i] >> (2 * w)) & 3
                if d and pts[0][i] is not None:
                    acc = z_g2_add(acc, z_g2_mul(pts[0][i], d))
            want.append(_port_g2(acc))
    assert got == want


@pytest.mark.parametrize("style", [None, "fused"], ids=["radix16", "radix4"])
@pytest.mark.parametrize("is_g2", [False, True], ids=["g1", "g2"])
def test_engine_msm_on_host_lists(is_g2, style):
    """(d) GpuEngine.msm_g1 / msm_g2 on host point lists against
    za_tpu's host arithmetic: identity points, edge scalars, n = 13 (not
    a multiple of the 8 lanes)."""
    rng = random.Random(64 + 2 * is_g2 + (style is None))
    n = 13
    mul, add, gen = ((z_g2_mul, z_g2_add, ZG2) if is_g2
                     else (z_g1_mul, z_g1_add, ZG1))
    pts = [mul(gen, rng.randrange(1, R)) for _ in range(n)]
    pts[5] = None
    scs = [rng.randrange(R) for _ in range(n)]
    scs[:4] = [0, 1, R - 1, 2]
    want = None
    for p, s in zip(pts, scs):
        if p is not None and s:
            want = add(want, mul(p, s))
    eng = GpuEngine(device="cpu", msm_style=style)
    assert MD.lanes(1, n, eng.radix, is_g2, MD.CPU_SLOTS[is_g2]) == (8, 1)
    if is_g2:
        assert eng.msm_g2([_port_g2(p) for p in pts], scs) == _port_g2(want)
    else:
        assert eng.msm_g1(pts, scs) == want


def test_lanes_fill_the_card():
    """(L, S) from (M, radix) at the 2^13 rung on an H100 (132 SMs) at
    the kernels' resident blocks (3 an SM in G1, 2 in G2): g1x4 at 512
    one-segment lanes, b2 at 128 lanes of 4 segments."""
    g1, g2 = 132 * 3, 132 * 2
    assert MD.lanes(4, 1 << 14, 16, False, g1) == (512, 1)
    assert MD.lanes(1, 1 << 14, 16, True, g2) == (128, 4)
    assert MD.lanes(4, 1 << 14, 4, False, g1) == (256, 1)
    assert MD.lanes(1, 1 << 14, 4, True, g2) == (128, 2)
    assert MD.lanes(4, 8, 16, False, g1) == (8, 1)
    assert (MD.lanes(4, 1 << 14, 16, False, MD.CPU_SLOTS[False]),
            MD.lanes(1, 1 << 14, 16, True, MD.CPU_SLOTS[True])) == (
        (512, 1), (128, 4))
    with pytest.raises(ValueError, match="not ported"):
        GpuEngine(device="cpu", msm_style="grouped")
