"""Plain versions of the four tree-level kernels (za_tpu_torch.engine.
msm_tree, reached through the cuda_tree wrappers on CPU tensors) against
the reference's msm_tree._select_tables + _affine_level.

The reference pairs adjacent lanes (2i, 2i+1); the port pairs i with
i + n/2 (fold-half, as the reference's Pallas kernels do).  Feeding the
reference rows interleaved as (x[:n/2], x[n/2:]) makes both produce the
same pairs in the same output order.  Values are compared mod q."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import za_tpu.engine.msm_tree as ZMT
import za_tpu.engine.rns as RNS
from za_tpu.curve import G1_GEN as ZG1, G2_GEN as ZG2, g1_mul as z_g1_mul
from za_tpu.curve import g2_mul as z_g2_mul
from za_tpu_torch.curve import Fq2, R
from za_tpu_torch.engine import cuda_tree as CT, field as F
from za_tpu_torch.engine.engine import GpuEngine

CTX = RNS.RQ


def _port_g2(p):
    return None if p is None else (Fq2(p[0].c0, p[0].c1),
                                   Fq2(p[1].c0, p[1].c1))


def _interleave_np(a, axis=-1):
    """(.., n) -> (.., n) with [a[:n/2], a[n/2:]] interleaved."""
    a = np.asarray(a)
    h = a.shape[axis] // 2
    lo, hi = np.split(a, [h], axis=axis)
    st = np.stack([lo, hi], axis=-1 if axis == -1 else axis + 1)
    return st.reshape(a.shape)


def _interleave_jnp(a):
    h = a.shape[-1] // 2
    return jnp.stack([a[..., :h], a[..., h:]], axis=-1).reshape(a.shape)


def _ref_table(tab, is_g2):
    """Port table (8, *E, M, S) l32 Montgomery -> the reference layout
    (8, 35[, 2], M, S) of u16 RNS residues of the same values."""
    src = tab.movedim(0, 2 if is_g2 else 1)          # (*E, 8, M, S)
    vals = _port_decode(src, is_g2)                  # order (8, M, S)
    flat = [v for pair in vals for v in pair] if is_g2 else vals
    res = CTX.ints_to_rns([CTX.to_mont_int(v) for v in flat])
    shape = (2,) if is_g2 else ()
    M, S = tab.shape[-2:]
    res = res.reshape((35, 8, M, S) + shape)
    if is_g2:                                        # (35, 8, M, S, 2)
        res = np.moveaxis(res, -1, 2)                # (35, 8, 2, M, S)
    return np.moveaxis(res, 0, 1).astype(np.uint16)


def _ref_decode(x, is_g2):
    """Reference RNS planes -> list of Fq ints (or (c0, c1) pairs)."""
    x = np.asarray(x)
    if is_g2:
        c = [_ref_decode(x[:, k], False) for k in (0, 1)]
        return list(zip(*c))
    return [CTX.from_mont_int(v) % CTX.modulus
            for v in CTX.rns_to_ints(x.reshape(x.shape[0], -1))]


def _port_decode(x, is_g2):
    if is_g2:
        c = [_port_decode(x[:, k], False) for k in (0, 1)]
        return list(zip(*c))
    return [F.FQ.from_mont_int(v)
            for v in F.l32_to_ints(x.reshape(8, -1).numpy())]


@pytest.mark.parametrize("is_g2", [False, True], ids=["g1", "g2"])
def test_plain_levels_match_reference(is_g2):
    rng = random.Random(41 if is_g2 else 40)
    S, M, W = 16, 2, 64
    if is_g2:
        zpts = [[z_g2_mul(ZG2, rng.randrange(1, R)) for _ in range(S)]
                for _ in range(M)]
        ppts = [[_port_g2(p) for p in q] for q in zpts]
    else:
        zpts = [[z_g1_mul(ZG1, rng.randrange(1, R)) for _ in range(S)]
                for _ in range(M)]
        ppts = zpts
    d = np.array([[[rng.randrange(-8, 9) for _ in range(S)]
                   for _ in range(M)] for _ in range(W)], dtype=np.int8)

    # port: tables and the plain level-0 / level versions
    eng = GpuEngine(device="cpu")
    stage = eng.stage_g2_affine if is_g2 else eng.stage_g1_affine
    tabs = stage(ppts, chunk=S)
    x0, y0, i0 = CT.tree_level0(tabs.tx[0], tabs.ty[0],
                                torch.from_numpy(d), is_g2)
    x1, y1, i1 = CT.tree_level(x0, y0, i0, is_g2)

    # reference: the same tables as RNS residues, columns interleaved
    rtx, rty = (_interleave_np(_ref_table(t, is_g2)) for t in
                (tabs.tx[0], tabs.ty[0]))
    fld = ZMT.Fq2Adapter() if is_g2 else ZMT.FqAdapter()
    plan = ZMT._level_plan(2, is_g2)
    rd = jnp.asarray(_interleave_np(d))
    sx, sy, sinf = ZMT._select_tables(jnp.asarray(rtx), jnp.asarray(rty),
                                      rd, fld)
    rx0, ry0, ri0 = ZMT._affine_level(sx, sy, sinf, fld, *plan[0])
    rx1, ry1, ri1 = ZMT._affine_level(
        _interleave_jnp(rx0), _interleave_jnp(ry0), _interleave_jnp(ri0),
        fld, *plan[1])

    for (px, py, pi), (qx, qy, qi) in (((x0, y0, i0), (rx0, ry0, ri0)),
                                       ((x1, y1, i1), (rx1, ry1, ri1))):
        assert np.array_equal(pi.numpy(), np.asarray(qi))
        assert _port_decode(px, is_g2) == _ref_decode(qx, is_g2)
        assert _port_decode(py, is_g2) == _ref_decode(qy, is_g2)
