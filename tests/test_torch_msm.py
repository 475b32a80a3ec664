"""The whole plain tree MSM of the port (za_tpu_torch.engine.cuda_tree
on CPU tensors: plain levels, chunk carry, lane fold, Horner) against
the reference's msm_tree.msm_affine_tree and host curve arithmetic."""

import random

import jax.numpy as jnp
import numpy as np
import pytest

import za_tpu.engine.ec as ZEC
import za_tpu.engine.field as ZF
import za_tpu.engine.msm_tree as ZMT
from za_tpu.curve import G1_GEN as ZG1, G2_GEN as ZG2, g1_mul as z_g1_mul
from za_tpu.curve import g2_mul as z_g2_mul
from za_tpu_torch.curve import (
    G1_GEN, Fq2, R, g1_add, g1_mul, g2_add, g2_mul,
)
from za_tpu_torch.engine import cuda_tree as CT, ec
from za_tpu_torch.engine.engine import GpuEngine


def _port_g2(p):
    return None if p is None else (Fq2(p[0].c0, p[0].c1),
                                   Fq2(p[1].c0, p[1].c1))


def _host_msm(points, scalars, add, mul):
    acc = None
    for p, s in zip(points, scalars):
        if p is not None and s % R:
            acc = add(acc, mul(p, s))
    return acc


@pytest.mark.parametrize("is_g2,n,chunk", [(False, 96, 32), (True, 64, 32)],
                         ids=["g1", "g2"])
def test_tree_msm_matches_reference_and_host(is_g2, n, chunk, monkeypatch):
    """Whole plain tree MSM (levels down to 8 partials per window, chunk
    carry, lane fold, Horner) with interior identity columns that carry
    live scalars, and a zero scalar.  The tail is narrowed from 128 so
    that chunks this small still run level 0 and a generic level."""
    monkeypatch.setattr(CT, "TAIL", 8)
    rng = random.Random(43 if is_g2 else 42)
    if is_g2:
        zpts = [z_g2_mul(ZG2, rng.randrange(1, R)) for _ in range(n)]
    else:
        zpts = [z_g1_mul(ZG1, rng.randrange(1, R)) for _ in range(n)]
    for i in (0, 5, 33):
        zpts[i] = None
    scalars = [rng.randrange(1, R) for _ in range(n)]
    scalars[7] = 0
    ppts = [_port_g2(p) for p in zpts] if is_g2 else zpts

    eng = GpuEngine(device="cpu")
    tabs = (eng.stage_g2_affine if is_g2 else eng.stage_g1_affine)(
        [ppts], chunk=chunk)
    X, Y, Z = CT.msm_tree(tabs, eng._scalars(tabs, [scalars]))
    got = (ec.g2_points_from_device if is_g2 else ec.g1_points_from_device)(
        X, Y, Z)[0]

    to_rns = ZEC.g2_points_to_rns if is_g2 else ZEC.g1_points_to_rns
    staged = to_rns(zpts)
    staged = tuple(s[:, :, None] if is_g2 else s[:, None] for s in staged)
    rtabs = ZMT.stage_affine_tables(staged, is_g2=is_g2, n=n, chunk=chunk)
    ops = ZEC.make_g2_ops_rns() if is_g2 else ZEC.make_g1_ops_rns()
    sc = jnp.asarray(ZF.ints_to_limbs(scalars))[:, None, :]
    RX, RY, RZ = (np.asarray(c) for c in ZMT.msm_affine_tree(rtabs, sc, ops))
    if is_g2:
        ref = _port_g2(ZEC.g2_point_from_rns(RX[:, :, 0], RY[:, :, 0],
                                             RZ[:, :, 0]))
        host = _host_msm(ppts, scalars, g2_add, g2_mul)
    else:
        ref = ZEC.g1_point_from_rns(RX[:, 0], RY[:, 0], RZ[:, 0])
        host = _host_msm(ppts, scalars, g1_add, g1_mul)
    assert got == ref == host


def test_chunk_loop_select_only_path():
    """Chunks no wider than the tail skip the level kernels: selection
    straight into the projective tail (two queries, two chunks)."""
    rng = random.Random(44)
    n = 16
    pts = [[g1_mul(G1_GEN, rng.randrange(1, R)) for _ in range(n)]
           for _ in range(2)]
    scal = [[rng.randrange(R) for _ in range(n)] for _ in range(2)]
    eng = GpuEngine(device="cpu")
    tabs = eng.stage_g1_affine(pts, chunk=8)
    X, Y, Z = CT.msm_tree(tabs, eng._scalars(tabs, scal))
    got = ec.g1_points_from_device(X, Y, Z)
    assert got == [_host_msm(p, s, g1_add, g1_mul) for p, s in zip(pts, scal)]


def test_tree_window_sums_three_chunks_match_reference(monkeypatch):
    """Three chunks (n = 96, chunk 32) through the port's window sums
    (levels down to 8 partials into the stacked buffer, the carry's
    fold-half over the chunks, the lane fold) and the reference's
    tree_window_sums (its scan over the chunks): the same 64 window
    sums mod p, an identity point and a zero scalar among them."""
    monkeypatch.setattr(CT, "TAIL", 8)
    rng = random.Random(45)
    n, chunk = 96, 32
    zpts = [z_g1_mul(ZG1, rng.randrange(1, R)) for _ in range(n)]
    zpts[40] = None
    scalars = [rng.randrange(1, R) for _ in range(n)]
    scalars[70] = 0
    eng = GpuEngine(device="cpu")
    tabs = eng.stage_g1_affine([zpts], chunk=chunk)
    assert tabs.chunks == 3
    X, Y, Z = CT.tree_window_sums(tabs, eng._scalars(tabs, [scalars]))
    got = ec.g1_points_from_device(*(c.reshape(8, -1) for c in (X, Y, Z)))

    staged = tuple(s[:, None] for s in ZEC.g1_points_to_rns(zpts))
    rtabs = ZMT.stage_affine_tables(staged, is_g2=False, n=n, chunk=chunk)
    sc = jnp.asarray(ZF.ints_to_limbs(scalars))[:, None, :]
    RX, RY, RZ = (np.asarray(c) for c in ZMT.tree_window_sums(
        rtabs, sc, ZEC.make_g1_ops_rns()))
    ref = [ZEC.g1_point_from_rns(RX[:, w, 0], RY[:, w, 0], RZ[:, w, 0])
           for w in range(RX.shape[1])]
    assert len(got) == 64 and got == ref
