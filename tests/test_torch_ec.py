"""za_tpu_torch.engine.ec / msm (plain versions of csrc/ec.cu) against
the reference's RNS group law, its signed digits, and host curve
arithmetic.  Points are compared normalized to affine."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import za_tpu.engine.ec as ZEC
import za_tpu.engine.field as ZF
import za_tpu.engine.msm as ZMSM
from za_tpu.curve import (
    G1_GEN as ZG1, G2_GEN as ZG2, g1_add as z_g1_add, g1_mul as z_g1_mul,
    g2_add as z_g2_add, g2_mul as z_g2_mul,
)
from za_tpu_torch.curve import Fq2, Q, R
from za_tpu_torch.engine import ec, msm


def _port_g2(p):
    """za_tpu.curve G2 point -> the port's own Fq2 type."""
    if p is None:
        return None
    return (Fq2(p[0].c0, p[0].c1), Fq2(p[1].c0, p[1].c1))


def _pairs(mul, gen, add, rng):
    pts = [mul(gen, rng.randrange(1, R)) for _ in range(5)]
    neg = (pts[1][0], -pts[1][1]) if not isinstance(pts[1][0], int) else (
        pts[1][0], (-pts[1][1]) % Q)
    P = pts[:3] + [None, pts[0], pts[1], None]
    Qs = pts[3:] + [pts[2], pts[2], pts[0], neg, None]
    return P, Qs


def test_g1_add_matches_reference_and_host():
    rng = random.Random(5)
    P, Qs = _pairs(z_g1_mul, ZG1, z_g1_add, rng)
    ops = ZEC.make_g1_ops_rns()
    RX = ZEC.point_add(ZEC.g1_points_to_rns(P), ZEC.g1_points_to_rns(Qs), ops)
    ref = [ZEC.g1_point_from_rns(*(np.asarray(c)[:, i:i + 1] for c in RX))
           for i in range(len(P))]
    got = ec.g1_points_from_device(*ec.ec_add(
        ec.points_to_device(P, False), ec.points_to_device(Qs, False), False))
    assert got == ref == [z_g1_add(a, b) for a, b in zip(P, Qs)]
    # doubling through the same complete formula
    dbl = ec.g1_points_from_device(*ec.ec_add(
        ec.points_to_device(P, False), ec.points_to_device(P, False), False))
    assert dbl == [z_g1_add(a, a) for a in P]


def test_g2_add_matches_reference_and_host():
    rng = random.Random(6)
    P, Qs = _pairs(z_g2_mul, ZG2, z_g2_add, rng)
    ops = ZEC.make_g2_ops_rns()
    RX = ZEC.point_add(ZEC.g2_points_to_rns(P), ZEC.g2_points_to_rns(Qs), ops)
    ref = [ZEC.g2_point_from_rns(*(np.asarray(c)[:, :, i:i + 1] for c in RX))
           for i in range(len(P))]
    pp = [_port_g2(p) for p in P]
    qq = [_port_g2(p) for p in Qs]
    got = ec.g2_points_from_device(*ec.ec_add(
        ec.points_to_device(pp, True), ec.points_to_device(qq, True), True))
    want = [_port_g2(z_g2_add(a, b)) for a, b in zip(P, Qs)]
    assert got == [_port_g2(p) for p in ref] == want


@pytest.mark.parametrize("is_g2", [False, True], ids=["g1", "g2"])
def test_to_affine_plain(is_g2):
    rng = random.Random(7)
    if is_g2:
        pts = [_port_g2(z_g2_mul(ZG2, rng.randrange(1, R))) for _ in range(4)]
    else:
        pts = [z_g1_mul(ZG1, rng.randrange(1, R)) for _ in range(4)]
    pts.append(None)
    X, Y, Z = ec.points_to_device(pts, is_g2)
    # scale each projective point by a random nonzero lambda
    from za_tpu_torch.engine import field as F
    fld = ec.field_of(is_g2)
    lam = F.FQ.to_mont(torch.from_numpy(F.ints_to_limbs(
        [rng.randrange(1, Q) for _ in pts]).astype(np.int64)))
    if is_g2:
        lam = lam.unsqueeze(1).expand(16, 2, len(pts))
        lam = torch.stack([lam[:, 0], torch.zeros_like(lam[:, 1])], dim=1)
    Xs, Ys, Zs = (F.pack(fld.mul(F.unpack(c), lam)) for c in (X, Y, Z))
    x, y = ec.to_affine(Xs, Ys, Zs, is_g2)
    z_aff = ec.identity_like(x, is_g2)[1].clone()
    z_aff[..., -1] = 0   # the last point is the identity
    back = (ec.g2_points_from_device if is_g2 else ec.g1_points_from_device)(
        x, y, z_aff)
    assert back == pts


def test_signed_digits_match_reference():
    rng = random.Random(8)
    vals = [0, 1, R - 1, 8, 9, 15, (1 << 253) + 12345] + [
        rng.randrange(R) for _ in range(40)]
    limbs = ZF.ints_to_limbs(vals)
    ref = np.asarray(ZMSM.signed_digits(jnp.asarray(limbs), 4))
    got = msm.signed_digits(torch.from_numpy(limbs.astype(np.int32)))
    assert got.dtype == torch.int8 and got.shape == ref.shape == (64, len(vals))
    assert np.array_equal(got.numpy().astype(np.int32), ref)
    recon = [sum(int(got[w, j]) << (4 * w) for w in range(64))
             for j in range(len(vals))]
    assert recon == vals
