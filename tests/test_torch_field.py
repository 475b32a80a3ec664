"""za_tpu_torch.engine.field (plain versions of csrc/field.cuh) against
host ints, the reference's limb packing and its RNS Montgomery product.
Zero tolerance: every value is compared mod p after decoding."""

import random

import numpy as np
import pytest
import torch

import za_tpu.engine.field as ZF
import za_tpu.engine.rns as RNS
from za_tpu.curve import Fq2 as ZFq2
from za_tpu_torch.curve import Q, R
from za_tpu_torch.engine import field as F


def _l16(vals):
    return torch.from_numpy(F.ints_to_limbs(vals).astype(np.int64))


def _ints(t):
    return F.limbs_to_ints(t.numpy())


def _operands(p, seed, n=40):
    rng = random.Random(seed)
    a = [0, 1, p - 1, p - 1, 0] + [rng.randrange(p) for _ in range(n)]
    b = [p - 1, p - 1, p - 1, 1, 0] + [rng.randrange(p) for _ in range(n)]
    return a, b


@pytest.mark.parametrize("fld", [F.FQ, F.FR], ids=["fq", "fr"])
def test_add_sub_mul_inv_against_ints(fld):
    p = fld.modulus
    a, b = _operands(p, 1)
    A, B = _l16(a), _l16(b)
    assert _ints(fld.add(A, B)) == [(x + y) % p for x, y in zip(a, b)]
    assert _ints(fld.sub(A, B)) == [(x - y) % p for x, y in zip(a, b)]
    assert _ints(fld.neg(A)) == [(-x) % p for x in a]
    am, bm = fld.to_mont(A), fld.to_mont(B)
    assert _ints(am) == [fld.to_mont_int(x) for x in a]
    assert _ints(fld.from_mont(fld.mul(am, bm))) == [
        x * y % p for x, y in zip(a, b)]
    assert _ints(fld.from_mont(fld.inv(am))) == [
        pow(x, -1, p) if x else 0 for x in a]
    assert _ints(fld.from_mont(F.batch_inv(fld, am))) == [
        pow(x, -1, p) if x else 0 for x in a]


@pytest.mark.parametrize("ctx,fld", [(RNS.RQ, F.FQ), (RNS.RR, F.FR)],
                         ids=["fq", "fr"])
def test_mont_mul_matches_rns_reference(ctx, fld):
    """Same plain operands through the reference's RNS Montgomery
    product (decoded mod p) and the port's 16-bit-limb one."""
    p = fld.modulus
    a, b = _operands(p, 2, n=30)
    ra = ctx.ints_to_rns([ctx.to_mont_int(x) for x in a])
    rb = ctx.ints_to_rns([ctx.to_mont_int(x) for x in b])
    ref = np.asarray(RNS.mont_mul_rns(ra, rb, ctx))
    want = [ctx.from_mont_int(v) % p for v in ctx.rns_to_ints(ref)]
    got = _ints(fld.from_mont(fld.mul(fld.to_mont(_l16(a)),
                                      fld.to_mont(_l16(b)))))
    assert got == want


def test_fq2_against_curve():
    rng = random.Random(3)
    pairs = [(0, 0), (1, 0), (0, 1), (Q - 1, Q - 1)] + [
        (rng.randrange(Q), rng.randrange(Q)) for _ in range(12)]
    other = pairs[::-1]

    def dev(ps):
        return torch.stack([F.FQ.to_mont(_l16([x for x, _ in ps])),
                            F.FQ.to_mont(_l16([y for _, y in ps]))], dim=1)

    def host(t):
        c0 = _ints(F.FQ.from_mont(t[:, 0]))
        c1 = _ints(F.FQ.from_mont(t[:, 1]))
        return [ZFq2(x, y) for x, y in zip(c0, c1)]

    X, Y = dev(pairs), dev(other)
    assert host(F.FQ2.mul(X, Y)) == [
        ZFq2(*u) * ZFq2(*v) for u, v in zip(pairs, other)]
    assert host(F.FQ2.sqr(X)) == [ZFq2(*u).square() for u in pairs]
    want_inv = [ZFq2(*u).inv() if u != (0, 0) else ZFq2(0, 0) for u in pairs]
    assert host(F.FQ2.inv(X)) == want_inv
    assert host(F.batch_inv(F.FQ2, X)) == want_inv


def test_limb_repack_matches_reference_layout():
    rng = random.Random(4)
    vals = [0, 1, Q - 1, R - 1, (1 << 256) - 1] + [
        rng.randrange(1 << 256) for _ in range(20)]
    ref = ZF.ints_to_limbs(vals)
    assert np.array_equal(F.ints_to_limbs(vals), ref)
    assert F.limbs_to_ints(ref) == vals
    l32 = F.pack(torch.from_numpy(ref.astype(np.int64)))
    assert l32.dtype == torch.int32 and l32.shape == (8, len(vals))
    assert np.array_equal(l32.numpy(), F.ints_to_l32(vals))
    assert F.l32_to_ints(l32.numpy()) == vals
    assert torch.equal(F.unpack(l32), torch.from_numpy(ref.astype(np.int64)))
