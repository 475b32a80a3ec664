"""The port's device NTT (za_tpu_torch.engine.ntt) and h(x) pipeline
against the reference's host Domain, its RNS NTT (ntt_rns.RnsDomain)
and HostEngine.h_coeffs.  Values compared mod r."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import za_tpu.engine.ntt_rns as NR
import za_tpu.engine.rns as RNS
from za_tpu.groth16.domain import Domain as ZDomain
from za_tpu.groth16.prove import HostEngine as ZHostEngine
from za_tpu.groth16.r1cs import R1CS as ZR1CS
from za_tpu_torch.curve import R
from za_tpu_torch.engine import field as F, ntt
from za_tpu_torch.engine.engine import GpuEngine
from za_tpu_torch.groth16.domain import Domain
from za_tpu_torch.groth16.r1cs import R1CS


def _mont(vals):
    return F.FR.to_mont(torch.from_numpy(F.ints_to_limbs(vals)
                                         .astype(np.int64)))


def _plain(t):
    return F.limbs_to_ints(F.FR.from_mont(t).numpy())


@pytest.mark.parametrize("k", [6, 8, 10])
def test_transforms_match_host_domain(k):
    m = 1 << k
    rng = random.Random(k)
    vals = [rng.randrange(R) for _ in range(m)]
    vals[0], vals[1] = 0, R - 1
    zd = ZDomain(m)
    dom = ntt.DeviceDomain(m, "cpu")
    x = _mont(vals)
    assert _plain(ntt.ntt(dom, x)) == zd.ntt(vals)
    assert _plain(ntt.intt(dom, x)) == zd.intt(vals)
    assert _plain(ntt.coset_ntt(dom, x)) == zd.coset_ntt(vals)
    assert _plain(ntt.coset_intt(dom, x)) == zd.coset_intt(vals)
    # batched over a leading axis, as h(x) runs its three legs
    xb = torch.stack([x, x.flip(-1)], dim=1)
    got = ntt.coset_ntt(dom, xb)
    assert _plain(got[:, 1]) == zd.coset_ntt(vals[::-1])


def test_transforms_match_rns_reference():
    m = 64
    rng = random.Random(9)
    vals = [rng.randrange(R) for _ in range(m)]
    ctx = RNS.RR
    rdom = NR.RnsDomain(m)
    xr = jnp.asarray(ctx.ints_to_rns([ctx.to_mont_int(v) for v in vals]))

    def dec(a):
        return [ctx.from_mont_int(v) % R for v in ctx.rns_to_ints(np.asarray(a))]

    dom = ntt.DeviceDomain(m, "cpu")
    x = _mont(vals)
    assert _plain(ntt.intt(dom, x)) == dec(NR.intt(rdom, xr))
    assert _plain(ntt.coset_ntt(dom, x)) == dec(NR.coset_ntt(rdom, xr))
    assert _plain(ntt.coset_intt(dom, x)) == dec(NR.coset_intt(rdom, xr))


def _chain(n, seed):
    rng = random.Random(seed)
    a, b, c = [], [], []
    z = [1, rng.randrange(1, R)]
    for i in range(n):
        a.append([(i + 1, 1)])
        b.append([(i + 1, 1), (0, 3)])
        c.append([(i + 2, 1), (0, (-i) % R)])
        z.append((z[i + 1] * (z[i + 1] + 3) + i) % R)
    return a, b, c, z


@pytest.mark.parametrize("n", [61, 510])
def test_h_coeffs_match_host_engine(n):
    a, b, c, z = _chain(n, n)
    r1cs = R1CS(num_inputs=2, num_aux=n, input_names=["main.x"],
                a_rows=a, b_rows=b, c_rows=c)
    zr1cs = ZR1CS(num_inputs=2, num_aux=n, input_names=["main.x"],
                  a_rows=a, b_rows=b, c_rows=c, var_of_signal=[])
    m = Domain.for_constraints(n + 2).size
    eng = GpuEngine(device="cpu")
    assert eng.r1cs_satisfied(r1cs, z)          # stashes the legs
    h = eng.h_coeffs_limbs(r1cs, z, Domain(m))
    assert h.dtype == torch.int32 and h.shape == (16, m - 1)
    want = ZHostEngine().h_coeffs(zr1cs, z, ZDomain(m))
    assert F.limbs_to_ints(h.numpy()) == want
    assert eng.h_coeffs(r1cs, z, Domain(m)) == want  # without the stash
    bad = list(z)
    bad[3] = (bad[3] + 1) % R
    assert not eng.r1cs_satisfied(r1cs, bad)
