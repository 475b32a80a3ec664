"""The port's four-step NTT (za_tpu_torch.engine.ntt: sub_ntt with the
fused prefix and the tail, the twiddle transpose, fourstep_core, the
transforms and h(x) at every size) against the reference: its XLA
sub-NTT and four-step core (ntt_rns), its fused Pallas prefix in
interpret mode (pallas_ntt), its host Domain and HostEngine.h_coeffs.
Every plain version runs here.  Values are compared mod r after
decoding (the reference's residues with its M1-Montgomery, the port's
limbs with 2^256); exact equality."""

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

RR = RNS.RR


def _vals(rng, n):
    return [rng.randrange(R) for _ in range(n)]


def _mont16(vals):
    """ints -> (16, n) l16 Montgomery values."""
    return F.FR.to_mont(torch.from_numpy(F.ints_to_limbs(vals)
                                         .astype(np.int64)))


def _mont32(vals, shape):
    """ints -> l32 Montgomery values of the given shape (8, ...)."""
    return F.pack(_mont16(vals)).reshape(shape)


def _ints16(t):
    """(16, ...) l16 Montgomery values -> flat list of ints."""
    return F.limbs_to_ints(F.FR.from_mont(t.reshape(F.NLIMBS, -1)).numpy())


def _ints32(t):
    return _ints16(F.unpack(t))


def _rns(vals, shape):
    """ints -> reference Montgomery residues (35, ...)."""
    return jnp.asarray(RR.ints_to_rns([RR.to_mont_int(v) for v in vals])
                       .reshape((RNS.N_CH,) + shape))


def _rns_ints(a):
    a = np.asarray(a).reshape(RNS.N_CH, -1)
    return [RR.from_mont_int(v) % R for v in RR.rns_to_ints(a)]


def _tables(S):
    """Forward and inverse sub-NTT tables: the port's l32 and the
    reference's RNS ones."""
    d = Domain(S)
    return [(ntt._twiddles(w, S // 2, "cpu"),
             jnp.asarray(NR._mont_table(NR._pow_list(w, S // 2))))
            for w in (d.omega, d.omega_inv)]


@pytest.fixture(scope="module")
def rns_fourstep():
    """The reference's four-step tables at 2^12, built directly (its
    RnsDomain takes the four-step only on a TPU)."""
    d = ZDomain(1 << 12)
    return NR.RnsFourStep(d.size, d.omega, d.size_inv)


def test_sub_ntt_matches_reference_axis1():
    """(a) sub_ntt_plain against ntt_rns._sub_ntt_axis1, forward and
    inverse tables, at (S, L) = (64, 8)."""
    S, L = 64, 8
    vals = _vals(random.Random(1), S * L)
    assert ntt.prefix_rows(S, L) == S
    for tw, rtab in _tables(S):
        got = ntt.sub_ntt_plain(_mont32(vals, (8, 1, S, L)), tw, S)
        want = NR._sub_ntt_axis1(_rns(vals, (S, L)), rtab, S)
        assert _ints32(got) == _rns_ints(want)


def test_prefix_matches_pallas_kernel():
    """(b) The prefix alone (m_fuse = S) against the reference's fused
    Pallas kernel, interpret mode, at (S, L) = (8, 8)."""
    from za_tpu.engine import pallas_ntt as PN

    S, L = 8, 8
    vals = _vals(random.Random(2), S * L)
    (tw, rtab), _ = _tables(S)
    assert PN.pick_m_fuse(S, L) == S
    got = ntt.ntt_prefix_plain(_mont32(vals, (8, 1, S, L)), tw, S)
    want = PN.sub_ntt_fused(_rns(vals, (S, L)), rtab, S, interpret=True)
    assert _ints32(got) == _rns_ints(want)


@pytest.mark.parametrize("budget,m_fuse", [
    (ntt.PREFIX_SMEM_BYTES, 256),   # every stage in the prefix
    (16 * 8 * 32, 16),              # prefix of 4 stages, tail of 4
    (2 * 8 * 32, 2),                # nothing fused: gather + stages
])
def test_prefix_handover(monkeypatch, budget, m_fuse):
    """(c) sub_ntt at (S, L) = (256, 8) with the shared-memory budget
    cut, so the prefix hands over to the stage tail mid-transform; each
    lane column against the host NTT."""
    monkeypatch.setattr(ntt, "PREFIX_SMEM_BYTES", budget)
    S, L = 256, 8
    assert ntt.prefix_rows(S, L) == m_fuse
    vals = _vals(random.Random(3), S * L)
    (tw, _), _ = _tables(S)
    got = _ints32(ntt.sub_ntt_plain(_mont32(vals, (8, 1, S, L)), tw, S))
    zd = ZDomain(S)
    for lane in range(L):
        assert got[lane::L] == zd.ntt(vals[lane::L])
    assert ntt.prefix_rows(S, 4) == 1   # L off the kernel's lane tile


def test_prefix_lane_tile_matches_kernel():
    """prefix_rows and the wrapper's checks use the lane tile that the
    prefix kernel's shared-memory layout is built on."""
    import pathlib
    import re

    src = (pathlib.Path(ntt.__file__).parents[1] / "csrc" / "ntt.cu"
           ).read_text()
    lanes = re.findall(r"constexpr int PREFIX_LANES = (\d+);", src)
    assert lanes == [str(ntt.PREFIX_LANES)]


def test_fourstep_core_matches_reference(rns_fourstep):
    """(d) fourstep_core against ntt_rns._fourstep_core at 2^12, both
    directions."""
    fs = rns_fourstep
    dom = ntt.DeviceDomain(1 << 12, "cpu")
    pfs = dom.fourstep
    assert (pfs.n1, pfs.n2) == (fs.n1, fs.n2) == (64, 64)
    vals = _vals(random.Random(4), dom.size)
    x = _mont32(vals, (8, 1, dom.size))
    xr = _rns(vals, (dom.size,))
    for inverse in (False, True):
        got = ntt.fourstep_core(x, *pfs.tables(inverse), pfs.n1, pfs.n2)
        if inverse:
            want = NR._fourstep_core(xr, fs.t2_inv, fs.t1_inv, fs.inter_inv,
                                     fs.n1, fs.n2)
        else:
            want = NR._fourstep_core(xr, fs.t2_fwd, fs.t1_fwd, fs.inter_fwd,
                                     fs.n1, fs.n2)
        assert _ints32(got) == _rns_ints(want)


def test_twiddle_transpose_matches_reference(rns_fourstep):
    """(f) ntt_twiddle_plain against mont_mul_rns by the inter table,
    then swapaxes, each package with its own tables (forward, and the
    inverse with 1/n)."""
    fs = rns_fourstep
    pfs = ntt.DeviceDomain(1 << 12, "cpu").fourstep
    n1, n2 = fs.n1, fs.n2
    vals = _vals(random.Random(5), n1 * n2)
    a = _mont32(vals, (8, 1, n2, n1))
    ar = jnp.asarray(np.asarray(_rns(vals, (n2, n1))).astype(np.uint32))
    for inter, rinter in ((pfs.inter_fwd, fs.inter_fwd),
                          (pfs.inter_inv, fs.inter_inv)):
        got = ntt.ntt_twiddle_plain(a, inter)
        assert got.shape == (8, 1, n1, n2)
        want = jnp.swapaxes(RNS.mont_mul_rns(ar, rinter, RR), 1, 2)
        assert _ints32(got) == _rns_ints(want)


@pytest.mark.parametrize("k", [12, 13])
def test_transforms_match_host_domain(k):
    """(e) ntt / intt / coset_ntt / coset_intt through the four-step
    against the host Domain, three legs batched; 2^13 has n1 != n2."""
    m = 1 << k
    rng = random.Random(k)
    legs = [_vals(rng, m) for _ in range(3)]
    legs[0][0], legs[0][1] = 0, R - 1
    dom = ntt.DeviceDomain(m, "cpu")
    assert (dom.fourstep.n1, dom.fourstep.n2) == (
        (64, 64) if k == 12 else (128, 64))
    x = torch.stack([_mont16(v) for v in legs], dim=1)   # (16, 3, m)
    zd = ZDomain(m)
    for fn, want in ((ntt.ntt, zd.ntt), (ntt.intt, zd.intt),
                     (ntt.coset_ntt, zd.coset_ntt),
                     (ntt.coset_intt, zd.coset_intt)):
        got = fn(dom, x)
        assert got.shape == x.shape
        for b, v in enumerate(legs):
            assert _ints16(got[:, b]) == want(v), (fn.__name__, b)


@pytest.mark.parametrize("budget", [ntt.PREFIX_SMEM_BYTES, 16 * 8 * 32,
                                    2 * 8 * 32])
def test_fourstep_round_trip(monkeypatch, budget):
    """intt(ntt(x)) == x and coset_intt(coset_ntt(x)) == x at 2^12 with
    the prefix covering all, part or none of each sub-NTT: 1/n is
    applied exactly once."""
    monkeypatch.setattr(ntt, "PREFIX_SMEM_BYTES", budget)
    dom = ntt.DeviceDomain(1 << 12, "cpu")
    x = _mont16(_vals(random.Random(6), dom.size))
    assert torch.equal(ntt.intt(dom, ntt.ntt(dom, x)), x)
    assert torch.equal(ntt.coset_intt(dom, ntt.coset_ntt(dom, x)), x)


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


def test_h_coeffs_fourstep_match_host_engine():
    """(g) GpuEngine(device="cpu").h_coeffs_limbs on a chain whose
    domain is 2^12 (the four-step) against za_tpu's HostEngine."""
    n = 3000
    a, b, c, z = _chain(n, 7)
    r1cs = R1CS(num_inputs=2, num_aux=n, input_names=["main.x"],
                a_rows=a, b_rows=b, c_rows=c)
    zr1cs = ZR1CS(num_inputs=2, num_aux=n, input_names=["main.x"],
                  a_rows=a, b_rows=b, c_rows=c, var_of_signal=[])
    m = Domain.for_constraints(n + 2).size
    assert m == 1 << 12
    eng = GpuEngine(device="cpu")
    h = eng.h_coeffs_limbs(r1cs, z, Domain(m))
    assert eng._domain(m).fourstep is not None
    assert h.dtype == torch.int32 and h.shape == (16, m - 1)
    want = ZHostEngine().h_coeffs(zr1cs, z, ZDomain(m))
    assert F.limbs_to_ints(h.numpy()) == want


@pytest.mark.parametrize("k", range(1, 14))
def test_routing_by_size(k):
    """(h) Every size takes the four-step, n1 = 2^ceil(k/2) lanes and
    n2 = n / n1 rows, on any device: its tables at every size, and no
    radix-2 tables; from 2^9 (the smallest engine domain) the prefix
    takes both sub-NTTs whole.  The transform equals the host's."""
    n = 1 << k
    dom = ntt.DeviceDomain(n, "cpu")
    fs = dom.fourstep
    assert (fs.n1, fs.n2) == (1 << (k + 1) // 2, 1 << k // 2)
    assert fs.inter_fwd.shape == fs.inter_inv.shape == (8, fs.n2, fs.n1)
    assert fs.t1_fwd.shape == (8, max(fs.n1 // 2, 1))
    assert fs.t2_inv.shape == (8, max(fs.n2 // 2, 1))
    assert dom.h_out.shape == dom.coset_inv.shape == (8, n)
    assert not hasattr(ntt, "FOURSTEP_MIN")
    for name in ("w_fwd", "w_inv", "size_inv", "coset_inv_pow"):
        assert not hasattr(dom, name), name
    if k >= 9:
        assert ntt.prefix_rows(fs.n2, fs.n1) == fs.n2
        assert ntt.prefix_rows(fs.n1, fs.n2) == fs.n1
    vals = _vals(random.Random(k), n)
    zd = ZDomain(n)
    x = _mont16(vals)
    assert _ints16(ntt.ntt(dom, x)) == zd.ntt(vals)
    assert _ints16(ntt.coset_intt(dom, x)) == zd.coset_intt(vals)


# -- the tail: stages above m_fuse, the store mode in the tail kernel ---------------


def _budget(m):
    """A prefix budget under which prefix_rows picks m_fuse = m."""
    return m * ntt.PREFIX_LANES * 32


@pytest.mark.parametrize("t", [1, 2, 3])
@pytest.mark.parametrize("store", [False, True], ids=["plain", "scale_out"])
def test_tail_stages_match_host(monkeypatch, t, store):
    """sub_ntt_plain at (S, L) = (256, 8) with m_fuse = S / 2^t: the
    prefix, then a tail of t stages with and without the store mode;
    each lane column against the host NTT (times the plain table)."""
    S, L = 256, 8
    monkeypatch.setattr(ntt, "PREFIX_SMEM_BYTES", _budget(S >> t))
    assert ntt.prefix_rows(S, L) == S >> t
    rng = random.Random(10 + t)
    vals = _vals(rng, S * L)
    table = _vals(rng, S * L) if store else None
    (tw, _), _ = _tables(S)
    got = ntt.sub_ntt_plain(
        _mont32(vals, (8, 1, S, L)), tw, S,
        scale_out=ntt._table32(table, "cpu", mont=False) if store else None)
    if store:   # 16-bit plain limbs
        assert got.shape == (16, 1, S, L) and got.dtype == torch.int32
        got = F.limbs_to_ints(got.reshape(16, -1).numpy())
    else:
        got = _ints32(got)
    zd = ZDomain(S)
    for lane in range(L):
        want = zd.ntt(vals[lane::L])
        if store:
            want = [v * c % R for v, c in zip(want, table[lane::L])]
        assert got[lane::L] == want, lane


@pytest.mark.parametrize("k", [12, 13])
@pytest.mark.parametrize("t", [1, 2, 3])
def test_tail_transforms_and_h_match_host(monkeypatch, k, t):
    """The four transforms and h(x) at 2^12 (64 x 64) and 2^13 (128 x
    64) with the prefix cut to S / 2^t rows of the 64-row sub-NTTs (the
    128-row one gets t + 1 tail stages, two launches on the card at t =
    3): against the host Domain and za_tpu's HostEngine.h_coeffs."""
    monkeypatch.setattr(ntt, "PREFIX_SMEM_BYTES", _budget(64 >> t))
    m = 1 << k
    dom = ntt.DeviceDomain(m, "cpu")
    fs = dom.fourstep
    assert ntt.prefix_rows(fs.n2, fs.n1) == 64 >> t
    assert ntt.prefix_rows(fs.n1, fs.n2) == 64 >> t
    rng = random.Random(20 * k + t)
    legs = [_vals(rng, m) for _ in range(3)]
    x = torch.stack([_mont16(v) for v in legs], dim=1)   # (16, 3, m)
    zd = ZDomain(m)
    for fn, want in ((ntt.ntt, zd.ntt), (ntt.intt, zd.intt),
                     (ntt.coset_ntt, zd.coset_ntt),
                     (ntt.coset_intt, zd.coset_intt)):
        got = fn(dom, x)
        for b, v in enumerate(legs):
            assert _ints16(got[:, b]) == want(v), (fn.__name__, b)
    n = m - 200
    a, b, c, z = _chain(n, k + t)
    r1cs = R1CS(num_inputs=2, num_aux=n, input_names=["main.x"],
                a_rows=a, b_rows=b, c_rows=c)
    zr1cs = ZR1CS(num_inputs=2, num_aux=n, input_names=["main.x"],
                  a_rows=a, b_rows=b, c_rows=c, var_of_signal=[])
    assert Domain.for_constraints(n + 2).size == m
    h = GpuEngine(device="cpu").h_coeffs_limbs(r1cs, z, Domain(m))
    want = ZHostEngine().h_coeffs(zr1cs, z, ZDomain(m))
    assert F.limbs_to_ints(h.numpy()) == want
