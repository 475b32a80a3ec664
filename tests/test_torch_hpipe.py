"""h(x) on the port's kernels, through their plain versions on the CPU:
the R1CS matvec (za_tpu_torch.engine.r1cs) against the reference's RNS
matvec (TpuEngine._matvec_rns_jit), the prefix's load and store modes
(engine.ntt) against the tensor code they replace, a step-for-step
model of the ntt_prefix_fr kernel's schedule (csrc/ntt.cu) against the
plain prefix, and GpuEngine.h_coeffs_limbs against za_tpu's
h_coeffs_limbs on two four-step domains (2^12 and 2^6).  Inputs from
seeded numpy; values compared mod r after decoding, exact equality."""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import za_tpu.engine.rns as RNS
from za_tpu.engine.engine import TpuEngine
from za_tpu.groth16.domain import Domain as ZDomain
from za_tpu.groth16.r1cs import R1CS as ZR1CS
from za_tpu_torch.curve import R
from za_tpu_torch.engine import field as F, ntt, r1cs as RC
from za_tpu_torch.engine.engine import GpuEngine
from za_tpu_torch.groth16.domain import Domain
from za_tpu_torch.groth16.r1cs import R1CS

RR = RNS.RR
CSRC = pathlib.Path(ntt.__file__).parents[1] / "csrc"


def _ints(rng, n):
    """n Fr ints from seeded numpy (four 64-bit words each, mod r)."""
    w = rng.integers(0, 1 << 63, size=(n, 4), dtype=np.int64)
    return [int(a) | int(b) << 63 | int(c) << 126 | int(d) << 189
            for a, b, c, d in w.tolist()]


def _ints32(t):
    """l32 (8, ...) Montgomery values -> flat list of ints."""
    return F.limbs_to_ints(F.FR.from_mont(F.unpack(t).reshape(16, -1))
                           .numpy())


def _mont32(vals, shape):
    return ntt._table32([v % R for v in vals], "cpu").reshape(shape)


@pytest.fixture(scope="module")
def ref_engine():
    return TpuEngine(msm_style="rns")


# -- the matvec -------------------------------------------------------------------


def _rows(rng, n, nv, long_rows):
    rows = []
    for i in range(n):
        k = long_rows.get(i, int(rng.integers(1, 4)))
        cols = rng.integers(0, nv, size=k).tolist()
        rows.append(list(zip(cols, _ints(rng, k))))
    return rows


def _witness16(z):
    """Witness ints -> (16, nv) int32 16-bit plain limbs, as
    GpuEngine.witness_limbs_dev uploads them."""
    return torch.from_numpy(F.ints_to_limbs([v % R for v in z])
                            .astype(np.int32))


def _edge_rows(rng, n, nv):
    """Rows of exactly WARP_ROW and WARP_ROW + 1 entries, empty rows
    between them, coefficients 0, 1 and r - 1."""
    w = RC.WARP_ROW
    rows = _rows(rng, n, nv, {3: w, 4: w + 1, 7: 0, 8: 0, 20: 2 * w})
    rows[10] = [(0, 0), (1, 1), (nv - 1, R - 1)]
    return rows


@pytest.mark.parametrize("case", ["short", "long", "edge"])
def test_matvec_plain_matches_reference(ref_engine, case):
    """A, B, C legs of random rows (1-3 entries; "long": rows of
    WARP_ROW + 1 and 3 WARP_ROW entries, which the kernel gives to one
    warp; "edge": rows at WARP_ROW, empty rows, coefficients 0, 1,
    r - 1 and witness values 0 and r - 1), from the (16, nv) witness
    limbs, against the reference's matvec, decoded."""
    rng = np.random.default_rng(7 + ["short", "long", "edge"].index(case))
    n, nv, m = 40, 30, 64
    w = RC.WARP_ROW
    long_rows = {5: w + 1, 9: 3 * w} if case == "long" else {}
    first = (_edge_rows(rng, n, nv) if case == "edge"
             else _rows(rng, n, nv, long_rows))
    legs = [first, _rows(rng, n - 7, nv, {}), _rows(rng, n, nv, {})]
    z = _ints(rng, nv)
    if case == "edge":
        z[0], z[-1] = 0, R - 1
    csr = RC.pack_csr(legs, m, "cpu")
    got = RC.matvec_plain(csr, _witness16(z))
    assert got.shape == (8, 3, m)
    zr1cs = ZR1CS(num_inputs=2, num_aux=nv - 2, input_names=["main.x"],
                  a_rows=legs[0], b_rows=legs[1], c_rows=legs[2],
                  var_of_signal=[])
    z_rns = jnp.asarray(RR.ints_to_rns([RR.to_mont_int(v % R) for v in z]))
    for k, e in enumerate(ref_engine._r1cs_entries_rns(zr1cs)):
        want = ref_engine._matvec_rns_jit(m, e[1].shape[0])(z_rns, *e)
        dec = [RR.from_mont_int(v) % R
               for v in RR.rns_to_ints(np.asarray(want))]
        assert _ints32(got[:, k]) == dec, k


def test_legs_on_cpu_equal_the_old_route():
    """GpuEngine(device="cpu")._legs (the matvec on the uploaded (16, nv)
    limbs) equals the route it replaces: the witness packed to l32 with
    F.pack, then per-entry products, row sums, one reduction and a
    product by R^2."""
    rng = np.random.default_rng(12)
    a, b, c, z = _chain(50, rng)
    r1cs = R1CS(num_inputs=2, num_aux=50, input_names=["main.x"],
                a_rows=a, b_rows=b, c_rows=c)
    m = Domain.for_constraints(52).size
    eng = GpuEngine(device="cpu")
    got = eng._legs(r1cs, z, m)
    z16 = eng.witness_limbs_dev(z)
    assert z16.dtype == torch.int32 and z16.shape == (16, len(z))
    csr = RC.r1cs_csr(r1cs, m, "cpu")
    z32 = F.pack(z16.to(F.I64))
    prod = F.FR.mul(F.unpack(csr.coeffs),
                    F.unpack(z32).index_select(1, csr.cols.to(F.I64)))
    t = torch.zeros((33, 3 * m), dtype=F.I64)
    t[:16].index_add_(1, RC._rows(csr), prod)
    old = F.pack(F.FR.mul(F.FR.redc(t), F.FR.const(F.FR.r2, t)))
    assert torch.equal(got, old.reshape(8, 3, m))
    assert RC.satisfied(got)


def test_kernel_constants_match_sources():
    """The thresholds and flags the wrappers use are the kernels'."""
    r1cs_cu = (CSRC / "r1cs.cu").read_text()
    ntt_cu = (CSRC / "ntt.cu").read_text()
    assert re.findall(r"constexpr int MV_WARP_ROW = (\d+);", r1cs_cu) == [
        str(RC.WARP_ROW)]
    assert re.findall(r"constexpr int PREFIX_ROWS = (\d+);", ntt_cu) == [
        str(ntt.PREFIX_ROWS)]
    for name, flag in ntt.PREFIX_MODES.items():
        assert re.findall(rf"constexpr int PREFIX_{name.upper()} = (\d+);",
                          ntt_cu) == [str(flag)]


def _c_argspec(source: str, name: str) -> str:
    """The argspec of C entry point name in csrc/<source>.cu: "p" per
    pointer, "i" per int, the trailing stream left out."""
    text = (CSRC / f"{source}.cu").read_text()
    params = re.search(rf"(?m)^int {name}\(([^)]*)\)", text).group(1)
    kinds = ["p" if "*" in a else "i" for a in params.split(",")]
    assert kinds[-1] == "p" and "stream" in params.split(",")[-1]
    return "".join(kinds[:-1])


def _all_kernels():
    from za_tpu_torch.engine import (  # noqa: F401  (registers them)
        _build, cuda_tree, ec, msm, msm_dense)
    return sorted(_build.KERNELS.values(), key=lambda k: k.name)


@pytest.mark.parametrize("kern", _all_kernels(), ids=lambda k: k.name)
def test_wrapper_argspec_matches_c_entry(kern):
    """Each ctypes wrapper passes the arguments its C entry point takes:
    a pointer where it takes one, an int where it takes an int."""
    assert kern.argspec == _c_argspec(kern.source, kern.name)


# -- the prefix's modes against the code they replace -----------------------------


def _prefix_inputs(seed, B, S, L):
    rng = np.random.default_rng(seed)
    x = _mont32(_ints(rng, B * S * L), (8, B, S, L))
    tw = ntt._twiddles(Domain(S).omega, S // 2, "cpu")
    return rng, x, tw


def _scale_flat(x16, table):
    """ntt._scale over the (S, L) axes flattened: l16 (16, B, S, L)."""
    shape = x16.shape
    return ntt._scale(x16.reshape(16, shape[1], -1), table).reshape(shape)


@pytest.mark.parametrize("S,L,m", [(64, 8, 64), (64, 8, 16)])
def test_prefix_scale_on_load(S, L, m):
    """scale_in: _scale by the table, then the unchanged prefix."""
    rng, x, tw = _prefix_inputs(1, 2, S, L)
    table = _mont32(_ints(rng, S * L), (8, S * L))
    want = ntt.ntt_prefix_plain(F.pack(_scale_flat(F.unpack(x), table)),
                                tw, m)
    assert torch.equal(ntt.ntt_prefix_plain(x, tw, m, scale_in=table), want)


def test_prefix_combine_on_load():
    """combine: the engine's l16 combine a b - c of legs (0, 1, 2) and
    (3, 4, 5), then the prefix."""
    S, L, m = 64, 8, 64
    _, x, tw = _prefix_inputs(2, 6, S, L)
    v = F.unpack(x)
    FR = F.FR
    hc = torch.cat([FR.sub(FR.mul(v[:, i:i + 1], v[:, i + 1:i + 2]),
                           v[:, i + 2:i + 3]) for i in (0, 3)], dim=1)
    want = ntt.ntt_prefix_plain(F.pack(hc), tw, m)
    got = ntt.ntt_prefix_plain(x, tw, m, combine=True)
    assert got.shape == (8, 2, S, L) and torch.equal(got, want)


def test_prefix_scale_on_store():
    """scale_out with a table of plain values: the prefix, then _scale
    by the Montgomery table, from_mont and the (16, ...) plain limbs."""
    S, L, m = 64, 8, 64
    rng, x, tw = _prefix_inputs(3, 2, S, L)
    vals = _ints(rng, S * L)
    mont = _mont32(vals, (8, S * L))
    plain = ntt._table32([v % R for v in vals], "cpu", mont=False)
    y = ntt.ntt_prefix_plain(x, tw, m)
    want = F.FR.from_mont(_scale_flat(F.unpack(y), mont))
    got = ntt.ntt_prefix_plain(x, tw, m, scale_out=plain)
    assert got.dtype == torch.int32 and torch.equal(got.to(torch.int64),
                                                    want)


# -- a model of the prefix kernel's schedule ---------------------------------------

def _kernel_const(name):
    src = (CSRC / "ntt.cu").read_text()
    return int(re.findall(rf"constexpr int {name} = (\d+);", src)[0])


# values a thread holds, lanes of one block (csrc/ntt.cu)
EL = 1 << _kernel_const("PREFIX_LOG_EL")
LANES = _kernel_const("PREFIX_BLOCK_LANES")


def _pass_row(t, idx, s, ld):
    grp = t * (EL >> s) + (idx >> s)
    e = idx & ((1 << s) - 1)
    return ((grp >> ld) << (ld + s)) + (grp & ((1 << ld) - 1)) + (e << ld)


def _tile_slot(r, lane):
    return (r ^ ((r >> 3) & 1) ^ (((r >> 4) & 1) * 6)) * LANES + lane


def _run_pass(v, tws, m, t, s, ld):
    for q in range(s):
        tstep = m >> (ld + q + 1)
        for idx in range(EL):
            e = idx & ((1 << s) - 1)
            if e >> q & 1:
                continue
            elo = e & ((1 << q) - 1)
            grp = t * (EL >> s) + (idx >> s)
            j = (grp & ((1 << ld) - 1)) + (elo << ld)
            if ld == 0 and elo == 0:
                assert j == 0      # the slots whose product the kernel skips
            u, w = v[idx], v[idx + (1 << q)] * tws[j * tstep] % R
            v[idx], v[idx + (1 << q)] = (u + w) % R, (u - w) % R


def _model_prefix(col, S, m, omega, exchanges):
    """One lane of ntt_prefix_fr, pass by pass as csrc/ntt.cu runs it,
    on plain ints; exchanges collects each exchange's (write, read)
    slots of every thread row."""
    rows = min(S, ntt.PREFIX_ROWS)
    log_s, log_m = S.bit_length() - 1, m.bit_length() - 1
    tws = [pow(omega, k * (S // m), R) for k in range(m // 2)]
    out = [None] * S
    for tile in range(S // rows):
        nt = rows // EL

        def bitrev(i):
            return int(format(i, f"0{log_s}b")[::-1], 2)

        v = [[col[bitrev(tile * rows + EL * t + i)] for i in range(EL)]
             for t in range(nt)]
        s, ld = min(EL.bit_length() - 1, log_m), 0
        for t in range(nt):
            _run_pass(v[t], tws, m, t, s, 0)
        while ld + s < log_m:
            ld2 = ld + s
            s2 = min(EL.bit_length() - 1, log_m - ld2)
            wr = [[_tile_slot(_pass_row(t, i, s, ld), 0) for i in range(EL)]
                  for t in range(nt)]
            rd = [[_tile_slot(_pass_row(t, i, s2, ld2), 0)
                   for i in range(EL)] for t in range(nt)]
            exchanges.append((wr, rd))
            tile_mem = {}
            for t in range(nt):
                for i in range(EL):
                    assert wr[t][i] not in tile_mem
                    tile_mem[wr[t][i]] = v[t][i]
            assert len(tile_mem) == rows
            v = [[tile_mem[rd[t][i]] for i in range(EL)] for t in range(nt)]
            s, ld = s2, ld2
            for t in range(nt):
                _run_pass(v[t], tws, m, t, s, ld)
        for t in range(nt):
            for i in range(EL):
                r = tile * rows + _pass_row(t, i, s, ld)
                assert out[r] is None
                out[r] = v[t][i]
    return out


@pytest.mark.parametrize("S,m", [(512, 512), (512, 64), (1024, 512),
                                 (256, 128), (64, 16), (32, 4), (16, 2)])
def test_prefix_schedule_model_matches_plain(S, m):
    """Registers, passes of up to three stages, the exchanges through
    the permuted tile: the model equals ntt_prefix_plain on one lane,
    every exchange is a permutation of the tile."""
    rng = np.random.default_rng(S + m)
    col = [v % R for v in _ints(rng, S)]
    omega = Domain(S).omega
    got = _model_prefix(col, S, m, omega, [])
    tw = ntt._twiddles(omega, S // 2, "cpu")
    want = ntt.ntt_prefix_plain(_mont32(col, (8, 1, S, 1)), tw, m)
    assert got == _ints32(want)


def test_prefix_exchanges_hit_32_banks():
    """At the 2^18 shape (m = 512: four exchanges) each warp's store and
    load of one value of one limb plane touches 32 distinct banks: a
    warp is 32 / LANES thread rows x LANES lanes, a plane a multiple of
    32 words."""
    S = m = 512
    exchanges = []
    _model_prefix([0] * S, S, m, Domain(S).omega, exchanges)
    assert len(exchanges) == -(-9 // (EL.bit_length() - 1)) - 1
    assert (min(S, ntt.PREFIX_ROWS) * LANES) % 32 == 0
    for wr, rd in exchanges:
        for slots in (wr, rd):
            for t0 in range(0, len(slots), 32 // LANES):
                for i in range(EL):
                    banks = {(slots[t][i] + lane) % 32
                             for t in range(t0, t0 + 32 // LANES)
                             for lane in range(LANES)}
                    assert len(banks) == 32


# -- h(x) end to end ----------------------------------------------------------------


def _chain(n, rng):
    a, b, c = [], [], []
    z = [1, _ints(rng, 1)[0] % R]
    for i in range(n):
        a.append([(i + 1, 1)])
        b.append([(i + 1, 1), (0, 3)])
        c.append([(i + 2, 1), (0, (-i) % R)])
        z.append((z[i + 1] * (z[i + 1] + 3) + i) % R)
    return a, b, c, z


@pytest.mark.parametrize("n,split", [(3000, (64, 64)), (61, (8, 8))],
                         ids=["fourstep-2^12", "fourstep-2^6"])
def test_h_coeffs_limbs_match_reference(ref_engine, n, split):
    """GpuEngine(device="cpu").h_coeffs_limbs (matvec with the input
    rows in A, the prefix's modes) against za_tpu's h_coeffs_limbs; both
    domains through the four-step (n1, n2)."""
    a, b, c, z = _chain(n, np.random.default_rng(n))
    r1cs = R1CS(num_inputs=2, num_aux=n, input_names=["main.x"],
                a_rows=a, b_rows=b, c_rows=c)
    zr1cs = ZR1CS(num_inputs=2, num_aux=n, input_names=["main.x"],
                  a_rows=a, b_rows=b, c_rows=c, var_of_signal=[])
    m = Domain.for_constraints(n + 2).size
    eng = GpuEngine(device="cpu")
    h = eng.h_coeffs_limbs(r1cs, z, Domain(m))
    fs = eng._domain(m).fourstep
    assert (fs.n1, fs.n2) == split
    assert h.dtype == torch.int32 and h.shape == (16, m - 1)
    want = np.asarray(ref_engine.h_coeffs_limbs(zr1cs, z, ZDomain(m)))
    assert F.limbs_to_ints(h.numpy()) == F.limbs_to_ints(want)
