"""The NTT over Fr on the device, for the QAP quotient h(x).

Every domain takes the four-step split of the reference
(za_tpu/engine/ntt_rns.py _fourstep_core, RnsFourStep): n = n1 n2, the
values viewed as (n2, n1), a sub-NTT of length n2 over each of the n1
lane columns, the inter-factor twiddles w^(k2 j1) with a transpose to
(n1, n2), and a sub-NTT of length n1 over each of the n2 columns; the
result is in natural order.  Each sub-NTT runs its bit reversal and
first log2(m_fuse) stages in one ``ntt_prefix_fr`` launch (the port of
the reference's fused Pallas prefix, pallas_ntt.py sub_ntt_fused), and
the stages above m_fuse (the tail, from a 2^19 domain) in one
``ntt_stage_fr`` launch; the twiddle multiply and transpose is
``ntt_twiddle_fr`` (csrc/ntt.cu).  The route depends on the size alone,
so the CPU runs it too, through the plain versions.

Transforms run on l32 (8, B, n) values (``transform``).  The prefix
kernel takes in the code at a transform's boundaries: a scaling table on
load (the coset powers), the combine a b - c of h(x)'s three legs on
load, and on store a table of plain values with the output in 16-bit
plain limbs (the inverse coset powers, 1/Z on the coset and from_mont
in one product); where a tail ends the sub-NTT, the tail kernel takes
the store mode in, so ``h_transforms`` is launches alone at every
engine domain.  The plain versions run the modes as tensor code over
``engine.field`` (``load_plain``, ``store_plain``), and so does a
sub-NTT too short for the prefix (S < 8, or L off its lane tile; no
engine domain).  The inverse twiddles hold 1/n.  Tables are built on
the host once per domain size.  Mirrors ``groth16.domain.Domain``, the
host golden model; ``ntt``, ``intt``, ``coset_ntt`` and ``coset_intt``
keep its l16 interface.
"""

from __future__ import annotations

import functools

import torch

from ..curve import R
from ..groth16.domain import Domain
from . import field as F
from ._build import kernel

FR = F.FR
NTT_STAGE = kernel("ntt_stage_fr", "ntt", "ppppiiiiii")
NTT_PREFIX = kernel("ntt_prefix_fr", "ntt", "pppppiiiii")
NTT_TWIDDLE = kernel("ntt_twiddle_fr", "ntt", "pppiii")

#: the ntt_prefix_fr lane tile, L a multiple of it (eight 4-byte lanes:
#: one 32-byte sector a row and limb plane): PREFIX_LANES in csrc/ntt.cu,
#: which a test holds equal to this one
PREFIX_LANES = 8

#: rows of one ntt_prefix_fr tile (PREFIX_ROWS in csrc/ntt.cu): m_fuse
#: is at most this
PREFIX_ROWS = 512

#: the budget m_fuse is picked under (the reference's pick_m_fuse):
#: m_fuse rows x PREFIX_LANES lanes x 32 B.  128 KB fuses every stage of
#: a 512-row sub-NTT (2^18).
PREFIX_SMEM_BYTES = 128 * 1024

#: stages one ntt_stage_fr launch runs at most (TAIL_MAX_STAGES in
#: csrc/ntt.cu, which a test holds equal to this one)
TAIL_MAX_STAGES = 3

#: ntt_prefix_fr's mode flags (csrc/ntt.cu PREFIX_SCALE_IN, ...)
PREFIX_MODES = {"scale_in": 1, "combine": 2, "scale_out": 4}

#: launches of ntt_prefix_fr by mode ("plain" for none), beside the
#: wrapper's total count
PREFIX_LAUNCHES: dict[str, int] = {}


def _pow_list(base: int, count: int, scale: int = 1) -> list[int]:
    out = []
    acc = scale % R
    for _ in range(count):
        out.append(acc)
        acc = acc * base % R
    return out


def _table32(vals, device, mont: bool = True) -> torch.Tensor:
    """Fr ints -> (8, n) l32 table, Montgomery or (mont=False) plain."""
    if mont:
        vals = [FR.to_mont_int(v) for v in vals]
    return torch.from_numpy(F.ints_to_l32(vals).copy()).to(device)


def _twiddles(base: int, count: int, device) -> torch.Tensor:
    """(8, count) l32 Montgomery table of base^k."""
    return _table32(_pow_list(base, max(count, 1)), device)


@functools.lru_cache(maxsize=None)
def _bitrev_index(n: int, device: torch.device) -> torch.Tensor:
    """The bit-reversal permutation of n rows, uploaded once per device."""
    k = n.bit_length() - 1
    return torch.tensor([int(format(i, f"0{k}b")[::-1], 2) if k else 0
                         for i in range(n)], device=device)


class FourStepTables:
    """Four-step tables of a 2^k domain (the reference's RnsFourStep):
    n1 = 2^ceil(k/2), n2 = n / n1; sub-NTT twiddles t1 (n1/2) and t2
    (n2/2); inter[k2, j1] = w^(k2 j1), the inverse's with 1/n folded in;
    all l32 Montgomery, inter (8, n2, n1)."""

    def __init__(self, host: Domain, device):
        k = host.k
        self.n1 = n1 = 1 << ((k + 1) // 2)
        self.n2 = n2 = host.size // n1
        sub1, sub2 = Domain(n1), Domain(n2)
        self.t1_fwd = _twiddles(sub1.omega, n1 // 2, device)
        self.t1_inv = _twiddles(sub1.omega_inv, n1 // 2, device)
        self.t2_fwd = _twiddles(sub2.omega, n2 // 2, device)
        self.t2_inv = _twiddles(sub2.omega_inv, n2 // 2, device)
        self.inter_fwd = self._inter(host.omega, 1, device)
        self.inter_inv = self._inter(host.omega_inv, host.size_inv, device)

    def _inter(self, w: int, scale: int, device) -> torch.Tensor:
        vals, wk = [], 1
        for _ in range(self.n2):      # row k2: scale * (w^k2)^j1
            vals += _pow_list(wk, self.n1, scale)
            wk = wk * w % R
        return _table32(vals, device).reshape(F.NL32, self.n2, self.n1)

    def tables(self, inverse: bool):
        """(t2, t1, inter) of the forward or the inverse transform."""
        if inverse:
            return self.t2_inv, self.t1_inv, self.inter_inv
        return self.t2_fwd, self.t1_fwd, self.inter_fwd


class DeviceDomain:
    """Twiddle and scaling tables of a 2^k domain on ``device``: the
    four-step tables, and l32 (8, n) scaling tables: the coset powers
    (``coset_pow``, h(x)'s load table), their inverses (``coset_inv``),
    and ``h_out``, h(x)'s store table of plain values: the inverse coset
    powers times 1/Z on the coset (1/n is in the inverse transform)."""

    def __init__(self, size: int, device):
        self.size = size
        self.host = h = Domain(size)
        self.fourstep = FourStepTables(h, device)
        self.coset_pow = _table32(_pow_list(h.coset_gen, size), device)
        self.coset_inv = _table32(_pow_list(h.coset_gen_inv, size), device)
        self.h_out = _table32(
            _pow_list(h.coset_gen_inv, size, h.z_coset_inv), device,
            mont=False)


# -- the three kernels and their plain versions ------------------------------
#
# Sub-NTT batches are l32 (8, B, S, L): B transforms of length S along
# axis 2, each over L lane columns; twiddle tables (8, S/2) hold w^k.


def _stages16(v: torch.Tensor, table: torch.Tensor, first: int,
              last: int) -> torch.Tensor:
    """DIT stages of lengths first..last along axis 2 of l16
    (16, B, S, L), with l16 twiddles table (16, S/2)."""
    _, B, S, L = v.shape
    length = first
    while length <= last:
        half = length // 2
        twb = table[:, ::S // length][:, :half].reshape(
            F.NLIMBS, 1, 1, half, 1)
        vr = v.reshape(F.NLIMBS, B, S // length, length, L)
        vt = FR.mul(vr[:, :, :, half:], twb)
        v = torch.cat([FR.add(vr[:, :, :, :half], vt),
                       FR.sub(vr[:, :, :, :half], vt)], dim=3).reshape(
            F.NLIMBS, B, S, L)
        length *= 2
    return v


def _bitrev_rows(x: torch.Tensor) -> torch.Tensor:
    return x.index_select(2, _bitrev_index(x.shape[2], x.device))


def ntt_stages_plain(x: torch.Tensor, tw: torch.Tensor, start: int = 2,
                     scale_out=None) -> torch.Tensor:
    """DIT stages of lengths start..S along axis 2 of l32 (8, B, S, L)
    whose rows are in bit-reversed order (the earlier stages done); the
    store mode as store_plain."""
    S = x.shape[2]
    y = F.pack(_stages16(F.unpack(x), F.unpack(tw), start, S))
    return store_plain(y, scale_out)


def ntt_stages(x: torch.Tensor, tw: torch.Tensor, start: int = 2,
               scale_out=None) -> torch.Tensor:
    """The tail kernel, out of place: the stages of lengths start..S in
    one launch (up to TAIL_MAX_STAGES a launch), with the prefix's store
    mode: scale_out (8, S L) plain values multiplied in on store, (16, B,
    S, L) plain limbs out."""
    if x.device.type == "cpu":
        return ntt_stages_plain(x, tw, start, scale_out)
    _, B, S, L = x.shape
    if (x.dtype != torch.int32 or tw.dtype != torch.int32
            or tw.shape != (8, max(S // 2, 1)) or S & (S - 1)
            or start & (start - 1) or not 2 <= start <= 2 * S
            or (scale_out is not None
                and (scale_out.dtype != torch.int32
                     or scale_out.shape != (8, S * L)))):
        raise ValueError("ntt_stages: int32 (8, B, 2^k, L) values, "
                         "(8, 2^(k-1)) twiddles, a power-of-two start "
                         "2 <= start <= 2^(k+1), an (8, 2^k L) store table")
    h = start // 2
    left = (S // h).bit_length() - 1       # stages to run
    if left == 0 and scale_out is None:
        return x
    x, tw = x.contiguous(), tw.contiguous()
    while True:
        s = min(left, TAIL_MAX_STAGES)
        store = s == left and scale_out is not None
        y = torch.empty((16 if store else 8, B, S, L), dtype=torch.int32,
                        device=x.device)
        NTT_STAGE(x, y, tw, scale_out.contiguous() if store else x, B, S,
                  L, h, s, PREFIX_MODES["scale_out"] if store else 0)
        if s == left:
            return y
        x, h, left = y, h << s, left - s


def prefix_rows(S: int, L: int) -> int:
    """m_fuse: the largest power of two <= min(S, PREFIX_ROWS) whose
    m_fuse rows x PREFIX_LANES lanes fit PREFIX_SMEM_BYTES (the
    reference's pick_m_fuse); 1 where L is no multiple of the kernel's
    lane tile or S < 8."""
    if L % PREFIX_LANES or S < 8:
        return 1
    m = min(S, PREFIX_ROWS)
    while m > 1 and m * PREFIX_LANES * 32 > PREFIX_SMEM_BYTES:
        m //= 2
    return m


def _table16(table: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """l32 (8, S L) table -> l16 (16, 1, S, L) against like (., B, S, L)."""
    return F.unpack(table).reshape((F.NLIMBS, 1) + tuple(like.shape[2:]))


def load_plain(x: torch.Tensor, scale_in=None,
               combine: bool = False) -> torch.Tensor:
    """The prefix's load modes in tensor code, on l32 (8, B, S, L):
    combine takes legs (a, b, c) = batches 3i, 3i + 1, 3i + 2 to
    a b - c, (8, B / 3, S, L); scale_in (8, S L) Montgomery multiplies
    value [s, l] by scale_in[s L + l]."""
    if scale_in is None and not combine:
        return x
    v = F.unpack(x)
    if combine:
        v = v.reshape((F.NLIMBS, -1, 3) + tuple(v.shape[2:]))
        v = FR.sub(FR.mul(v[:, :, 0], v[:, :, 1]), v[:, :, 2])
    if scale_in is not None:
        v = FR.mul(v, _table16(scale_in, v))
    return F.pack(v)


def store_plain(y: torch.Tensor, scale_out=None) -> torch.Tensor:
    """The prefix's store mode in tensor code: l32 (8, B, S, L) times
    scale_out[s L + l], a table of plain values, which gives the plain
    product -> (16, B, S, L) int32 16-bit plain limbs."""
    if scale_out is None:
        return y
    return FR.mul(F.unpack(y), _table16(scale_out, y)).to(torch.int32)


def ntt_prefix_plain(x: torch.Tensor, tw: torch.Tensor, m: int,
                     scale_in=None, combine: bool = False,
                     scale_out=None) -> torch.Tensor:
    """Bit reversal along axis 2 of l32 (8, B, S, L), then the DIT
    stages of lengths 2..m; the load and store modes as load_plain and
    store_plain."""
    x = _bitrev_rows(load_plain(x, scale_in, combine))
    y = F.pack(_stages16(F.unpack(x), F.unpack(tw), 2, m))
    return store_plain(y, scale_out)


def ntt_prefix(x: torch.Tensor, tw: torch.Tensor, m: int, scale_in=None,
               combine: bool = False, scale_out=None) -> torch.Tensor:
    """The prefix kernel, out of place, with its load and store modes:
    (8, B, S, L) -> (8, B, S, L); combine: (8, 3 B, S, L) in; scale_out
    (only with m = S): (16, B, S, L) plain limbs out."""
    if x.device.type == "cpu":
        return ntt_prefix_plain(x, tw, m, scale_in, combine, scale_out)
    _, B, S, L = x.shape
    tables = [t for t in (scale_in, scale_out) if t is not None]
    if (x.dtype != torch.int32 or tw.dtype != torch.int32
            or tw.shape != (8, S // 2) or S & (S - 1) or S < 8
            or m & (m - 1) or not 2 <= m <= S
            or L % PREFIX_LANES or (combine and B % 3)
            or (scale_out is not None and m != S)
            or any(t.dtype != torch.int32 or t.shape != (8, S * L)
                   for t in tables)):
        raise ValueError(f"ntt_prefix: int32 (8, B, 2^k, L) values, "
                         f"2^k >= 8, L a multiple of {PREFIX_LANES}, "
                         f"(8, 2^(k-1)) twiddles, 2 <= m <= 2^k a power "
                         f"of two (the kernel takes m <= {PREFIX_ROWS}), B a "
                         f"multiple of 3 to combine, (8, 2^k L) tables, "
                         f"m = 2^k to scale on store")
    mode = sum(PREFIX_MODES[k] for k, on in (
        ("scale_in", scale_in is not None), ("combine", combine),
        ("scale_out", scale_out is not None)) if on)
    B_out = B // 3 if combine else B
    x = x.contiguous()
    y = torch.empty((16 if scale_out is not None else 8, B_out, S, L),
                    dtype=torch.int32, device=x.device)
    tin = x if scale_in is None else scale_in.contiguous()
    tout = x if scale_out is None else scale_out.contiguous()
    NTT_PREFIX(x, y, tw.contiguous(), tin, tout, B_out, S, L, m, mode)
    key = "+".join(k for k, v in PREFIX_MODES.items() if mode & v) or "plain"
    PREFIX_LAUNCHES[key] = PREFIX_LAUNCHES.get(key, 0) + 1
    return y


def ntt_twiddle_plain(a: torch.Tensor, inter: torch.Tensor) -> torch.Tensor:
    """out[:, b, c, r] = a[:, b, r, c] * inter[:, r, c]: l32 (8, B, R, C)
    and (8, R, C) -> (8, B, C, R)."""
    prod = FR.mul(F.unpack(a), F.unpack(inter).unsqueeze(1))
    return F.pack(prod.transpose(2, 3)).contiguous()


def ntt_twiddle(a: torch.Tensor, inter: torch.Tensor) -> torch.Tensor:
    """The twiddle-transpose kernel."""
    if a.device.type == "cpu":
        return ntt_twiddle_plain(a, inter)
    _, B, Rr, C = a.shape
    if (a.dtype != torch.int32 or inter.dtype != torch.int32
            or inter.shape != (8, Rr, C)):
        raise ValueError("ntt_twiddle: int32 (8, B, R, C) values and "
                         "(8, R, C) twiddles")
    a = a.contiguous()
    out = torch.empty((8, B, C, Rr), dtype=torch.int32, device=a.device)
    NTT_TWIDDLE(a, inter.contiguous(), out, B, Rr, C)
    return out


# -- the four-step -------------------------------------------------------------


def _sub_ntt(x, table, S, prefix, stages, scale_in=None, combine=False,
             scale_out=None):
    m = prefix_rows(S, x.shape[3])
    if m < 4:   # nothing worth fusing at this shape (no engine domain)
        return stages(_bitrev_rows(load_plain(x, scale_in, combine)), table,
                      2, scale_out)
    if m == S:
        return prefix(x, table, m, scale_in, combine, scale_out)
    return stages(prefix(x, table, m, scale_in, combine), table, 2 * m,
                  scale_out)


def sub_ntt(x: torch.Tensor, table: torch.Tensor, S: int, scale_in=None,
            combine: bool = False, scale_out=None) -> torch.Tensor:
    """Radix-2 DIT NTT along axis 2 of l32 (8, B, S, L), natural order
    in and out: the bit reversal and stages 2..m_fuse in the prefix
    kernel, the stages 2 m_fuse..S in the tail kernel.  The load modes
    run in the prefix, the store mode in the launch that ends the
    sub-NTT."""
    return _sub_ntt(x, table, S, ntt_prefix, ntt_stages, scale_in, combine,
                    scale_out)


def sub_ntt_plain(x: torch.Tensor, table: torch.Tensor, S: int,
                  scale_in=None, combine: bool = False,
                  scale_out=None) -> torch.Tensor:
    return _sub_ntt(x, table, S, ntt_prefix_plain, ntt_stages_plain,
                    scale_in, combine, scale_out)


def fourstep_core(x: torch.Tensor, t2, t1, inter, n1: int, n2: int,
                  scale_in=None, combine: bool = False,
                  scale_out=None) -> torch.Tensor:
    """l32 (8, B, n) natural order -> (8, B, n) natural order; the load
    modes on the first sub-NTT's input (index j2 n1 + j1 = natural), the
    store mode on the second's output ([k1, k2]: natural)."""
    B = x.shape[1]
    a = sub_ntt(x.reshape(F.NL32, B, n2, n1), t2, n2,   # over j2, lanes j1
                scale_in, combine)
    a = ntt_twiddle(a, inter)                           # (8, B', n1, n2)
    b = sub_ntt(a, t1, n1, scale_out=scale_out)         # over j1, lanes k2
    return b.reshape(b.shape[0], b.shape[1], n1 * n2)


# -- transforms ----------------------------------------------------------------


def transform(dom: DeviceDomain, x: torch.Tensor, inverse: bool,
              scale_in=None, combine: bool = False,
              scale_out=None) -> torch.Tensor:
    """NTT along the last axis of l32 (8, B, n) Montgomery values,
    natural order in and out, by w^-1 times 1/n where inverse.  The
    modes: scale_in (8, n) Montgomery multiplied in on load; combine:
    B = 3 i legs a, b, c -> a b - c; scale_out (8, n) plain values
    multiplied in on store, (16, B, n) int32 plain limbs out."""
    fs = dom.fourstep
    return fourstep_core(x, *fs.tables(inverse), fs.n1, fs.n2, scale_in,
                         combine, scale_out)


def _core(dom: DeviceDomain, x: torch.Tensor, inverse: bool, **modes):
    """transform on l16 (16, ..., n) Montgomery values."""
    x32 = F.pack(x)
    y = transform(dom, x32.reshape(F.NL32, -1, dom.size), inverse, **modes)
    return F.unpack(y.reshape(x32.shape))


def _scale(x, table):
    """Elementwise product of l16 (16, ..., n) with an l32 (8, n) table
    (or (8, 1) constant)."""
    t = F.unpack(table)
    return FR.mul(x, t.view((F.NLIMBS,) + (1,) * (x.dim() - 2)
                            + (t.shape[-1],)))


def ntt(dom: DeviceDomain, coeffs):
    return _core(dom, coeffs, False)


def intt(dom: DeviceDomain, evals):
    return _core(dom, evals, True)   # inter_inv holds 1/n


def coset_ntt(dom: DeviceDomain, coeffs):
    return _core(dom, coeffs, False, scale_in=dom.coset_pow)


def coset_intt(dom: DeviceDomain, evals):
    return _scale(_core(dom, evals, True), dom.coset_inv)


def h_transforms(dom: DeviceDomain, legs: torch.Tensor) -> torch.Tensor:
    """h(x) from the l32 (8, 3, m) Az, Bz, Cz legs: iNTT, coset NTT (the
    coset powers on load), coset iNTT (a b - c on load; the inverse coset
    powers, 1/Z on the coset and from_mont on store) -> (16, m) int32
    plain limbs of h_0 .. h_{m-1}."""
    x = transform(dom, legs, True)
    x = transform(dom, x, False, scale_in=dom.coset_pow)
    h = transform(dom, x, True, combine=True, scale_out=dom.h_out)
    return h.reshape(F.NLIMBS, dom.size)
