"""Models of the h(x) kernels' schedules, parsed from the CUDA sources and
run on the CPU: the Montgomery products of csrc/field.cuh (``mul`` and
``mul_eo``) as their PTX carry chains, the tile schedule of
csrc/ntt.cu's twiddle transpose and the thread schedule of its tail
kernel.  Exact: products against a b R^-1 mod p, the transpose against
the index map out[b, c, r] = a[b, r, c], the tail against the plain
stages."""

import pathlib
import random
import re

import pytest

from za_tpu_torch.curve import Q, R

CSRC = pathlib.Path(__file__).resolve().parents[1] / "za_tpu_torch" / "csrc"
FIELD = (CSRC / "field.cuh").read_text()
NTT = (CSRC / "ntt.cu").read_text()
M32 = (1 << 32) - 1


# -- a model of the PTX the products are written in ----------------------------


class Ptx:
    """The inline asm blocks of a __device__ function, in order: their
    instructions and operands ("e[3]", "b", "0u", ...), run on a dict of
    words and arrays with the carry flag of PTX's .cc instructions.  No
    carry crosses two blocks."""

    def __init__(self, fn: str):
        body = re.search(r"void " + fn + r"\((.*?)\n\}", FIELD, re.S)
        assert body, fn
        self.blocks = []
        for part in body.group(1).split("asm(")[1:]:
            code = [ln.strip().rstrip(";")
                    for ln in re.findall(r'"([^"]*?)(?:\\n\\t)?"', part)
                    if re.match(r"[a-z][a-z0-9.]* ", ln.strip())]
            self.blocks.append(
                (code, re.findall(r'"[=+]?r"\(([^)]*)\)', part)))
        assert self.blocks, fn

    @property
    def code(self):
        return [ln for code, _ in self.blocks for ln in code]

    @staticmethod
    def _get(env, name):
        if re.fullmatch(r"\d+u?", name):
            return int(name.rstrip("u"))
        m = re.fullmatch(r"(\w+)\[(\d+)\]", name)
        if m:
            return env[m.group(1)][int(m.group(2))]
        return env[name]

    @staticmethod
    def _set(env, name, v):
        m = re.fullmatch(r"(\w+)\[(\d+)\]", name)
        env[m.group(1)][int(m.group(2))] = v

    def __call__(self, env: dict) -> None:
        for code, operands in self.blocks:
            self._run(code, operands, env)

    def _run(self, code, operands, env) -> None:
        def val(tok):
            tok = tok.strip()
            m = re.fullmatch(r"%(\d+)", tok)
            return (self._get(env, operands[int(m.group(1))]) if m
                    else int(tok, 0))

        cf = None                          # no carry before the block
        for line in code:
            op, args = line.split(None, 1)
            toks = args.split(",")
            vals = [val(t) for t in toks[1:]]
            parts = op.split(".")
            base = parts[0]
            cin = base in ("madc", "addc", "subc")
            if cin:
                assert cf is not None, f"carry read before set: {line}"
            c = cf if cin else 0
            if base in ("mul", "mad", "madc"):
                prod = vals[0] * vals[1]
                w = prod & M32 if "lo" in parts else prod >> 32
                s = w + (vals[2] if base != "mul" else 0) + c
            elif base in ("add", "addc"):
                s = vals[0] + vals[1] + c
            elif base in ("sub", "subc"):
                s = vals[0] - vals[1] - c
            else:
                raise AssertionError(f"unmodelled instruction {line}")
            if "cc" in parts:
                cf = int(s > M32) if base[:3] != "sub" else int(s < 0)
            elif base != "mul":
                cf = None                  # a chain ends here
            dst = re.fullmatch(r"%(\d+)", toks[0].strip()).group(1)
            self._set(env, operands[int(dst)], s & M32)


def _words(v):
    return [(v >> (32 * i)) & M32 for i in range(8)]


def _value(w):
    return sum(x << (32 * i) for i, x in enumerate(w))


def _np0(params: str) -> int:
    body = re.search(r"struct " + params + r" \{.*?\n\};", FIELD, re.S).group(0)
    return int(re.search(r"np0 = (0x[0-9a-f]+)u", body).group(1), 16)


def _reduce_once(t, p):
    v = _value(t)
    return v - p if v >= p else v


def model_mul(a, b, p, np0):
    """csrc/field.cuh mul: CIOS rows of two mad_row chains each."""
    row = Ptx("mad_row")
    t = [0] * 9
    pw = _words(p)
    for i in range(8):
        env = {"t": t, "a": _words(a), "b": _words(b)[i]}
        row(env)
        m = (t[0] * np0) & M32
        row({"t": t, "a": pw, "b": m})
        t = t[1:] + [0]
    return _reduce_once(t, p)


def model_mul_eo(a, b, p, np0):
    """csrc/field.cuh mul_eo: the even and odd accumulators, roles
    swapped after every row, as its C++ body calls the asm blocks."""
    first, redc, row, merge = (Ptx(f) for f in (
        "eo_first", "eo_redc", "eo_row", "eo_merge"))
    aw, bw, pw = _words(a), _words(b), _words(p)
    e, o = [0] * 8, [0] * 8
    first({"e": e, "o": o, "a": aw, "b": bw[0]})
    redc({"e": e, "o": o, "p": pw, "m": (e[0] * np0) & M32})
    for i in range(1, 8):
        ev, od = (e, o) if i & 1 else (o, e)
        row({"e": ev, "o": od, "a": aw, "b": bw[i]})
        redc({"e": od, "o": ev, "p": pw, "m": (od[0] * np0) & M32})
    r = [0] * 8
    merge({"r": r, "e": o, "o": e})
    return _reduce_once(r, p)


def test_mul_eo_calls_its_blocks_as_the_model_does():
    """The C++ body of mul_eo: the first row, then rows 1..7 alternating
    (e, o) and (o, e), the merge from (o, e)."""
    body = re.search(r"Fp<P> mul_eo\(.*?\n\}", FIELD, re.S).group(0)
    calls = re.findall(r"(eo_\w+)\(([^;]*)\);", body)
    assert [(f, a.split(",")[:2]) for f, a in calls] == [
        ("eo_first", ["e", " o"]), ("eo_redc", ["e", " o"]),
        ("eo_row", ["e", " o"]), ("eo_redc", ["o", " e"]),
        ("eo_row", ["o", " e"]), ("eo_redc", ["e", " o"]),
        ("eo_merge", ["r", " o"])]
    assert "for (int i = 1; i < 8; ++i)" in body and "if (i & 1)" in body


def _cases(p, seed, n=12):
    rng = random.Random(seed)
    edge = [0, 1, p - 1, 2, p - 2, (1 << 255) % p]
    vals = edge + [rng.randrange(p) for _ in range(n)]
    return [(a, b) for a in vals[:6] for b in vals[:6]] + list(
        zip(vals[6:], reversed(vals[6:])))


@pytest.mark.parametrize("model", [model_mul, model_mul_eo],
                         ids=["mul", "mul_eo"])
@pytest.mark.parametrize("p,params", [(R, "RParams"), (Q, "QParams")],
                         ids=["fr", "fq"])
def test_product_model_gives_a_b_over_r(model, p, params):
    """Every product a b R^-1 mod p, canonical, on 0, 1, p - 1, 2,
    p - 2, 2^255 mod p and random values."""
    np0 = _np0(params)
    assert (np0 * p) % (1 << 32) == M32          # -p^-1 mod 2^32
    rinv = pow(1 << 256, -1, p)
    for a, b in _cases(p, 5 if p == R else 6):
        assert model(a, b, p, np0) == a * b * rinv % p, (a, b)


def test_product_model_reads_no_carry_across_blocks():
    """Each asm block of the products starts its carry chains itself:
    the first carry-in instruction of a block follows a .cc one."""
    for fn in ("mad_row", "eo_first", "eo_redc", "eo_row", "eo_merge"):
        code = Ptx(fn).code
        first_in = next((i for i, ln in enumerate(code)
                         if ln.split()[0].split(".")[0] in ("madc", "addc")),
                        None)
        if first_in is not None:
            assert ".cc" in code[first_in - 1].split()[0], fn


# -- the twiddle transpose's tile schedule ----------------------------------------


def _tw_constants():
    """TW_V, TW_R, TW_C of csrc/ntt.cu, after checking that the kernel
    maps threads, tile slots and blocks as the model below does."""
    for text in ("__shared__ uint32_t tile[8][TW_C][TW_R + 1];",
                 "const int ri = threadIdx.x / (TW_C / TW_V);",
                 "const int cl = threadIdx.x % (TW_C / TW_V) * TW_V;",
                 "const int n = r < R && c < C ? min(TW_V, C - c) : 0;",
                 "tile[q][cl + k][ri] = p.v[q];",
                 "const int ci = threadIdx.x / (TW_R / TW_V);",
                 "const int rl = threadIdx.x % (TW_R / TW_V) * TW_V;",
                 "const int n = c < C && r < R ? min(TW_V, R - r) : 0;",
                 "w[k] = tile[q][ci][rl + k];",
                 "const size_t dst = base + (size_t)c * R + r;",
                 "(C + za::TW_C - 1) / za::TW_C",
                 "(R + za::TW_R - 1) / za::TW_R",
                 "constexpr int TW_TB = TW_R * TW_C / TW_V;"):
        assert text in NTT, text
    v = int(re.search(r"#define ZA_TW_COLS (\d+)", NTT).group(1))
    r = int(re.search(r"#define ZA_TW_ROWS (\d+)", NTT).group(1))
    c = int(re.search(r"constexpr int TW_C = (\d+);", NTT).group(1))
    return v, r, c


def _tw_schedule(B, R_, C, v, tr, tc):
    """The kernel's two phases over every block of the grid -> (products
    as (b, r, c) rows, stores as (b, c, r, source r, source c) rows)."""
    import numpy as np

    gx, gy = -(-C // tc), -(-R_ // tr)
    tb = tr * tc // v
    bz, by, bx, t, k = (a.ravel() for a in np.meshgrid(
        np.arange(B), np.arange(gy), np.arange(gx), np.arange(tb),
        np.arange(v), indexing="ij"))
    block = (bz * gy + by) * gx + bx
    # phase 1: row r, columns c + k, into slot (column cl + k, row ri)
    ri, cl = t // (tc // v), t % (tc // v) * v
    r, c = by * tr + ri, bx * tc + cl
    n = np.where((r < R_) & (c < C), np.minimum(v, C - c), 0)
    live = k < n
    slot = (block * tc + cl + k) * (tr + 1) + ri
    assert np.unique(slot[live]).size == live.sum(), "a slot written twice"
    src_r = np.full(block.max() * tc * (tr + 1) + tc * (tr + 1), -1)
    src_c = src_r.copy()
    src_r[slot[live]], src_c[slot[live]] = r[live], c[live] + k[live]
    products = np.stack([bz[live], r[live], c[live] + k[live]], 1)
    # phase 2: column c, rows r + k, from slot (column ci, row rl + k)
    ci, rl = t // (tr // v), t % (tr // v) * v
    c2, r2 = bx * tc + ci, by * tr + rl
    n2 = np.where((c2 < C) & (r2 < R_), np.minimum(v, R_ - r2), 0)
    live2 = k < n2
    slot2 = (block * tc + ci) * (tr + 1) + rl + k
    stores = np.stack([bz[live2], c2[live2], r2[live2] + k[live2],
                       src_r[slot2[live2]], src_c[slot2[live2]]], 1)
    return products, stores


@pytest.mark.parametrize("B,R_,C", [(3, 128, 128), (3, 512, 512),
                                    (2, 37, 70), (1, 4, 3), (3, 16, 32),
                                    (3, 32, 64)],
                         ids=["2^13", "2^17", "ragged", "tiny", "2^9",
                              "2^11"])
def test_twiddle_tile_schedule_model(B, R_, C):
    """Every (b, r, c) is multiplied once and lands at (b, c, r), every
    output is written once, on the rungs' shapes, a ragged shape and one
    smaller than a tile."""
    import numpy as np

    v, tr, tc = _tw_constants()
    products, stores = _tw_schedule(B, R_, C, v, tr, tc)
    assert len(products) == len(stores) == B * R_ * C
    key = (products[:, 0] * R_ + products[:, 1]) * C + products[:, 2]
    assert np.unique(key).size == B * R_ * C       # each product once
    b, c, r, sr, sc = stores.T
    assert np.unique((b * C + c) * R_ + r).size == B * R_ * C
    assert np.array_equal(sr, r) and np.array_equal(sc, c)


def test_twiddle_tile_accesses():
    """Shared memory: a warp's writes (one row, TW_V columns a thread)
    of one limb plane and one k hit 32 banks, its reads (one column,
    TW_V rows) at most two ways, as csrc/ntt.cu's note says.  Global
    memory: with R and C multiples of TW_V every live thread moves TW_V
    words at an index that is a multiple of TW_V (the kernel's 16-byte
    accesses)."""
    import numpy as np

    v, tr, tc = _tw_constants()
    assert "its\n// column reads two ways" in NTT
    t = np.arange(tr * tc // v)
    for k in range(v):
        w1 = (t % (tc // v) * v + k) * (tr + 1) + t // (tc // v)
        w2 = (t // (tr // v)) * (tr + 1) + t % (tr // v) * v + k
        for w, ways in ((w1, 1), (w2, 2)):
            for warp in w.reshape(-1, 32):
                assert np.bincount(warp % 32).max() <= ways
    R_, C = 36, 72
    ri, cl = t // (tc // v), t % (tc // v) * v
    for by in range(-(-R_ // tr)):
        for bx in range(-(-C // tc)):
            r, c = by * tr + ri, bx * tc + cl
            live = (r < R_) & (c < C)
            assert np.all(np.minimum(v, C - c[live]) == v)
            assert np.all((r[live] * C + c[live]) % v == 0)
            ci, rl = t // (tr // v), t % (tr // v) * v
            c2, r2 = bx * tc + ci, by * tr + rl
            live2 = (c2 < C) & (r2 < R_)
            assert np.all((c2[live2] * R_ + r2[live2]) % v == 0)


# -- the tail kernel's thread schedule --------------------------------------------


def _tail_constants():
    """TAIL_MAX_STAGES and TAIL_TB of csrc/ntt.cu, after checking that
    ntt_tail_kernel maps threads to rows and twiddles as the model below
    does and that engine/ntt.py splits a tail into launches as
    _tail_launches does."""
    from za_tpu_torch.engine import ntt

    for text in ("const unsigned per = (unsigned)(S >> s) * (unsigned)L;",
                 "const unsigned b = t / per, r = t - b * per;",
                 "const unsigned g = r / (unsigned)L, l = r - g * (unsigned)L;",
                 "const unsigned seg = g >> log_hb, j = g & (unsigned)(hb - 1);",
                 "const size_t row0 = (size_t)seg * V * hb + j;",
                 "load(v[q], x, plane, b * sl + (row0 + (size_t)q * hb) * L + l);",
                 "const size_t step = step0 >> u;",
                 "const size_t k = j + (size_t)e * hb;",
                 "w.v[qq] = __ldg(tw + (size_t)qq * (S / 2) + k * step);",
                 "for (int hi = 0; hi < (V >> (u + 1)); ++hi) {",
                 "const int q = (hi << (u + 1)) | e;",
                 "const Fr vt = TailMul::f(v[q + (1 << u)], w);",
                 "v[q + (1 << u)] = sub(v[q], vt);",
                 "v[q] = add(v[q], vt);",
                 "const size_t dst = (row0 + (size_t)q * hb) * L + l;",
                 "(unsigned)((total + za::TAIL_TB - 1) / za::TAIL_TB)"):
        assert text in NTT, text
    stages = int(re.search(r"constexpr int TAIL_MAX_STAGES = (\d+);",
                           NTT).group(1))
    tb = int(re.search(r"constexpr int TAIL_TB = (\d+);", NTT).group(1))
    assert stages == ntt.TAIL_MAX_STAGES
    return stages, tb


def _tail_launches(S, start, most):
    """(hb, s) of each launch of engine/ntt.py ntt_stages."""
    h, left, out = start // 2, (S // (start // 2)).bit_length() - 1, []
    while True:
        s = min(left, most)
        out.append((h, s))
        if s == left:
            return out
        h, left = h << s, left - s


def _tail_threads(B, S, L, hb, s, tb):
    """Every live thread of one launch (blocks of tb threads) -> its
    (b, l, j, row0), as ntt_tail_kernel derives them."""
    import numpy as np

    per = (S >> s) * L
    total = B * per
    t = np.arange(-(-total // tb) * tb)
    t = t[t < total]
    b, r = t // per, t % per
    g, l = r // L, r % L
    log_hb = hb.bit_length() - 1
    seg, j = g >> log_hb, g & (hb - 1)
    return b, l, j, seg * (1 << s) * hb + j


def _tail_butterflies(s):
    """(u, e, q, q + 2^u) of one thread's butterflies, in its order."""
    return [(u, e, q, q + (1 << u))
            for u in range(s) for e in range(1 << u)
            for q in [(hi << (u + 1)) | e
                      for hi in range((1 << s) >> (u + 1))]]


@pytest.mark.parametrize("B,S,L,start", [
    (3, 1024, 2048, 1024), (3, 2048, 1024, 1024), (1, 2048, 1024, 1024),
    (2, 64, 8, 8), (1, 256, 8, 2), (2, 128, 24, 16)],
    ids=["a", "b", "c", "t3", "8-stages", "L24"])
def test_tail_schedule_model(B, S, L, start):
    """The tail's launches at the 2^20 rung's shapes (a)-(c), a tail of 3
    stages, one of 8 (three launches) and a lane count off the warp:
    each butterfly of the stages of lengths start..S done once, on a
    top row whose bit h is clear and its partner h rows down, with the
    twiddle index of the plain stages (engine/ntt.py _stages16: table
    index (row mod h) S / 2h)."""
    import numpy as np

    most, tb = _tail_constants()
    launches = _tail_launches(S, start, most)
    assert sum(s for _, s in launches) == (S // start).bit_length()
    assert len(launches) == -(-(S // start).bit_length() // most)
    for hb, s in launches:
        b, l, j, row0 = _tail_threads(B, S, L, hb, s, tb)
        assert b.size == B * L * S >> s
        seen = {}
        for u, e, q, p in _tail_butterflies(s):
            h = hb << u
            top, low = row0 + q * hb, row0 + p * hb
            assert np.all(low == top + h) and np.all(top % (2 * h) < h)
            k = j + e * hb                      # the kernel's twiddle
            assert np.array_equal(k * ((S // 2 // hb) >> u),
                                  (top % h) * (S // (2 * h)))
            key = (b * S + top) * L + l
            seen.setdefault(h, []).append(key)
        for h, keys in seen.items():        # S/2 butterflies a stage
            keys = np.concatenate(keys)
            assert keys.size == B * L * S // 2
            assert np.unique(keys).size == keys.size, h


@pytest.mark.parametrize("B,S,L,start,store", [
    (2, 64, 8, 8, False), (1, 32, 4, 2, True), (1, 16, 3, 16, True)],
    ids=["t3", "5-stages-store", "t1-store"])
def test_tail_model_runs_the_plain_stages(B, S, L, start, store):
    """The model's schedule run on values (Python ints mod r, Montgomery
    products as a b R^-1) equals ntt_stages_plain, the store mode too:
    the plain product by the table, 16-bit limbs."""
    import numpy as np
    import torch

    from za_tpu_torch.engine import field as F, ntt
    from za_tpu_torch.groth16.domain import Domain

    most, tb = _tail_constants()
    rng = random.Random(S + start)
    rinv = pow(1 << 256, -1, R)
    x = [rng.randrange(R) for _ in range(B * S * L)]
    tw = [pow(Domain(S).omega, k, R) * (1 << 256) % R
          for k in range(S // 2)]
    table = [rng.randrange(R) for _ in range(S * L)] if store else None
    v = [a * (1 << 256) % R for a in x]          # Montgomery
    launches = _tail_launches(S, start, most)
    for n, (hb, s) in enumerate(launches):
        b, l, j, row0 = _tail_threads(B, S, L, hb, s, tb)
        for bi, li, ji, r0 in zip(b.tolist(), l.tolist(), j.tolist(),
                                  row0.tolist()):
            idx = [(bi * S + r0 + q * hb) * L + li for q in range(1 << s)]
            w = [v[i] for i in idx]
            for u, e, q, p in _tail_butterflies(s):
                k = (ji + e * hb) * ((S // 2 // hb) >> u)
                vt = w[p] * tw[k] * rinv % R
                w[p], w[q] = (w[q] - vt) % R, (w[q] + vt) % R
            if store and n == len(launches) - 1:   # plain product
                w = [a * table[i % (S * L)] * rinv % R
                     for a, i in zip(w, idx)]
            for i, a in zip(idx, w):
                v[i] = a
    x32 = torch.from_numpy(F.ints_to_l32(
        [a * (1 << 256) % R for a in x]).copy()).reshape(8, B, S, L)
    tw32 = torch.from_numpy(F.ints_to_l32(tw).copy())
    tab = (torch.from_numpy(F.ints_to_l32(table).copy()) if store
           else None)
    want = ntt.ntt_stages_plain(x32, tw32, start, tab)
    if store:
        assert want.shape == (16, B, S, L)
        got = F.limbs_to_ints(np.asarray(want.reshape(16, -1)))
    else:
        got = [a * rinv % R for a in F.limbs_to_ints(
            np.asarray(F.unpack(want).reshape(16, -1)))]
        v = [a * rinv % R for a in v]
    assert got == v


def test_mul_eo_users_and_to_affine_inversions():
    """mul_eo is the product of ntt_twiddle_fr, of the tail kernel
    (ntt_stage_fr: its butterflies and its store), of to_affine_g1/_g2's
    per-point products (Karatsuba over it in G2) and of ec_add_g2's
    and the G2 fixed-base kernels' thread adds (OpsEo: Karatsuba over
    mul_eo); every other kernel keeps mul.  Both to_affine kernels are
    the one-wave
    to_affine_wave_kernel and invert each block's product with inv_gcd
    (Gcd), G2 through the norm: no Fermat and no multi-wave kernel is
    left in ec.cu; the matvec keeps mul."""
    users = {f.name: re.sub(r"//.*", "", f.read_text()).count("mul_eo")
             for f in sorted(CSRC.glob("*.cu"))}
    assert users == {"dense.cu": 0, "ec.cu": 1, "fixed_base.cu": 0,
                     "ntt.cu": 2, "r1cs.cu": 0, "tree.cu": 0}, users
    ntt, ec = NTT, (CSRC / "ec.cu").read_text()
    code = re.sub(r"//.*", "", ec)
    assert "#define ZA_TW_MUL mul_eo" in ntt
    assert "const Fr p = ZA_TW_MUL(x, w);" in ntt
    # the tail's butterflies and its store (TailMul), the prefix on mul
    assert re.search(r"struct TailMul \{\s+__device__ static __forceinline__ "
                     r"Fr f\(const Fr& a, const Fr& b\) \{\s+"
                     r"return mul_eo\(a, b\);", ntt)
    assert "const Fr vt = TailMul::f(v[q + (1 << u)], w);" in ntt
    assert "store_out<TailMul>(" in ntt and "store_out<PrefixMul>(" in ntt
    assert "const Fr vt = mul(v, w);" in ntt     # the prefix's butterfly
    assert "#define ZA_AFF_MUL mul_eo" in ec
    assert "#define ZA_AFF_INV Gcd" in ec
    assert "launch_affine_wave<za::Fq, za::ZA_AFF_INV>" in ec
    assert "launch_affine_wave<za::Fq2, za::ZA_AFF_INV>" in ec
    assert "Fq inv_acc = block_inverse<Fq, AFF_TB, Inv>(acc, tree);" in ec
    assert "Fermat" not in code and "to_affine_kernel" not in code
    assert "za::launch_add<za::Fq, za::Ops>(" in ec
    assert "za::launch_add<za::Fq2, za::OpsEo>(" in ec
    fb = (CSRC / "fixed_base.cu").read_text()
    for launch in ("launch_table", "launch_msm"):
        assert f"za::{launch}<za::Fq, za::Ops>(" in fb
        assert f"za::{launch}<za::Fq2, za::OpsEo>(" in fb
    curve = (CSRC / "curve.cuh").read_text()
    assert "using OpsEo = OpsKaratsuba<MulEo>;" in curve
    assert re.search(r"struct MulEo \{\s+__device__ static __forceinline__ "
                     r"Fq f\(const Fq& a, const Fq& b\) \{\s+"
                     r"return mul_eo\(a, b\);", curve)
    r1cs = (CSRC / "r1cs.cu").read_text()
    assert "return mul(c, x);" in r1cs


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
@pytest.mark.parametrize("slots", [528, 792])
@pytest.mark.parametrize("n", [1, 127, 128, 1000, 3 * 1024 + 5,
                               8 * 3 * (1 << 16)])
def test_to_affine_wave_covers_every_point_once(n, slots, g2):
    """launch_affine_wave's split (affine_split), as csrc/ec.cu computes
    it for both groups' launches: at most as many blocks as the card
    holds at once, J points a thread, block b the points [b J TB, (b +
    1) J TB) of n, thread t those at t + j TB: every point once (in G2
    n up to a tree block's 8 2^15 points)."""
    import numpy as np

    ec = (CSRC / "ec.cu").read_text()
    for text in ("J = (int)((threads + slots - 1) / slots);",
                 "return (threads + J - 1) / J;",
                 "const long blocks = affine_split<F, Inv>(n, J);",
                 "const size_t i0 = (size_t)blockIdx.x * J * AFF_TB "
                 "+ threadIdx.x;",
                 "const size_t i = i0 + (size_t)j * AFF_TB;",
                 f"launch_affine_wave<za::{'Fq2' if g2 else 'Fq'}, "):
        assert text in ec, text
    if g2:
        n = min(n, 8 * (1 << 15))
    tb = int(re.search(r"constexpr int AFF_TB = (\d+);", ec).group(1))
    threads = -(-n // tb)
    J = -(-threads // slots)
    blocks = -(-threads // J)
    assert blocks <= slots
    b, j, t = (a.ravel() for a in np.meshgrid(
        np.arange(blocks), np.arange(J), np.arange(tb), indexing="ij"))
    i = (b * J * tb + t) + j * tb
    i = i[i < n]
    assert i.size == n and np.unique(i).size == n
