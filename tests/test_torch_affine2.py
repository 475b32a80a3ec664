"""A model of csrc/ec.cu's one-wave to_affine (to_affine_wave_kernel, G1
and G2) run on the CPU in field values: the launch's split (J points a
thread, blocks that fit on the card at once), each thread's prefix
products of its points' keys (Z in G1, the norm N(Z) = Z0^2 + Z1^2 in
Fq in G2) parked beside the point, the block's product tree over its
threads with one inversion at the root, and the walk back (1/Z =
conj(Z) N(Z)^-1 in G2; Z = 0 -> (0, 0)).  Held exactly against the
plain version (engine.ec.to_affine_plain) and, on the points it
defines, the reference's msm_tree._normalize_affine."""

import pathlib
import random
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import za_tpu.engine.msm_tree as ZMT
import za_tpu.engine.rns as RNS
from za_tpu_torch.curve import Q
from za_tpu_torch.engine import ec, field as F

CSRC = pathlib.Path(__file__).resolve().parents[1] / "za_tpu_torch" / "csrc"
EC = (CSRC / "ec.cu").read_text()
FIELD = (CSRC / "field.cuh").read_text()
TB = int(re.search(r"constexpr int AFF_TB = (\d+);", EC).group(1))
CTX = RNS.RQ


# -- field values: Fq ints, Fq2 pairs ----------------------------------------


def f2mul(a, b):
    return ((a[0] * b[0] - a[1] * b[1]) % Q, (a[0] * b[1] + a[1] * b[0]) % Q)


def is_zero(v):
    return v == (0, 0) if isinstance(v, tuple) else v == 0


def mul(a, b, g2):
    return f2mul(a, b) if g2 else a * b % Q


def key(z, g2):
    """What the batch inversion inverts for a Z: Z, or its norm."""
    return (z[0] * z[0] + z[1] * z[1]) % Q if g2 else z


def inv_from_key(z, ki, g2):
    """1/Z from the key's inverse: ki, or conj(Z) ki."""
    return (z[0] * ki % Q, -z[1] * ki % Q) if g2 else ki


def block_inverse(accs):
    """field.cuh block_inverse: a product tree over the TB threads'
    values in shared memory, the root inverted by one thread, the tree
    unwound (inv(left) = inv(parent) right)."""
    tree = [None] * TB + list(accs)
    s = TB // 2
    while s >= 1:
        for t in range(s):
            tree[s + t] = tree[2 * (s + t)] * tree[2 * (s + t) + 1] % Q
        s //= 2
    tree[1] = pow(tree[1], -1, Q)
    s = 1
    while s < TB:
        for t in range(s):
            nd = s + t
            iv, lft, rgt = tree[nd], tree[2 * nd], tree[2 * nd + 1]
            tree[2 * nd] = iv * rgt % Q
            tree[2 * nd + 1] = iv * lft % Q
        s *= 2
    return tree[TB:]


def split(n, slots):
    """launch_affine_wave's split (affine_split): J points a thread, so
    that the blocks fit the card's slots at once."""
    threads = -(-n // TB)
    J = -(-threads // slots)
    return J, -(-threads // J)


def wave_model(X, Y, Z, slots, g2):
    """to_affine_wave_kernel on lists of values -> (x, y) lists."""
    n = len(Z)
    J, blocks = split(n, slots)
    assert blocks <= slots
    x, y = [None] * n, [None] * n
    parked = {}
    for b in range(blocks):
        accs, walks = [], []
        for t in range(TB):
            i0 = b * J * TB + t
            left = n - i0 + TB - 1               # C's division: toward 0
            left = left // TB if left >= 0 else -(-left // TB)
            m = 0 if left < 0 else min(left, J)
            acc = 1
            for j in range(m):                   # prefixes of nonzero keys
                i = i0 + j * TB
                k = key(Z[i], g2)
                assert i not in parked
                parked[i] = (acc, k)             # x's planes (c0, c1)
                if k != 0:
                    acc = acc * k % Q
            accs.append(acc)
            walks.append((i0, m))
        for (i0, m), inv_acc in zip(walks, block_inverse(accs)):
            for j in range(m - 1, -1, -1):       # the walk back
                i = i0 + j * TB
                pre, k = parked[i]
                zi = (0, 0) if g2 else 0
                if k != 0:
                    zi = inv_from_key(Z[i], inv_acc * pre % Q, g2)
                    inv_acc = inv_acc * k % Q
                x[i], y[i] = mul(X[i], zi, g2), mul(Y[i], zi, g2)
    assert len(parked) == n and None not in x
    return x, y


# -- encodings --------------------------------------------------------------


def rand_values(rng, n, g2):
    if g2:
        return [(rng.randrange(Q), rng.randrange(Q)) for _ in range(n)]
    return [rng.randrange(Q) for _ in range(n)]


def to_port(vals, g2):
    """Values -> l32 Montgomery (8, n), or (8, 2, n) in G2."""
    def enc(v):
        t = torch.from_numpy(F.ints_to_limbs(v).astype(np.int64))
        return F.pack(F.FQ.to_mont(t))

    if g2:
        return torch.stack([enc([v[0] for v in vals]),
                            enc([v[1] for v in vals])], dim=1)
    return enc(vals)


def from_port(t, g2):
    def dec(c):
        return [F.FQ.from_mont_int(v) for v in F.l32_to_ints(c.numpy())]

    if g2:
        return list(zip(dec(t[:, 0]), dec(t[:, 1])))
    return dec(t)


def zeroed(Z, g2, whole=()):
    """Every seventh Z zero, the points in `whole` too; in G2 Z with
    only c0 or only c1 zero beside them."""
    Z = list(Z)
    for i in range(len(Z)):
        if i % 7 == 0 or i in whole:
            Z[i] = (0, 0) if g2 else 0
        elif g2 and i % 7 == 1:
            Z[i] = (0, Z[i][1] or 1)
        elif g2 and i % 7 == 2:
            Z[i] = (Z[i][0] or 1, 0)
    return Z


def test_model_follows_the_source():
    """The lines of ec.cu and field.cuh the model above transcribes."""
    for text in (
            "const Fq k = A::key(z);",
            "store(x, n, i, A::park(acc, k));",
            "if (!is_zero(k)) acc = aff_mul(acc, k);",
            "Fq inv_acc = block_inverse<Fq, AFF_TB, Inv>(acc, tree);",
            "const Fq k = A::key(pk, z);",
            "zi = A::inv(z, aff_mul(inv_acc, A::pre(pk)));",
            "inv_acc = aff_mul(inv_acc, k);",
            "store(x, n, i, aff_mul(a, zi));",
            "store(y, n, i, aff_mul(b, zi));",
            "return add(aff_mul(z.c0, z.c0), aff_mul(z.c1, z.c1));",
            "return Fq2{aff_mul(z.c0, ki), neg(aff_mul(z.c1, ki))};",
            "return Fq2{pre, k};",
            "J = (int)((threads + slots - 1) / slots);",
            "return (threads + J - 1) / J;",
            "const size_t i0 = (size_t)blockIdx.x * J * AFF_TB "
            "+ threadIdx.x;",
            "const long left = ((long)n - (long)i0 + AFF_TB - 1) / AFF_TB;",
            "const int m = left < 0 ? 0 : left < J ? (int)left : J;",
            "launch_affine_wave<za::Fq, za::ZA_AFF_INV>",
            "launch_affine_wave<za::Fq2, za::ZA_AFF_INV>"):
        assert text in EC, text
    for text in ("if (t < s) tree[s + t] = mul(tree[2 * (s + t)], "
                 "tree[2 * (s + t) + 1]);",
                 "if (t == 0) tree[1] = Inv::inv(tree[1]);",
                 "tree[2 * nd] = mul(iv, rgt);",
                 "tree[2 * nd + 1] = mul(iv, lft);"):
        assert text in FIELD, text


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
@pytest.mark.parametrize("n,slots,whole", [
    (1, 1, ()), (389, 1, ()), (1000, 2, ()), (1000, 3, range(256, 384)),
    (130, 1, range(130)), (777, 5, ())],
    ids=["one", "one-block", "two-blocks", "zero-thread-column",
         "all-zero", "five-blocks"])
def test_wave_model_matches_plain(g2, n, slots, whole):
    """The model at small ragged n (partial blocks and threads, J > 1),
    every seventh Z zero, a thread column or every point zero, in G2 Z
    with one zero component, equals to_affine_plain exactly."""
    rng = random.Random(n * 31 + slots + 7 * g2)
    X, Y, Z = (rand_values(rng, n, g2) for _ in range(3))
    Z = zeroed(Z, g2, set(whole))
    x, y = wave_model(X, Y, Z, slots, g2)
    px, py = ec.to_affine_plain(to_port(X, g2), to_port(Y, g2),
                                to_port(Z, g2), g2)
    assert from_port(px, g2) == x and from_port(py, g2) == y
    zero = (0, 0) if g2 else 0
    for i, z in enumerate(Z):
        if is_zero(z):
            assert x[i] == y[i] == zero


def _ref_planes(vals, g2, k):
    """8 k values (h-major) -> the reference's (HALF, 35[, 2], 1, k)
    Montgomery RNS planes."""
    flat = [c for v in vals for c in v] if g2 else vals
    res = CTX.ints_to_rns([CTX.to_mont_int(v) for v in flat])
    res = res.reshape((35, ZMT.HALF, 1, k) + ((2,) if g2 else ()))
    if g2:
        res = np.moveaxis(res, -1, 1)            # (35, 2, HALF, 1, k)
    return jnp.asarray(np.moveaxis(res, -3, 0).astype(np.uint16))


def _ref_values(planes, g2):
    a = np.moveaxis(np.asarray(planes), 0, -3)   # (35[, 2], HALF, 1, k)
    def dec(c):
        return [CTX.from_mont_int(v) % Q
                for v in CTX.rns_to_ints(c.reshape(35, -1))]
    if g2:
        return list(zip(dec(a[:, 0]), dec(a[:, 1])))
    return dec(a)


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_wave_model_matches_reference(g2):
    """On nonzero Z (the points the reference defines; its masked
    identity columns come out as bounded garbage), the model equals
    the reference's _normalize_affine over the same eight multiples
    of k columns, and the plain version."""
    k = 5
    rng = random.Random(40 + g2)
    X, Y, Z = (rand_values(rng, ZMT.HALF * k, g2) for _ in range(3))
    Z = [(z[0], z[1] or 1) if g2 else z or 1 for z in Z]
    x, y = wave_model(X, Y, Z, 1, g2)
    fld = ZMT.Fq2Adapter() if g2 else ZMT.FqAdapter()
    rx, ry = ZMT._normalize_affine(
        *(_ref_planes(v, g2, k) for v in (X, Y, Z)),
        jnp.zeros((1, k), dtype=bool), fld)
    assert _ref_values(rx, g2) == x and _ref_values(ry, g2) == y
    px, py = ec.to_affine_plain(to_port(X, g2), to_port(Y, g2),
                                to_port(Z, g2), g2)
    assert from_port(px, g2) == x and from_port(py, g2) == y


def test_staging_ptxas_names_follow_the_defaults():
    """chip_smoke.KERNEL_FN names the __global__ functions behind
    to_affine_g1/_g2 and ec_add_g1/_g2 as ec.cu's defaults instantiate
    them: to_affine_wave_kernel <Fq, ZA_AFF_INV> and <Fq2, ZA_AFF_INV>,
    and ec_add_kernel <F, products> as each entry point launches it (G1
    on Ops, G2 on an OpsKaratsuba)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", CSRC.parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    def default(name):
        return re.search(rf"#define {name} (\w+)", EC).group(1)

    def nested(ident):
        return f"NS_{len(ident)}{ident}E"

    inv = default("ZA_AFF_INV")
    wave = "_ZN2za21to_affine_wave_kernelI"
    assert cs.KERNEL_FN["to_affine_g1"] == (
        f"{wave}NS_2FpINS_7QParamsEEE{nested(inv)}")
    assert cs.KERNEL_FN["to_affine_g2"] == f"{wave}NS_3Fq2E{nested(inv)}"
    adds = dict(re.findall(r"za::launch_add<za::(\w+), za::(\w+)>\(", EC))
    assert adds.keys() == {"Fq", "Fq2"}, adds
    assert adds["Fq"] == "Ops"
    curve = (CSRC / "curve.cuh").read_text()
    mul = re.search(rf"using {adds['Fq2']} = OpsKaratsuba<(\w+)>;",
                    curve).group(1)
    add = "_ZN2za13ec_add_kernelI"
    assert cs.KERNEL_FN["ec_add_g1"] == (
        f"{add}NS_2FpINS_7QParamsEEE{nested('Ops')}")
    assert cs.KERNEL_FN["ec_add_g2"] == (
        f"{add}NS_3Fq2ENS_12OpsKaratsubaI{nested(mul)}EE")
