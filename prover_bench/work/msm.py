"""The least work of a proof's five MSMs, counted from the inputs alone,
whatever algorithm the prover runs.

For n points whose scalars have bit lengths b_i, a bucket method with
c-bit signed windows needs, over W(c) = ceil(max b / c) windows:
- one add a point a window its scalar reaches: sum_i ceil(b_i / c)
  (a zero scalar none);
- in each window the reduction of its 2^(c-1) buckets by running sums:
  2^c - 2 adds;
- to join the windows: (W - 1) c doublings and W - 1 adds.
The least over c = 1 .. 30 is the count.  An add is counted at the
fewest field products of a batch-affine add: G1 6 (3 in the batch
inversion, the slope, its square, y3); G2 17 (the same in Fq2: 3 Fq
products a product, 2 a square); a doubling at 7 (G1) and 16 (G2) Fq
products (dbl-2009-l).  A product is 256 multiply-adds (8 x 8 32-bit
limbs, lo and hi).  Bytes: each point (affine: 64 B in G1, 128 B in G2)
and each 32-byte scalar read once, the result written once.

A proof's MSMs: a, b1 (G1) and b2 (G2) over the nv variables with the
witness as scalars, l over the aux variables, h (G1) over m - 1 points
whose scalars are h(x)'s coefficients.  Those are no input: they are
counted at full width (254 bits), as the coefficients of a transform
are uniform in Fr.
"""

from __future__ import annotations

from collections import Counter

ADD_PRODUCTS = {"g1": 6, "g2": 17}
DBL_PRODUCTS = {"g1": 7, "g2": 16}
POINT_BYTES = {"g1": 64, "g2": 128}
SCALAR_BYTES = 32
FULL_BITS = 254

#: the port's MSM kernels (csrc/tree.cu, csrc/ec.cu, csrc/dense.cu) by
#: a part of their names in the device trace
KERNELS = ("tree_level_rolled_kernel", "ec_sum_kernel", "horner_warp",
           "ec_add_kernel", "dense_sums_kernel")


def products(bits: Counter, group: str) -> int:
    """Fewest field products of one MSM whose scalars have the bit
    lengths ``bits`` ({bit length: count})."""
    top = max((b for b, k in bits.items() if b and k), default=0)
    if top == 0:
        return 0
    best = None
    for c in range(1, 31):
        w = -(-top // c)
        adds = sum(k * -(-b // c) for b, k in bits.items())
        adds += w * ((1 << c) - 2) + (w - 1)
        p = adds * ADD_PRODUCTS[group] + (w - 1) * c * DBL_PRODUCTS[group]
        best = p if best is None else min(best, p)
    return best


def msm_bytes(n: int, group: str) -> int:
    return n * (POINT_BYTES[group] + SCALAR_BYTES) + POINT_BYTES[group]


def work(circuit: dict, witness: list, peaks: dict) -> dict:
    """{"products", "ops" (multiply-adds), "bytes"} of one proof's
    MSMs."""
    ni = circuit["num_inputs"]
    nv = ni + circuit["num_aux"]
    m = 1
    while m < len(circuit["a"]) + ni:
        m <<= 1
    zbits = Counter(v.bit_length() for v in witness)
    auxbits = Counter(v.bit_length() for v in witness[ni:])
    msms = [(zbits, nv, "g1"), (zbits, nv, "g1"), (auxbits, nv - ni, "g1"),
            (Counter({FULL_BITS: m - 1}), m - 1, "g1"), (zbits, nv, "g2")]
    prods = sum(products(b, g) for b, _, g in msms)
    nbytes = sum(msm_bytes(n, g) for _, n, g in msms)
    return {"products": prods, "ops": prods * peaks["mads_per_product"],
            "bytes": nbytes}
