"""The least work of a proof's h(x), counted from the inputs alone,
whatever algorithm the prover runs.

h = (A B - C) / Z on a coset, from the A, B, C legs on the domain of m
points: three inverse transforms, three coset transforms, one inverse
coset transform, each a radix-2 transform of (m / 2) log2 m butterflies
of which m - 1 have the twiddle 1 and need no product; the scalings
merged to the least: the iNTT's 1/m with the coset's powers (3 m
products), the combine a b (m) and the last transform's 1/m, coset
powers and 1/Z (m); the matvec one product an entry whose coefficient
is neither 0 nor 1.  A product is 256 multiply-adds.  Bytes: each
matrix entry (a 4-byte column and a 32-byte coefficient) and each
witness value read once, the three legs read once, h written once.
"""

from __future__ import annotations

TRANSFORMS = 7
ENTRY_BYTES = 4 + 32
ELEM_BYTES = 32

#: the port's h(x) kernels (csrc/r1cs.cu, csrc/ntt.cu) by a part of
#: their names in the device trace
KERNELS = ("r1cs_matvec_kernel", "ntt_prefix_kernel", "ntt_twiddle_kernel",
           "ntt_tail_kernel")


def butterfly_products(m: int) -> int:
    return (m // 2) * (m.bit_length() - 1) - (m - 1)


def work(circuit: dict, witness, peaks: dict) -> dict:
    """{"products", "ops" (multiply-adds), "bytes"} of one proof's
    h(x)."""
    ni = circuit["num_inputs"]
    nv = ni + circuit["num_aux"]
    m = 1
    while m < len(circuit["a"]) + ni:
        m <<= 1
    entries = products = 0
    for leg in ("a", "b", "c"):
        for row in circuit[leg]:
            for _, coef in row:
                if coef:
                    entries += 1
                    products += coef != 1
    products += TRANSFORMS * butterfly_products(m) + 5 * m
    nbytes = (entries * ENTRY_BYTES + nv * ELEM_BYTES
              + 3 * m * ELEM_BYTES + (m - 1) * ELEM_BYTES)
    return {"products": products, "ops": products * peaks["mads_per_product"],
            "bytes": nbytes}
