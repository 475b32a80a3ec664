#!/usr/bin/env python3
"""The h(x) and staging kernels of the port on one CUDA card: the
Montgomery product alone, ntt_twiddle_fr and r1cs_matvec_fr alone and
inside h(x), to_affine and ec_add alone and inside the table builds,
and their variants, each held exactly against its plain version.

    python3 tools/torch_hpipe_sweep.py [--root DIR] [--products]
        [--kernels] [--staging] [--tail] [--variants [ntt,ec]]
        [--out FILE]

--root DIR runs the za_tpu_torch package of another checkout (an older
commit unpacked with git archive): its kernels are built from its own
csrc/.  With no section flag every section runs (--variants only where
the checkout's sources take the variant macros).  Sections, each one
JSON line:

  products: a product-only microkernel (csrc/field.cuh of the checkout;
      this repository's products where the checkout lacks them, and the
      schoolbook-then-reduce variant "sos" below) at K independent
      products a thread, every resident block busy: M products/ms, the
      registers, and the SASS opcodes of one product (cuobjdump: the
      opcodes of a kernel that loads, multiplies once and stores, less
      those of the same kernel without the product);
  kernels: ntt_twiddle_fr, r1cs_matvec_fr and ntt_prefix_fr (no mode,
      scale_in, combine, scale_out) at the 2^17 and 2^13 rungs' shapes
      (chip_smoke.py's: the chain's three legs, the first sub-NTT's 3 x
      n2 x n1): "device_ms" (one call queued behind a sleep kernel,
      median of 5), "issue_ms" (5 calls back to back, the mean: what
      chip_smoke.py's ms recorded before device_ms; not for the
      prefix), ptxas registers and spill, the SASS opcodes of each
      kernel and a digest of its SASS text, and "h_ms"
      (one h(x) with every kernel launch between CUDA events, queued
      behind a sleep kernel, median of 5: each kernel's device time in
      its place, and the span of h);
  staging: to_affine_g1/_g2 at chip_smoke.py's shapes and ec_add_g1/_g2
      at the paths' widths (a tree staging block; in G2 also the 2^13
      rung's dense b_g2, 2^14 points), each exact: device_ms, issue_ms,
      ptxas registers and spill, SASS instructions and the digest of
      their text; then whole table builds with their launches: a tree
      staging block (build_tables_block: 7 ec_add and one to_affine) of
      each group and the 2^13 rung's dense G2 multiples (7 ec_add);
  tail: the stages above m_fuse of the 2^20 rung's sub-NTTs (domain
      2^21) at three shapes, (a) 3 x 1024 x 2048 (one stage), (b) 3 x
      2048 x 1024 (two), (c) 1 x 2048 x 1024 (two, then the store
      mode), each exact: on a checkout whose ntt_stage_fr runs a whole
      tail, its launch (device_ms; and with one stage a launch); on an
      older one each stage launch alone, the tensor store (store_plain)
      alone and the tail as its engine ran it; the kernel's registers,
      spill, SASS instructions and digest;
  variants (of the sources named, default both): builds of csrc/ntt.cu
      with its variant macros (ZA_TW_COLS, ZA_TW_ROWS, ZA_TW_MUL) and
      text patches of its tail kernel (products on mul, 128 or 512
      threads a block, at least 3 blocks an SM, the store table loaded
      before the stages) and of
      csrc/ec.cu with its own (ZA_AFF_INV: Fermat or inv_gcd at the
      blocks' roots, ZA_AFF_MUL: mul or mul_eo, and a build without the
      blocks' inversions, timed, not exact; text patches for ec_add_g2:
      one add a thread inlined on mul, or the staged add on 8 or 16
      lanes a pair, on mul or mul_eo), swapped into the engine's
      wrappers: each exact against the plain version, then the twiddle
      alone and inside h(x) at both rungs, the tail at its three
      shapes, to_affine_g1/_g2 alone at
      chip_smoke.py's shapes, ec_add_g2 alone at the paths' widths and
      inside the G2 table builds; with registers, spill and SASS
      instructions.
Then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import hashlib
import importlib.util
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent

# the schoolbook product first (even and odd chains a row), then eight
# reduction rows on 17 words, each row's carry out of word i + 8 kept in
# cw[i] and added once at the end
SOS = r"""
template <class P>
__device__ __forceinline__ Fp<P> mul_sos(const Fp<P>& a, const Fp<P>& b) {
  uint32_t e[17], o[17], t[17], cw[8], r[8], c = 0u;
#pragma unroll
  for (int i = 0; i < 17; ++i) e[i] = o[i] = t[i] = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) cw[i] = r[i] = 0u;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    asm("mul.lo.u32 %0, %4, %6;\n\tmul.hi.u32 %1, %4, %6;\n\t"
        "mul.lo.u32 %2, %5, %6;\n\tmul.hi.u32 %3, %5, %6;"
        : "+r"(e[2 * k]), "+r"(e[2 * k + 1]), "+r"(o[2 * k]),
          "+r"(o[2 * k + 1])
        : "r"(a.v[2 * k]), "r"(a.v[2 * k + 1]), "r"(b.v[0]));
  }
#pragma unroll
  for (int i = 1; i < 8; ++i) {
    asm("mad.lo.cc.u32 %0, %18, %26, %0;\n\t"
        "madc.hi.cc.u32 %1, %18, %26, %1;\n\t"
        "madc.lo.cc.u32 %2, %20, %26, %2;\n\t"
        "madc.hi.cc.u32 %3, %20, %26, %3;\n\t"
        "madc.lo.cc.u32 %4, %22, %26, %4;\n\t"
        "madc.hi.cc.u32 %5, %22, %26, %5;\n\t"
        "madc.lo.cc.u32 %6, %24, %26, %6;\n\t"
        "madc.hi.cc.u32 %7, %24, %26, %7;\n\t"
        "addc.u32 %8, %27, 0;\n\t"
        "mad.lo.cc.u32 %9, %19, %26, %9;\n\t"
        "madc.hi.cc.u32 %10, %19, %26, %10;\n\t"
        "madc.lo.cc.u32 %11, %21, %26, %11;\n\t"
        "madc.hi.cc.u32 %12, %21, %26, %12;\n\t"
        "madc.lo.cc.u32 %13, %23, %26, %13;\n\t"
        "madc.hi.cc.u32 %14, %23, %26, %14;\n\t"
        "madc.lo.cc.u32 %15, %25, %26, %15;\n\t"
        "madc.hi.cc.u32 %16, %25, %26, %16;\n\t"
        "addc.u32 %17, %27, 0;"
        : "+r"(e[i]), "+r"(e[i + 1]), "+r"(e[i + 2]), "+r"(e[i + 3]),
          "+r"(e[i + 4]), "+r"(e[i + 5]), "+r"(e[i + 6]), "+r"(e[i + 7]),
          "+r"(e[i + 8]), "+r"(o[i]), "+r"(o[i + 1]), "+r"(o[i + 2]),
          "+r"(o[i + 3]), "+r"(o[i + 4]), "+r"(o[i + 5]), "+r"(o[i + 6]),
          "+r"(o[i + 7]), "+r"(o[i + 8])
        : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]),
          "r"(a.v[4]), "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]),
          "r"(b.v[i]), "r"(0u));
  }
  t[0] = e[0];
  asm("add.cc.u32 %0, %9, %17;\n\t"
      "addc.cc.u32 %1, %10, %18;\n\t"
      "addc.cc.u32 %2, %11, %19;\n\t"
      "addc.cc.u32 %3, %12, %20;\n\t"
      "addc.cc.u32 %4, %13, %21;\n\t"
      "addc.cc.u32 %5, %14, %22;\n\t"
      "addc.cc.u32 %6, %15, %23;\n\t"
      "addc.cc.u32 %7, %16, %24;\n\t"
      "addc.u32 %8, %25, 0;"
      : "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]),
        "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(c)
      : "r"(e[1]), "r"(e[2]), "r"(e[3]), "r"(e[4]), "r"(e[5]), "r"(e[6]),
        "r"(e[7]), "r"(e[8]), "r"(o[0]), "r"(o[1]), "r"(o[2]), "r"(o[3]),
        "r"(o[4]), "r"(o[5]), "r"(o[6]), "r"(o[7]), "r"(0u));
  asm("add.cc.u32 %0, %7, %14;\n\t"
      "addc.cc.u32 %1, %8, %15;\n\t"
      "addc.cc.u32 %2, %9, %16;\n\t"
      "addc.cc.u32 %3, %10, %17;\n\t"
      "addc.cc.u32 %4, %11, %18;\n\t"
      "addc.cc.u32 %5, %12, %19;\n\t"
      "addc.u32 %6, %13, %20;\n\t"
      "add.cc.u32 %0, %0, %21;\n\t"
      "addc.cc.u32 %1, %1, 0;\n\t"
      "addc.cc.u32 %2, %2, 0;\n\t"
      "addc.cc.u32 %3, %3, 0;\n\t"
      "addc.cc.u32 %4, %4, 0;\n\t"
      "addc.cc.u32 %5, %5, 0;\n\t"
      "addc.u32 %6, %6, 0;"
      : "+r"(t[9]), "+r"(t[10]), "+r"(t[11]), "+r"(t[12]), "+r"(t[13]),
        "+r"(t[14]), "+r"(t[15])
      : "r"(e[9]), "r"(e[10]), "r"(e[11]), "r"(e[12]), "r"(e[13]),
        "r"(e[14]), "r"(e[15]), "r"(o[8]), "r"(o[9]), "r"(o[10]),
        "r"(o[11]), "r"(o[12]), "r"(o[13]), "r"(o[14]), "r"(c));
  t[16] = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t m = t[i] * P::np0;
    asm("mad.lo.cc.u32 %0, %10, %18, %0;\n\t"
        "madc.hi.cc.u32 %1, %10, %18, %1;\n\t"
        "madc.lo.cc.u32 %2, %12, %18, %2;\n\t"
        "madc.hi.cc.u32 %3, %12, %18, %3;\n\t"
        "madc.lo.cc.u32 %4, %14, %18, %4;\n\t"
        "madc.hi.cc.u32 %5, %14, %18, %5;\n\t"
        "madc.lo.cc.u32 %6, %16, %18, %6;\n\t"
        "madc.hi.cc.u32 %7, %16, %18, %7;\n\t"
        "addc.cc.u32 %8, %8, 0;\n\t"
        "addc.u32 %9, %19, 0;\n\t"
        "mad.lo.cc.u32 %1, %11, %18, %1;\n\t"
        "madc.hi.cc.u32 %2, %11, %18, %2;\n\t"
        "madc.lo.cc.u32 %3, %13, %18, %3;\n\t"
        "madc.hi.cc.u32 %4, %13, %18, %4;\n\t"
        "madc.lo.cc.u32 %5, %15, %18, %5;\n\t"
        "madc.hi.cc.u32 %6, %15, %18, %6;\n\t"
        "madc.lo.cc.u32 %7, %17, %18, %7;\n\t"
        "madc.hi.cc.u32 %8, %17, %18, %8;\n\t"
        "addc.u32 %9, %9, 0;"
        : "+r"(t[i]), "+r"(t[i + 1]), "+r"(t[i + 2]), "+r"(t[i + 3]),
          "+r"(t[i + 4]), "+r"(t[i + 5]), "+r"(t[i + 6]), "+r"(t[i + 7]),
          "+r"(t[i + 8]), "+r"(cw[i])
        : "r"(P::p(0)), "r"(P::p(1)), "r"(P::p(2)), "r"(P::p(3)),
          "r"(P::p(4)), "r"(P::p(5)), "r"(P::p(6)), "r"(P::p(7)), "r"(m),
          "r"(0u));
  }
  asm("add.cc.u32 %0, %8, %15;\n\t"
      "addc.cc.u32 %1, %9, %16;\n\t"
      "addc.cc.u32 %2, %10, %17;\n\t"
      "addc.cc.u32 %3, %11, %18;\n\t"
      "addc.cc.u32 %4, %12, %19;\n\t"
      "addc.cc.u32 %5, %13, %20;\n\t"
      "addc.u32 %6, %14, %21;\n\t"
      "mov.u32 %7, 0;"
      : "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]), "+r"(r[5]),
        "+r"(r[6]), "+r"(r[7]), "+r"(r[0])
      : "r"(t[9]), "r"(t[10]), "r"(t[11]), "r"(t[12]), "r"(t[13]),
        "r"(t[14]), "r"(t[15]), "r"(cw[0]), "r"(cw[1]), "r"(cw[2]),
        "r"(cw[3]), "r"(cw[4]), "r"(cw[5]), "r"(cw[6]));
  r[0] = t[8];
  return reduce_once<P>(r);
}
"""

MICRO = r"""
#include "field.cuh"

namespace za {
%(extra)s
%(sos)s
struct VMul {
  __device__ static __forceinline__ Fr f(const Fr& a, const Fr& b) {
    return mul(a, b);
  }
};
struct VEo {
  __device__ static __forceinline__ Fr f(const Fr& a, const Fr& b) {
    return mul_eo(a, b);
  }
};
struct VSos {
  __device__ static __forceinline__ Fr f(const Fr& a, const Fr& b) {
    return mul_sos(a, b);
  }
};
struct VNone {   // the probe without a product
  __device__ static __forceinline__ Fr f(const Fr& a, const Fr& b) {
    Fr r;
#pragma unroll
    for (int i = 0; i < 8; ++i) r.v[i] = a.v[i] ^ b.v[i];
    return r;
  }
};

// n threads, K values each at t + k n of (8, K n) planes; iters products
// on each, the loop not unrolled
template <class V, int K>
__global__ void rate_kernel(uint32_t* x, const uint32_t* y, long n,
                            int iters) {
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const size_t plane = (size_t)K * n;
  Fr a[K], b[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    load(a[k], x, plane, t + k * n);
    load(b[k], y, plane, t + k * n);
  }
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < K; ++k) a[k] = V::f(a[k], b[k]);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) store(x, plane, t + k * n, a[k]);
}

template <class V>
__global__ void probe_kernel(const uint32_t* x, const uint32_t* y,
                             uint32_t* out) {
  Fr a, b;
  load(a, x, 1, 0);
  load(b, y, 1, 0);
  store(out, 1, 0, V::f(a, b));
}

template <class V, int K>
int launch_rate(void* x, const void* y, long n, int iters, int tb,
                cudaStream_t s) {
  rate_kernel<V, K><<<(unsigned)((n + tb - 1) / tb), tb, 0, s>>>(
      (uint32_t*)x, (const uint32_t*)y, n, iters);
  return (int)cudaGetLastError();
}

template <class V, int K>
int resident(int tb) {
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks,
                                                rate_kernel<V, K>, tb, 0);
  return blocks;
}

}  // namespace za

#define ZA_V(name, V)                                                     \
  extern "C" int rate_##name(int k, void* x, const void* y, long n,        \
                             int iters, int tb, void* s) {                 \
    cudaStream_t st = (cudaStream_t)s;                                     \
    if (k == 1) return za::launch_rate<za::V, 1>(x, y, n, iters, tb, st);  \
    if (k == 2) return za::launch_rate<za::V, 2>(x, y, n, iters, tb, st);  \
    if (k == 4) return za::launch_rate<za::V, 4>(x, y, n, iters, tb, st);  \
    return (int)cudaErrorInvalidValue;                                     \
  }                                                                        \
  extern "C" int resident_##name(int k, int tb) {                          \
    if (k == 1) return za::resident<za::V, 1>(tb);                         \
    if (k == 2) return za::resident<za::V, 2>(tb);                         \
    return za::resident<za::V, 4>(tb);                                     \
  }                                                                        \
  extern "C" int probe_##name(const void* x, const void* y, void* out,     \
                              void* s) {                                   \
    za::probe_kernel<za::V><<<1, 1, 0, (cudaStream_t)s>>>(                 \
        (const uint32_t*)x, (const uint32_t*)y, (uint32_t*)out);           \
    return (int)cudaGetLastError();                                        \
  }

ZA_V(mul, VMul)
ZA_V(mul_eo, VEo)
ZA_V(sos, VSos)
ZA_V(none, VNone)
"""

PRODUCTS = ("mul", "mul_eo", "sos")

# variant builds: name -> (-D flags, text patches (old, new), each
# replacing old once, exact, the entry points timed); the checkout's
# defaults are the names without flags.  "aff_noinv" skips the blocks'
# inversions: a timing probe, not exact.
NO_INV = ("namespace za {\n", "namespace za {\nstruct NoInv {\n"
          "  template <class F>\n  __device__ static __forceinline__ F "
          "inv(const F& a) { return a; }\n};\n")
AFF = ("to_affine_g1", "to_affine_g2")
# ec_add_g2 swapped for another design at its entry point
ADD2 = "za::launch_add<za::Fq2, za::OpsEo>("
# design (b): a unit of W lanes adds one pair on the staged add
# (Staged<Fq2, W>, hw2::point_add) in its scratch, P + Q into P, ADD_TB
# / W pairs a block; the block loads the pairs into the units' P and Q
# slots and stores the sums, coalesced over its pairs.  Word w < 48 of a
# point: coordinate w / 16, plane w % 16 (2 limb + component), slot 2
# coordinate + component.  A unit past n adds zeros and stores nothing.
STAGED = r"""
template <int W>
__global__ void __launch_bounds__(ADD_TB)
ec_add_staged_kernel(const uint32_t* __restrict__ X1,
                     const uint32_t* __restrict__ Y1,
                     const uint32_t* __restrict__ Z1,
                     const uint32_t* __restrict__ X2,
                     const uint32_t* __restrict__ Y2,
                     const uint32_t* __restrict__ Z2,
                     uint32_t* __restrict__ X3, uint32_t* __restrict__ Y3,
                     uint32_t* __restrict__ Z3, int n) {
  using S = Staged<Fq2, W>;
  constexpr int PTS = ADD_TB / W;
  __shared__ Fq smem[PTS * S::SLOTS];
  const int tid = threadIdx.x, sub = tid % W;
  const size_t i0 = (size_t)blockIdx.x * PTS;
  Fq* s = smem + tid / W * S::SLOTS;
  for (int e = tid; e < 96 * PTS; e += ADD_TB) {
    const int pt = e % PTS, w = e / PTS % 48, q = e / PTS / 48;
    const int c = w / 16, pl = w % 16;
    const uint32_t* src = q ? (c == 0 ? X2 : c == 1 ? Y2 : Z2)
                            : (c == 0 ? X1 : c == 1 ? Y1 : Z1);
    const size_t i = i0 + pt;
    smem[pt * S::SLOTS + (q ? S::Q : S::P) + 2 * c + (pl & 1)].v[pl >> 1] =
        i < (size_t)n ? src[pl * (size_t)n + i] : 0u;
  }
  S::init(s, sub);
  __syncthreads();
  S::add(s, s + S::P, s + S::Q, sub);
  __syncthreads();
  for (int e = tid; e < 48 * PTS; e += ADD_TB) {
    const int pt = e % PTS, w = e / PTS, c = w / 16, pl = w % 16;
    const size_t i = i0 + pt;
    if (i < (size_t)n)
      (c == 0 ? X3 : c == 1 ? Y3 : Z3)[pl * (size_t)n + i] =
          smem[pt * S::SLOTS + S::P + 2 * c + (pl & 1)].v[pl >> 1];
  }
}

template <int W>
int launch_staged(const void* X1, const void* Y1, const void* Z1,
                  const void* X2, const void* Y2, const void* Z2, void* X3,
                  void* Y3, void* Z3, int n, void* stream) {
  constexpr int per = ADD_TB / W;
  if (n > 0)
    ec_add_staged_kernel<W><<<(n + per - 1) / per, ADD_TB, 0,
                              (cudaStream_t)stream>>>(
        (const uint32_t*)X1, (const uint32_t*)Y1, (const uint32_t*)Z1,
        (const uint32_t*)X2, (const uint32_t*)Y2, (const uint32_t*)Z2,
        (uint32_t*)X3, (uint32_t*)Y3, (uint32_t*)Z3, n);
  return (int)cudaGetLastError();
}

}  // namespace za
"""
# the staged add's products on mul_eo
HW2_EO = ("const Fq r = mul(add(a1[ca], a2[ca]), add(b1[cb], b2[cb]));",
          "const Fq r = mul_eo(add(a1[ca], a2[ca]), add(b1[cb], b2[cb]));")


def staged(w: int, eo: bool) -> tuple:
    return ((("}  // namespace za\n\nextern \"C\" {",
              STAGED + "\nextern \"C\" {"),
             (ADD2, f"za::launch_staged<{w}>("))
            + ((HW2_EO,) if eo else ()))


# the tail kernel's products (butterflies and store) on mul
TAIL_EO = ("struct TailMul {\n  __device__ static __forceinline__ Fr "
           "f(const Fr& a, const Fr& b) {\n    return mul_eo(a, b);",
           "struct TailMul {\n  __device__ static __forceinline__ Fr "
           "f(const Fr& a, const Fr& b) {\n    return mul(a, b);")


TAIL_PREFETCH = (
    ("    load(v[q], x, plane, b * sl + (row0 + (size_t)q * hb) * L + l);\n",
     "    load(v[q], x, plane, b * sl + (row0 + (size_t)q * hb) * L + l);\n"
     "  Fr tv[V];\n"
     "  if (mode & PREFIX_SCALE_OUT)\n"
     "#pragma unroll\n"
     "    for (int q = 0; q < V; ++q)\n"
     "      load(tv[q], tout, sl, (row0 + (size_t)q * hb) * L + l);\n"),
    ("    store_out<TailMul>(y, plane, b * sl + dst, tout, sl, dst, v[q], "
     "mode);\n",
     "    if (mode & PREFIX_SCALE_OUT) {\n"
     "      const Fr p = TailMul::f(v[q], tv[q]);\n"
     "#pragma unroll\n"
     "      for (int w = 0; w < 8; ++w) {\n"
     "        y[(2 * w) * plane + b * sl + dst] = p.v[w] & 0xffffu;\n"
     "        y[(2 * w + 1) * plane + b * sl + dst] = p.v[w] >> 16;\n"
     "      }\n"
     "    } else {\n"
     "      store(y, plane, b * sl + dst, v[q]);\n"
     "    }\n"))


VARIANTS = {
    "ntt": {
        "tw_cols2_rows16_eo": ([], (), True, ("ntt_twiddle_fr",)),
        "tw_cols4_rows16_eo": (["-DZA_TW_COLS=4"], (), True,
                               ("ntt_twiddle_fr",)),
        "tw_cols2_rows32_eo": (["-DZA_TW_ROWS=32"], (), True,
                               ("ntt_twiddle_fr",)),
        "tw_cols2_rows16_mul": (["-DZA_TW_MUL=mul"], (), True,
                                ("ntt_twiddle_fr",)),
        # the tail kernel: its products on mul; 128 or 512 threads a
        # block
        "tail_mul": ([], (TAIL_EO,), True, ("ntt_stage_fr",)),
        "tail_tb128": ([], (("constexpr int TAIL_TB = 256;",
                             "constexpr int TAIL_TB = 128;"),), True,
                       ("ntt_stage_fr",)),
        "tail_tb512": ([], (("constexpr int TAIL_TB = 256;",
                             "constexpr int TAIL_TB = 512;"),), True,
                       ("ntt_stage_fr",)),
        # at least 3 blocks an SM (ptxas caps the registers); the store
        # table loaded with the values, before the stages
        "tail_minb3": ([], (("__global__ void __launch_bounds__(TAIL_TB)\n"
                             "ntt_tail_kernel(",
                             "__global__ void __launch_bounds__(TAIL_TB, 3)"
                             "\nntt_tail_kernel("),), True,
                       ("ntt_stage_fr",)),
        "tail_prefetch": ([], TAIL_PREFETCH, True, ("ntt_stage_fr",)),
    },
    "ec": {
        "default": ([], (), True, AFF + ("ec_add_g2",)),
        "aff_fermat": (["-DZA_AFF_INV=Fermat"],
                       (), True, AFF),
        "aff_mul": (["-DZA_AFF_MUL=mul"], (), True, AFF),
        "aff_noinv": (["-DZA_AFF_INV=NoInv"],
                      (NO_INV,), False, AFF),
        # ec_add_g2: design (a) inlined on mul (the parent's products);
        # design (b) on 8 lanes (mul, mul_eo) and 16 lanes (mul_eo)
        "add2_inline_mul": ([], ((ADD2, "za::launch_add<za::Fq2, za::Ops>("),),
                            True, ("ec_add_g2",)),
        "add2_staged8": ([], staged(8, False), True, ("ec_add_g2",)),
        "add2_staged8_eo": ([], staged(8, True), True, ("ec_add_g2",)),
        "add2_staged16_eo": ([], staged(16, True), True, ("ec_add_g2",)),
    },
}
# the __global__ function behind each timed entry point, as ptxas names
# it (the first present)
ENTRY = {"ntt_twiddle_fr": ("_ZN2za18ntt_twiddle_kernelILb1E",),
         "ntt_stage_fr": ("_ZN2za15ntt_tail_kernelI",),
         "to_affine_g1": ("_ZN2za21to_affine_wave_kernelINS_2FpINS_7QParams"
                          "EEE",),
         "to_affine_g2": ("_ZN2za21to_affine_wave_kernelINS_3Fq2E",),
         "ec_add_g2": ("_ZN2za13ec_add_kernelINS_3Fq2E",
                       "_ZN2za20ec_add_staged_kernelI")}


def emit(obj, out) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    if out is not None:
        with open(out, "a") as f:
            f.write(line + "\n")


def load_smoke():
    """This repository's chip_smoke.py (chain_r1cs, rand_fq, ...)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_h",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cuobjdump() -> str:
    from za_tpu_torch.engine import _build

    return str(Path(_build._nvcc()).parent / "cuobjdump")


def sass_opcodes(lib: Path) -> dict:
    """{function: Counter of SASS opcodes} of a shared library."""
    text = subprocess.run([cuobjdump(), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    out, fn = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                     r"([A-Z][A-Z0-9_]*(?:\.[A-Z0-9_]+)*)", line)
        if m and fn is not None and m.group(1) != "NOP":
            out[fn][m.group(1)] += 1
    return out


def sass_digests(lib: Path) -> dict:
    """{function: sha1 of its SASS instructions} of a shared library
    (addresses and encodings left out): two builds with equal digests
    run the same code."""
    text = subprocess.run([cuobjdump(), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    out, fn = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = hashlib.sha1()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+([^;]*;)", line)
        if m and fn is not None:
            out[fn].update(m.group(1).encode())
    return {f: h.hexdigest()[:16] for f, h in out.items()}


def groups(c: collections.Counter) -> dict:
    """Opcode counts by the classes of one product's instruction mix."""
    g = collections.Counter()
    for op, n in c.items():
        if op.startswith("IMAD.WIDE"):
            k = "IMAD.WIDE" + (".X" if ".X" in op else "")
        elif op.startswith("IMAD.HI"):
            k = "IMAD.HI" + (".X" if ".X" in op else "")
        elif op.startswith("IMAD"):
            k = "IMAD.MOV" if ".MOV" in op else "IMAD" + (
                ".X" if ".X" in op else "")
        elif op.startswith("IADD3"):
            k = "IADD3.X" if ".X" in op else "IADD3"
        elif op.startswith(("MOV", "SEL", "ISETP", "LOP3", "SHF")):
            k = op.split(".")[0]
        else:
            k = "other:" + op
        g[k] += n
    return dict(sorted(g.items()))


def rung_inputs(torch, smoke, log2n: int) -> dict:
    """The chain at 2^log2n: r1cs, witness on the card, domain, an
    engine, the CSR and the matvec's witness in the checkout's layout,
    a twiddle input."""
    from za_tpu_torch.engine import field as F, r1cs as RC
    from za_tpu_torch.engine.engine import GpuEngine
    from za_tpu_torch.groth16.domain import Domain

    r1cs, z = smoke.chain_r1cs(1 << log2n)
    eng = GpuEngine()
    z_l = eng.witness_limbs_dev(z)
    domain = Domain.for_constraints(r1cs.num_constraints + r1cs.num_inputs)
    m = domain.size
    csr = RC.r1cs_csr(r1cs, m, "cuda")
    try:                      # the uploaded (16, nv) limbs
        RC.matvec(csr, z_l)
        zin = z_l
    except ValueError:        # an older checkout: l32 (8, nv)
        zin = F.pack(z_l.to(F.I64))
    fs = eng._domain(m).fourstep
    gen = torch.Generator(device="cuda").manual_seed(11 + log2n)
    xt = smoke.rand_fq(torch, (3, fs.n2, fs.n1), gen)
    return {"r1cs": r1cs, "z_l": z_l, "domain": domain, "eng": eng,
            "csr": csr, "zin": zin, "fs": fs, "xt": xt, "m": m}


def kernel_rows(torch, smoke, rungs, out) -> None:
    from za_tpu_torch.engine import _build, ntt as NTT, r1cs as RC

    bd = _build.build_dir()
    # the __global__ function the proof's shapes run, by the checkout's
    # name for it: this tree's vector twiddle, or an older untemplated one
    for name, source, prefixes in (
            ("ntt_twiddle_fr", "ntt", (*ENTRY["ntt_twiddle_fr"],
                                       "_ZN2za18ntt_twiddle_kernelE")),
            ("ntt_prefix_fr", "ntt", ("_ZN2za17ntt_prefix_kernelE",)),
            ("r1cs_matvec_fr", "r1cs", ("_ZN2za18r1cs_matvec_kernelE",))):
        sass = sass_opcodes(bd / f"lib{source}.so")
        fn = next(f for p in prefixes for f in sass if f.startswith(p))
        emit({"section": "kernel_build", "name": name, "entry": fn,
              **smoke.ptxas_usage((bd / f"{source}.log").read_text(), fn),
              "sass": groups(sass[fn]),
              "sass_sha1": sass_digests(bd / f"lib{source}.so")[fn]}, out)
    for log2n, ctx in rungs.items():
        csr, zin, fs, xt = ctx["csr"], ctx["zin"], ctx["fs"], ctx["xt"]
        got = RC.matvec(csr, zin)
        assert torch.equal(got, RC.matvec_plain(csr, zin)), "matvec"
        tw = NTT.ntt_twiddle(xt, fs.inter_fwd)
        assert torch.equal(tw, NTT.ntt_twiddle_plain(xt, fs.inter_fwd))
        row = {"section": "kernels", "rung": f"2^{log2n}",
               "nnz": csr.cols.numel(), "m": ctx["m"],
               "witness_rows": ctx["zin"].shape[0],
               "twiddle_shape": list(xt.shape[1:]),
               "r1cs_matvec_fr": {
                   "device_ms": smoke.device_ms(
                       torch, lambda: RC.matvec(csr, zin)),
                   "issue_ms": smoke.issue_ms(
                       torch, lambda: RC.matvec(csr, zin))},
               "ntt_twiddle_fr": {
                   "device_ms": smoke.device_ms(
                       torch, lambda: NTT.ntt_twiddle(xt, fs.inter_fwd)),
                   "issue_ms": smoke.issue_ms(
                       torch, lambda: NTT.ntt_twiddle(xt, fs.inter_fwd))},
               "ntt_prefix_fr": prefix_ms(torch, smoke, ctx),
               "h_ms": smoke.h_inline(torch, ctx["eng"], ctx["r1cs"],
                                      ctx["z_l"], ctx["domain"])}
        emit(row, out)


def prefix_ms(torch, smoke, ctx) -> dict:
    """ntt_prefix_fr's device_ms in each mode at chip_smoke.py's shapes
    (the first sub-NTT's 3 x n2 x n1; the combine's 3 legs into 1, the
    store table on 1 leg), each exact against its plain version."""
    from za_tpu_torch.engine import ntt as NTT

    fs, x = ctx["fs"], ctx["xt"]
    dom = ctx["eng"]._domain(ctx["m"])
    m = NTT.prefix_rows(fs.n2, fs.n1)
    res = {}
    for mode, xin, kw in (
            ("plain", x, {}), ("scale_in", x, {"scale_in": dom.coset_pow}),
            ("combine", x, {"combine": True}),
            ("scale_out", x[:, :1].contiguous(), {"scale_out": dom.h_out})):
        f = lambda xin=xin, kw=kw: NTT.ntt_prefix(  # noqa: E731
            xin, fs.t2_fwd, m, **kw)
        assert torch.equal(f(), NTT.ntt_prefix_plain(xin, fs.t2_fwd, m,
                                                     **kw)), mode
        res[mode] = smoke.device_ms(torch, f)
    return res


def affine_inputs(torch, smoke, is_g2: bool):
    """chip_smoke.py's to_affine shape: 8 staging blocks of points."""
    gen = torch.Generator(device="cuda").manual_seed(4 + is_g2)
    npts = 8 * (3 * (1 << 16) if not is_g2 else 1 << 15)
    E = (2,) if is_g2 else ()
    return [smoke.rand_fq(torch, E + (npts,), gen) for _ in range(3)]


# the widths each staging kernel runs at on the paths: a tree staging
# block (3 G1 queries x 2^16 columns, one G2 query x 2^15) and the
# 2^13 rung's dense b_g2 (nv = 2^13 + 2 points padded to 2^14)
ADD_WIDTHS = {False: {"staging_block": 3 * (1 << 16)},
              True: {"staging_block": 1 << 15, "dense_2^13": 1 << 14}}
# a checkout's staging kernels before this tree's: the __global__
# function of each entry point, as ptxas names it, newest first
OLD_FN = {
    "to_affine_g1": ("_ZN2za21to_affine_wave_kernelINS_3GcdE",
                     "_ZN2za16to_affine_kernelINS_2FpINS_7QParamsEEELi8E"),
    "to_affine_g2": ("_ZN2za16to_affine_kernelINS_3Fq2ELi4E",),
    "ec_add_g1": ("_ZN2za13ec_add_kernelINS_2FpINS_7QParamsEEEEE",),
    "ec_add_g2": ("_ZN2za13ec_add_kernelINS_3Fq2EEE",),
}


def staging_fn(smoke, log_text: str, name: str) -> str:
    """The prefix of the __global__ function behind entry point name in
    this checkout's ptxas log."""
    for p in (smoke.KERNEL_FN[name], *OLD_FN.get(name, ())):
        if f"Compiling entry function '{p}" in log_text:
            return p
    raise AssertionError(f"ptxas log: no kernel for {name}")


def staging_rows(torch, smoke, out) -> None:
    """Each staging kernel alone at the paths' widths, exact against its
    plain version (device_ms, issue_ms, ptxas registers and spill, SASS
    instructions), then a whole table build of each group as the paths
    run it: a tree staging block (build_tables_block: 7 ec_add and one
    to_affine) and, in G2, the 2^13 rung's dense multiples
    (msm_dense.build_tables: 7 ec_add)."""
    from za_tpu_torch.engine import _build, ec, msm_dense as MD
    from za_tpu_torch.engine import msm_tree as MT

    bd = _build.build_dir()
    ec_log = (bd / "ec.log").read_text()
    sass = sass_opcodes(bd / "libec.so")
    digest = sass_digests(bd / "libec.so")

    def usage(name):
        fn = staging_fn(smoke, ec_log, name)
        entry = next(f for f in sass if f.startswith(fn))
        return {"entry": entry, **smoke.ptxas_usage(ec_log, fn),
                "sass_total": sum(sass[entry].values()),
                "sass_sha1": digest[entry]}

    gen = torch.Generator(device="cuda").manual_seed(3)
    for is_g2 in (False, True):
        g = "g2" if is_g2 else "g1"
        E = (2,) if is_g2 else ()
        for width, npts in ADD_WIDTHS[is_g2].items():
            pts = [smoke.rand_fq(torch, E + (npts,), gen) for _ in range(6)]
            add = lambda: ec.ec_add(pts[:3], pts[3:6], is_g2)  # noqa: E731
            want = ec.ec_add_plain(pts[:3], pts[3:6], is_g2)
            assert all(torch.equal(a, b) for a, b in zip(add(), want)), (
                f"ec_add_{g} at {npts}: not exact")
            emit({"section": "staging", "kernel": f"ec_add_{g}",
                  "width": width, "points": npts,
                  "device_ms": smoke.device_ms(torch, add),
                  "issue_ms": smoke.issue_ms(torch, add),
                  **usage(f"ec_add_{g}")}, out)
        coords = affine_inputs(torch, smoke, is_g2)
        aff = lambda: ec.to_affine(*coords, is_g2)         # noqa: E731
        want = ec.to_affine_plain(*coords, is_g2)
        assert all(torch.equal(a, b) for a, b in zip(aff(), want))
        lib = _build.library("ec")
        plan = {}
        if hasattr(lib, "to_affine_blocks"):   # the one-wave split
            lib.to_affine_blocks.restype = ctypes.c_long
            lib.to_affine_blocks.argtypes = [ctypes.c_int, ctypes.c_int]
            plan["blocks"] = lib.to_affine_blocks(coords[0].shape[-1], is_g2)
        emit({"section": "staging", "kernel": f"to_affine_{g}",
              "points": coords[0].shape[-1],
              "device_ms": smoke.device_ms(torch, aff),
              "issue_ms": smoke.issue_ms(torch, aff, reps=2),
              **usage(f"to_affine_{g}"), **plan}, out)
        # whole table builds, random coordinates (the kernels' work does
        # not depend on the points being on the curve)
        npts = ADD_WIDTHS[is_g2]["staging_block"]
        blk = [smoke.rand_fq(torch, E + (npts,), gen) for _ in range(3)]
        builds = {"tree_block": lambda: MT.build_tables_block(blk, is_g2)}
        if is_g2:
            n = ADD_WIDTHS[True]["dense_2^13"]
            dense = [smoke.rand_fq(torch, (2, 1, n), gen) for _ in range(3)]
            builds["dense_2^13"] = lambda: MD.build_tables(dense, True, 16)
        for what, fn in builds.items():
            _build.reset_launches()
            fn()
            launches = {k: v.launches for k, v in _build.KERNELS.items()
                        if v.launches}
            emit({"section": "staging", "kernel": f"table_build_{g}",
                  "build": what, "launches": launches,
                  "device_ms": smoke.device_ms(torch, fn)}, out)


# the 2^20 rung's sub-NTT tails (domain 2^21: n1 = 2048, n2 = 1024, the
# prefix's m_fuse = 512): (shape, B, S, L, inverse twiddles, store mode)
# -- (a) the first sub-NTT of a 3-leg transform, one stage; (b) the
# second, two stages; (c) the coset iNTT's second sub-NTT, two stages,
# then the store mode (a plain table, 16-bit plain limbs out)
TAIL_SHAPES = (("a", 3, 1024, 2048, False, False),
               ("b", 3, 2048, 1024, False, False),
               ("c", 1, 2048, 1024, True, True))
TAIL_M = 512
# the stage kernel's __global__ functions, as ptxas names them: the
# one-launch tail (a template over its stage count), or a stage a launch
TAIL_FN = ("_ZN2za15ntt_tail_kernelI", "_ZN2za16ntt_stage_kernelE")


def tail_inputs(torch, smoke):
    """{shape: (B, S, L, x, tw, table or None)} of TAIL_SHAPES: random
    canonical values, the sub-NTT's twiddles, a random plain table."""
    from za_tpu_torch.engine import ntt as NTT
    from za_tpu_torch.groth16.domain import Domain

    gen = torch.Generator(device="cuda").manual_seed(21)
    out = {}
    for name, B, S, L, inverse, store in TAIL_SHAPES:
        d = Domain(S)
        tw = NTT._twiddles(d.omega_inv if inverse else d.omega, S // 2,
                           "cuda")
        x = smoke.rand_fq(torch, (B, S, L), gen)
        table = smoke.rand_fq(torch, (S * L,), gen) if store else None
        out[name] = (B, S, L, x, tw, table)
    return out


def tail_rows(torch, smoke, out) -> None:
    """The stages above m_fuse of the 2^20 rung's sub-NTTs at
    TAIL_SHAPES, each exact against the plain stages (and the plain
    store): on a checkout with the one-launch tail, its launch (the
    store mode in it); on an older one, each ntt_stage_fr launch alone
    (in place, on a copy), the tensor store (store_plain) alone, and the
    whole tail as the engine ran it (a copy, the stage launches, the
    store); device_ms each.  Then the kernel's registers, spill, SASS
    instructions and digest."""
    import inspect

    from za_tpu_torch.engine import _build, ntt as NTT

    one_launch = "scale_out" in inspect.signature(
        NTT.ntt_stages).parameters
    for name, (B, S, L, x, tw, table) in tail_inputs(torch, smoke).items():
        start = 2 * TAIL_M
        want = NTT.store_plain(NTT.ntt_stages_plain(x, tw, start), table)
        row = {"section": "tail", "shape": name, "B": B, "S": S, "L": L,
               "m_fuse": TAIL_M, "stages": (S // TAIL_M).bit_length() - 1,
               "store": table is not None, "one_launch": one_launch}
        if one_launch:
            def tail():
                return NTT.ntt_stages(x, tw, start, scale_out=table)
        else:
            def tail():
                return NTT.store_plain(NTT.ntt_stages(x, tw, start), table)
        before = NTT.NTT_STAGE.launches
        got = tail()
        row["launches"] = NTT.NTT_STAGE.launches - before
        assert torch.equal(got, want), f"tail ({name}): not exact"
        row["device_ms"] = smoke.device_ms(torch, tail)
        if one_launch and row["stages"] > 1:   # a launch a stage
            most, NTT.TAIL_MAX_STAGES = NTT.TAIL_MAX_STAGES, 1
            try:
                assert torch.equal(tail(), want)
                row["device_ms_stage_a_launch"] = smoke.device_ms(
                    torch, tail)
            finally:
                NTT.TAIL_MAX_STAGES = most
        if not one_launch:
            y = x.clone()
            h = TAIL_M
            while h < S:
                row[f"stage_h{h}_ms"] = smoke.device_ms(
                    torch, lambda h=h: NTT.NTT_STAGE(y, tw, B, S, L, h))
                h *= 2
            if table is not None:
                y = NTT.ntt_stages_plain(x, tw, start)
                row["store_plain_ms"] = smoke.device_ms(
                    torch, lambda: NTT.store_plain(y, table))
        emit(row, out)
    bd = _build.build_dir()
    log = (bd / "ntt.log").read_text()
    sass = sass_opcodes(bd / "libntt.so")
    digest = sass_digests(bd / "libntt.so")
    for fn in sorted(f for f in sass if f.startswith(TAIL_FN)):
        emit({"section": "tail_build", "entry": fn,
              **smoke.ptxas_usage(log, fn),
              "sass_total": sum(sass[fn].values()),
              "sass_sha1": digest[fn]}, out)


def nvcc_build(src: Path, lib: Path, flags, include: Path):
    from za_tpu_torch.engine import _build

    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{include}", *flags,
           "-o", str(lib), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def products(torch, smoke, tmp: Path, out) -> None:
    from za_tpu_torch.engine import _build, field as F

    field = (_build.CSRC / "field.cuh").read_text()
    extra = ""
    if "mul_eo(" not in field:      # an older checkout: this repo's product
        mine = (HERE / "za_tpu_torch" / "csrc" / "field.cuh").read_text()
        a = mine.index("// -- Montgomery multiplication, even and odd")
        extra = mine[a:mine.index("template <class P>\n__device__ "
                                  "__forceinline__ bool is_zero(", a)]
    src = tmp / "micro.cu"
    src.write_text(MICRO % {"extra": extra, "sos": SOS})
    proc = nvcc_build(src, tmp / "libmicro.so", [], _build.CSRC)
    text = proc.communicate()[0]
    assert proc.returncode == 0, text[-4000:]
    lib = ctypes.CDLL(str(tmp / "libmicro.so"))
    sass = sass_opcodes(tmp / "libmicro.so")
    probe_none = next(c for f, c in sass.items()
                      if "probe_kernel" in f and "VNone" in f)
    gen = torch.Generator(device="cuda").manual_seed(9)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    for name in PRODUCTS:
        rate = getattr(lib, f"rate_{name}")
        rate.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                         ctypes.c_long, ctypes.c_int, ctypes.c_int,
                         ctypes.c_void_p]
        res = getattr(lib, f"resident_{name}")
        res.argtypes = [ctypes.c_int, ctypes.c_int]
        vname = {"mul": "VMul", "mul_eo": "VEo", "sos": "VSos"}[name]
        probe = next(c for f, c in sass.items()
                     if "probe_kernel" in f and vname in f)
        diff = collections.Counter(probe)
        diff.subtract(probe_none)
        for op, n in probe_none.items():   # the stand-in's XORs
            if op.startswith("LOP3"):
                diff[op] += n
        diff = collections.Counter({k: v for k, v in diff.items() if v})
        row = {"section": "products", "product": name,
               "sass_one_product": dict(sorted(diff.items())),
               "sass_groups": groups(diff),
               "sass_total": sum(diff.values()), "rates": []}
        for k in (1, 2, 4):
            entry = f"_ZN2za11rate_kernelINS_{len(vname)}{vname}ELi{k}E"
            for tb in (128, 256):
                blocks = res(k, tb)
                n = blocks * sms * tb * 4         # four waves
                x = smoke.rand_fq(torch, (k * n,), gen)
                y = smoke.rand_fq(torch, (k * n,), gen)
                x1 = x.clone()
                assert rate(k, x1.data_ptr(), y.data_ptr(), n, 1, tb,
                            stream) == 0
                want = F.pack(F.FR.mul(F.unpack(x), F.unpack(y)))
                assert torch.equal(x1, want), f"{name} K={k}: not exact"
                iters = 64

                def go():
                    assert rate(k, x1.data_ptr(), y.data_ptr(), n, iters,
                                tb, stream) == 0

                ms = smoke.device_ms(torch, go)
                row["rates"].append({
                    "K": k, "threads_a_block": tb, "blocks_an_sm": blocks,
                    "warps_an_sm": blocks * tb // 32,
                    "M_products_per_ms": n * k * iters / ms / 1e6,
                    "ms": ms, **smoke.ptxas_usage(text, entry)})
        row["best_M_products_per_ms"] = max(
            r["M_products_per_ms"] for r in row["rates"])
        emit(row, out)


def variants(torch, smoke, rungs, tmp: Path, out, which) -> None:
    """Variant builds of csrc/ntt.cu and csrc/ec.cu (the sources in
    which), one nvcc each, all started together, swapped into the
    engine's wrappers: ntt_twiddle_fr alone and inside h(x) at both
    rungs; to_affine_g1/_g2 alone at chip_smoke.py's shapes; ec_add_g2
    alone at the paths' widths and inside the G2 table builds.  Each
    exact against the plain version but the timing probes."""
    from za_tpu_torch.engine import _build, ec, msm_dense as MD
    from za_tpu_torch.engine import msm_tree as MT, ntt as NTT

    text = {s: (_build.CSRC / f"{s}.cu").read_text() for s in which}
    if ("TAIL_TB" not in text.get("ntt", "TAIL_TB")
            or ADD2 not in text.get("ec", ADD2)):
        smoke.log("variants: the checkout's sources take no variant macros")
        return
    procs = {}
    for source in which:
        for name, (flags, patches, _, _) in VARIANTS[source].items():
            src = _build.CSRC / f"{source}.cu"
            if patches:
                body = text[source]
                for old, new in patches:
                    assert old in body, (name, old)
                    body = body.replace(old, new, 1)
                src = tmp / f"{name}.cu"
                src.write_text(body)
            procs[name] = (source, nvcc_build(
                src, tmp / f"lib{name}.so", flags, _build.CSRC))
    logs = {}
    for name, (source, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        assert proc.returncode == 0, logs[name][-4000:]
    wrappers = {"ntt_twiddle_fr": NTT.NTT_TWIDDLE,
                "ntt_stage_fr": NTT.NTT_STAGE,
                "to_affine_g1": ec.TO_AFFINE[False],
                "to_affine_g2": ec.TO_AFFINE[True],
                "ec_add_g2": ec.EC_ADD[True]}
    gen = torch.Generator(device="cuda").manual_seed(5)
    coords = {k: affine_inputs(torch, smoke, k == "to_affine_g2")
              for k in AFF}
    aff_want = {k: ec.to_affine_plain(*c, k == "to_affine_g2")
                for k, c in coords.items()}
    pairs = {n: [smoke.rand_fq(torch, (2, n), gen) for _ in range(6)]
             for n in ADD_WIDTHS[True].values()}
    add_want = {n: ec.ec_add_plain(p[:3], p[3:], True)
                for n, p in pairs.items()}
    blk = [smoke.rand_fq(torch, (2, ADD_WIDTHS[True]["staging_block"]), gen)
           for _ in range(3)]
    dense = [smoke.rand_fq(torch, (2, 1, ADD_WIDTHS[True]["dense_2^13"]),
                           gen) for _ in range(3)]
    tails = tail_inputs(torch, smoke)
    tail_want = {k: NTT.ntt_stages_plain(x, tw, 2 * TAIL_M, table)
                 for k, (_, _, _, x, tw, table) in tails.items()}
    defaults = {k: w._resolve() for k, w in wrappers.items()}

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    for name, (source, _) in procs.items():
        _, _, exact, timed = VARIANTS[source][name]
        lib = tmp / f"lib{name}.so"
        cdll = ctypes.CDLL(str(lib))
        sass = sass_opcodes(lib)
        for k in timed:
            fn = getattr(cdll, k)
            fn.restype = defaults[k].restype
            fn.argtypes = defaults[k].argtypes
            wrappers[k]._fn = fn
        try:
            row = {"section": "variants", "variant": name, "exact": exact}
            for k in timed:
                entry = next(f for p in ENTRY[k] for f in sass
                             if f.startswith(p))
                res = {"entry": entry, **smoke.ptxas_usage(logs[name], entry),
                       "sass_total": sum(sass[entry].values())}
                if k == "ntt_stage_fr":    # its one- and two-stage forms
                    res = {"builds": [
                        {"entry": f, **smoke.ptxas_usage(logs[name], f),
                         "sass_total": sum(sass[f].values())}
                        for f in sorted(sass) if f.startswith(
                            tuple(f"{ENTRY[k][0]}Li{v}E" for v in (1, 2)))]}
                    for tag, (_, _, _, x, tw, table) in tails.items():
                        f = lambda x=x, tw=tw, table=table: (  # noqa: E731
                            NTT.ntt_stages(x, tw, 2 * TAIL_M, table))
                        assert torch.equal(f(), tail_want[tag]), (name, tag)
                        res[f"device_ms_{tag}"] = smoke.device_ms(torch, f)
                elif k in AFF:
                    g2 = k == "to_affine_g2"
                    f = lambda g2=g2, c=coords[k]: ec.to_affine(  # noqa: E731
                        *c, g2)
                    assert not exact or same(f(), aff_want[k]), (name, k)
                    res["device_ms"] = smoke.device_ms(torch, f)
                elif k == "ec_add_g2":
                    for n, p in pairs.items():
                        f = lambda p=p: ec.ec_add(p[:3], p[3:], True)  # noqa
                        assert same(f(), add_want[n]), (name, n)
                        res[f"device_ms_{n}"] = smoke.device_ms(torch, f)
                    res["tree_block_build_ms"] = smoke.device_ms(
                        torch, lambda: MT.build_tables_block(blk, True))
                    res["dense_2^13_build_ms"] = smoke.device_ms(
                        torch, lambda: MD.build_tables(dense, True, 16))
                else:
                    res["rungs"] = {}
                    for log2n, ctx in rungs.items():
                        fs, xt = ctx["fs"], ctx["xt"]
                        f = lambda: NTT.ntt_twiddle(  # noqa: E731
                            xt, fs.inter_fwd)
                        assert torch.equal(f(), NTT.ntt_twiddle_plain(
                            xt, fs.inter_fwd)), f"{name} at 2^{log2n}"
                        h = smoke.h_inline(torch, ctx["eng"], ctx["r1cs"],
                                           ctx["z_l"], ctx["domain"])
                        res["rungs"][f"2^{log2n}"] = {
                            "device_ms": smoke.device_ms(torch, f),
                            "h_ms": h[k], "h_span_ms": h["h"]}
                row[k] = res
            emit(row, out)
        finally:
            for k, w in wrappers.items():
                w._fn = defaults[k]


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--products", action="store_true")
    ap.add_argument("--kernels", action="store_true")
    ap.add_argument("--staging", action="store_true")
    ap.add_argument("--tail", action="store_true")
    ap.add_argument("--variants", nargs="?", const="ntt,ec", default="",
                    help="variant builds of these sources (default both)")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    if not (args.products or args.kernels or args.staging or args.tail
            or args.variants):
        args.products = args.kernels = args.staging = args.tail = True
        args.variants = "ntt,ec"
    which = [w for w in args.variants.split(",") if w]
    import torch

    if not torch.cuda.is_available():
        print("torch_hpipe_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.root.resolve()))
    from za_tpu_torch.engine import _build

    assert Path(_build.__file__).resolve().is_relative_to(
        args.root.resolve()), "the checkout's package was not imported"
    sys.setrecursionlimit(100_000)
    built = _build.build_all()
    smoke = load_smoke()
    smoke.log(f"{args.root}: built {built}")
    tmp = Path(tempfile.mkdtemp(prefix="hpipe_sweep_"))
    name = smoke.card_line()
    emit({"section": "card", "card": name, "root": str(args.root),
          "torch": torch.__version__, "cuda": torch.version.cuda}, args.out)
    if args.products:
        products(torch, smoke, tmp, args.out)
    rungs = {}
    if args.kernels or "ntt" in which:
        rungs = {k: rung_inputs(torch, smoke, k) for k in (17, 13)}
    if args.kernels:
        kernel_rows(torch, smoke, rungs, args.out)
    if args.staging:
        staging_rows(torch, smoke, args.out)
    if args.tail:
        tail_rows(torch, smoke, args.out)
    if which:
        variants(torch, smoke, rungs, tmp, args.out, which)
    print(name)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
