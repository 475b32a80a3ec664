// BN254 base and scalar field arithmetic for the port's kernels:
// header-only __device__ code, no state.
//
// Layout: a field element is a canonical value in [0, p) in Montgomery
// form (R = 2^256), eight 32-bit limbs, little-endian.  In device memory
// the limbs are planes: limb j of element i of a tensor (8, ..., n)
// sits at j * plane + i, so consecutive threads read consecutive words.
// Fq2 = Fq[i]/(i^2 + 1) keeps the component axis right after the limbs:
// limb j of component c is plane 2 * j + c.
//
// Replaces the reference's in-kernel RNS field library
// (za_tpu/engine/pallas_msm_rns.py _kmul/_kadd/_ksub, used by every
// Pallas tree kernel): Hopper has a native 32x32->64 integer multiply,
// so the 35-channel RNS and its int8 base extensions are not needed.
// Montgomery multiplication is CIOS over 8 words; each row of the
// product is two PTX carry chains (even and odd words, mad.lo.cc /
// madc.hi.cc) so no carry ever leaves a chain.  Inputs are canonical
// and p < 2^254, so every intermediate fits in nine words and one final
// conditional subtraction makes the result canonical.
//
// Inversion: block_inverse batch-inverts a block's values with one
// single-thread inversion, which the rest of the block waits for.  inv
// (Fermat) is 364 dependent products, ~0.20 ms on the card (NVIDIA H100
// 80GB HBM3, 700 W): a floor of 0.23-0.32 ms under every wave of
// tree-level blocks, whatever they held.  inv_gcd (Bernstein-Yang
// divsteps on machine words) gives the same value from short word
// operations.  Users: block_inverse_gcd (inv_gcd at the root, Fq2
// through the norm) in the four tree kernels, block_inverse on Fq with
// Gcd in to_affine_g1 and _g2 (G2 on the norms); Fermat in no kernel.
//
// mul_eo (below mul) gives mul's value from the same CIOS rows with two
// accumulators, no register shifts between rows: 181 SASS instructions a
// product against mul's 328, 61 M products/ms on independent values
// against 51 (NVIDIA H100 80GB HBM3, 700 W; tools/torch_hpipe_sweep.py).
// Users: ntt_twiddle_fr, to_affine_g1/_g2 and ec_add_g2 (curve.cuh
// OpsEo); every other kernel keeps mul.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace za {

struct QParams {  // BN254 base field q
  static constexpr uint32_t np0 = 0xe4866389u;  // -q^-1 mod 2^32
  __device__ static __forceinline__ uint32_t p(int i) {
    constexpr uint32_t v[8] = {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du,
                               0x97816a91u, 0x8181585du, 0xb85045b6u,
                               0xe131a029u, 0x30644e72u};
    return v[i];
  }
  __device__ static __forceinline__ uint32_t one(int i) {  // R mod q
    constexpr uint32_t v[8] = {0xc58f0d9du, 0xd35d438du, 0xf5c70b3du,
                               0x0a78eb28u, 0x7879462cu, 0x666ea36fu,
                               0x9a07df2fu, 0x0e0a77c1u};
    return v[i];
  }
  __device__ static __forceinline__ uint32_t r3(int i) {  // R^3 mod q
    constexpr uint32_t v[8] = {0xda1530dfu, 0xb1cd6dafu, 0xa7283db6u,
                               0x62f210e6u, 0x0ada0afbu, 0xef7f0b0cu,
                               0x2d592544u, 0x20fd6e90u};
    return v[i];
  }
};

struct RParams {  // BN254 scalar field r
  static constexpr uint32_t np0 = 0xefffffffu;  // -r^-1 mod 2^32
  __device__ static __forceinline__ uint32_t p(int i) {
    constexpr uint32_t v[8] = {0xf0000001u, 0x43e1f593u, 0x79b97091u,
                               0x2833e848u, 0x8181585du, 0xb85045b6u,
                               0xe131a029u, 0x30644e72u};
    return v[i];
  }
  __device__ static __forceinline__ uint32_t one(int i) {  // R mod r
    constexpr uint32_t v[8] = {0x4ffffffbu, 0xac96341cu, 0x9f60cd29u,
                               0x36fc7695u, 0x7879462eu, 0x666ea36fu,
                               0x9a07df2fu, 0x0e0a77c1u};
    return v[i];
  }
};

template <class P>
struct Fp {
  uint32_t v[8];
};

using Fq = Fp<QParams>;
using Fr = Fp<RParams>;

struct Fq2 {
  Fq c0, c1;
};

// -- constants --------------------------------------------------------------

template <class P>
__device__ __forceinline__ Fp<P> fp_one() {
  Fp<P> r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = P::one(i);
  return r;
}

template <class P>
__device__ __forceinline__ Fp<P> fp_zero() {
  Fp<P> r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = 0u;
  return r;
}

template <class F> __device__ __forceinline__ F one();
template <class F> __device__ __forceinline__ F zero();
template <> __device__ __forceinline__ Fq one<Fq>() { return fp_one<QParams>(); }
template <> __device__ __forceinline__ Fr one<Fr>() { return fp_one<RParams>(); }
template <> __device__ __forceinline__ Fq zero<Fq>() { return fp_zero<QParams>(); }
template <> __device__ __forceinline__ Fr zero<Fr>() { return fp_zero<RParams>(); }
template <> __device__ __forceinline__ Fq2 one<Fq2>() {
  return Fq2{fp_one<QParams>(), fp_zero<QParams>()};
}
template <> __device__ __forceinline__ Fq2 zero<Fq2>() {
  return Fq2{fp_zero<QParams>(), fp_zero<QParams>()};
}

// -- add / sub ----------------------------------------------------------------

// r = a - p if a >= p else a  (a < 2p < 2^256)
template <class P>
__device__ __forceinline__ Fp<P> reduce_once(const uint32_t a[8]) {
  uint32_t s[8], borrow;
  asm("sub.cc.u32 %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32 %8, %25, %25;"
      : "=r"(s[0]), "=r"(s[1]), "=r"(s[2]), "=r"(s[3]), "=r"(s[4]),
        "=r"(s[5]), "=r"(s[6]), "=r"(s[7]), "=r"(borrow)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(P::p(0)), "r"(P::p(1)), "r"(P::p(2)),
        "r"(P::p(3)), "r"(P::p(4)), "r"(P::p(5)), "r"(P::p(6)),
        "r"(P::p(7)), "r"(0u));
  Fp<P> r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = borrow ? a[i] : s[i];
  return r;
}

template <class P>
__device__ __forceinline__ Fp<P> add(const Fp<P>& a, const Fp<P>& b) {
  uint32_t s[8];
  asm("add.cc.u32 %0, %8, %16;\n\t"
      "addc.cc.u32 %1, %9, %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\t"
      "addc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\t"
      "addc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\t"
      "addc.u32 %7, %15, %23;"
      : "=r"(s[0]), "=r"(s[1]), "=r"(s[2]), "=r"(s[3]), "=r"(s[4]),
        "=r"(s[5]), "=r"(s[6]), "=r"(s[7])
      : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]),
        "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]), "r"(b.v[0]), "r"(b.v[1]),
        "r"(b.v[2]), "r"(b.v[3]), "r"(b.v[4]), "r"(b.v[5]), "r"(b.v[6]),
        "r"(b.v[7]));
  return reduce_once<P>(s);  // a + b < 2p < 2^255: no carry out
}

template <class P>
__device__ __forceinline__ Fp<P> sub(const Fp<P>& a, const Fp<P>& b) {
  uint32_t d[8], mask;
  asm("sub.cc.u32 %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32 %8, %25, %25;"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]),
        "=r"(d[5]), "=r"(d[6]), "=r"(d[7]), "=r"(mask)
      : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]),
        "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]), "r"(b.v[0]), "r"(b.v[1]),
        "r"(b.v[2]), "r"(b.v[3]), "r"(b.v[4]), "r"(b.v[5]), "r"(b.v[6]),
        "r"(b.v[7]), "r"(0u));
  // borrow: add p back (mask is all ones exactly when a < b)
  Fp<P> r;
  asm("add.cc.u32 %0, %8, %16;\n\t"
      "addc.cc.u32 %1, %9, %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\t"
      "addc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\t"
      "addc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\t"
      "addc.u32 %7, %15, %23;"
      : "=r"(r.v[0]), "=r"(r.v[1]), "=r"(r.v[2]), "=r"(r.v[3]),
        "=r"(r.v[4]), "=r"(r.v[5]), "=r"(r.v[6]), "=r"(r.v[7])
      : "r"(d[0]), "r"(d[1]), "r"(d[2]), "r"(d[3]), "r"(d[4]), "r"(d[5]),
        "r"(d[6]), "r"(d[7]), "r"(P::p(0) & mask), "r"(P::p(1) & mask),
        "r"(P::p(2) & mask), "r"(P::p(3) & mask), "r"(P::p(4) & mask),
        "r"(P::p(5) & mask), "r"(P::p(6) & mask), "r"(P::p(7) & mask));
  return r;
}

template <class P>
__device__ __forceinline__ Fp<P> neg(const Fp<P>& a) {
  return sub(fp_zero<P>(), a);
}

// -- Montgomery multiplication (CIOS) -------------------------------------------

// t[0..8] += a * b, as two carry chains: even words of a (lo at j, hi at
// j + 1), then odd words.  Callers keep t < 2^288, so neither chain
// carries out of t[8].
__device__ __forceinline__ void mad_row(uint32_t t[9], const uint32_t a[8],
                                        uint32_t b) {
  asm("mad.lo.cc.u32 %0, %9, %17, %0;\n\t"
      "madc.hi.cc.u32 %1, %9, %17, %1;\n\t"
      "madc.lo.cc.u32 %2, %11, %17, %2;\n\t"
      "madc.hi.cc.u32 %3, %11, %17, %3;\n\t"
      "madc.lo.cc.u32 %4, %13, %17, %4;\n\t"
      "madc.hi.cc.u32 %5, %13, %17, %5;\n\t"
      "madc.lo.cc.u32 %6, %15, %17, %6;\n\t"
      "madc.hi.cc.u32 %7, %15, %17, %7;\n\t"
      "addc.u32 %8, %8, %18;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
        "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(b), "r"(0u));
  asm("mad.lo.cc.u32 %1, %10, %17, %1;\n\t"
      "madc.hi.cc.u32 %2, %10, %17, %2;\n\t"
      "madc.lo.cc.u32 %3, %12, %17, %3;\n\t"
      "madc.hi.cc.u32 %4, %12, %17, %4;\n\t"
      "madc.lo.cc.u32 %5, %14, %17, %5;\n\t"
      "madc.hi.cc.u32 %6, %14, %17, %6;\n\t"
      "madc.lo.cc.u32 %7, %16, %17, %7;\n\t"
      "madc.hi.u32 %8, %16, %17, %8;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
        "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(b));
}

template <class P>
__device__ __forceinline__ Fp<P> mul(const Fp<P>& a, const Fp<P>& b) {
  uint32_t pw[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) pw[i] = P::p(i);
  uint32_t t[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) t[i] = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    mad_row(t, a.v, b.v[i]);          // t += a * b_i      (< 2^287)
    uint32_t m = t[0] * P::np0;
    mad_row(t, pw, m);                // t += m * p, t[0] becomes 0
#pragma unroll
    for (int k = 0; k < 8; ++k) t[k] = t[k + 1];
    t[8] = 0u;
  }
  return reduce_once<P>(t);           // t < 2p
}

template <class P>
__device__ __forceinline__ Fp<P> sqr(const Fp<P>& a) {
  return mul(a, a);
}

// -- Montgomery multiplication, even and odd accumulators ------------------------
//
// mul_eo gives mul's value (CIOS, the same rows) with the running sum T
// held as two accumulators: e (words 0..7) and o (o[j] at word j + 1).
// A row adds the even words of a into one and the odd words into the
// other, so its two carry chains share no word and run side by side;
// in mul the odd chain reads the words the even one wrote.  After a
// row's reduction e[0] is 0 and T / 2^32 has both halves at word 0:
// the next row takes o as its even accumulator and e, shifted two words
// inside that row's chain, as its odd one, so the roles swap every row
// and no separate shift or add is spent.  Each asm block holds whole
// carry chains (no carry flag crosses two blocks), and every output is
// a "+r" operand, tied to its own register: a "=r" output may be given
// the register of an input that dies in the block and then clobber it
// before the block reads it.
// tests/test_torch_hpipe.py runs these blocks, parsed from this file,
// against a b R^-1 mod p.

// e = a_even b (words 0..7), o = a_odd b (o[j] at word j + 1)
__device__ __forceinline__ void eo_first(uint32_t e[8], uint32_t o[8],
                                         const uint32_t a[8], uint32_t b) {
  asm("mul.lo.u32 %0, %16, %24;\n\t"
      "mul.hi.u32 %1, %16, %24;\n\t"
      "mul.lo.u32 %2, %18, %24;\n\t"
      "mul.hi.u32 %3, %18, %24;\n\t"
      "mul.lo.u32 %4, %20, %24;\n\t"
      "mul.hi.u32 %5, %20, %24;\n\t"
      "mul.lo.u32 %6, %22, %24;\n\t"
      "mul.hi.u32 %7, %22, %24;\n\t"
      "mul.lo.u32 %8, %17, %24;\n\t"
      "mul.hi.u32 %9, %17, %24;\n\t"
      "mul.lo.u32 %10, %19, %24;\n\t"
      "mul.hi.u32 %11, %19, %24;\n\t"
      "mul.lo.u32 %12, %21, %24;\n\t"
      "mul.hi.u32 %13, %21, %24;\n\t"
      "mul.lo.u32 %14, %23, %24;\n\t"
      "mul.hi.u32 %15, %23, %24;"
      : "+r"(e[0]), "+r"(e[1]), "+r"(e[2]), "+r"(e[3]), "+r"(e[4]),
        "+r"(e[5]), "+r"(e[6]), "+r"(e[7]), "+r"(o[0]), "+r"(o[1]),
        "+r"(o[2]), "+r"(o[3]), "+r"(o[4]), "+r"(o[5]), "+r"(o[6]),
        "+r"(o[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(b));
}

// T += m p: p's odd words into o, its even words into e, e's carry out
// (word 8) into o[7].  T stays < 2^288, so o's chain carries out nothing.
__device__ __forceinline__ void eo_redc(uint32_t e[8], uint32_t o[8],
                                        const uint32_t p[8], uint32_t m) {
  asm("mad.lo.cc.u32 %8, %17, %24, %8;\n\t"
      "madc.hi.cc.u32 %9, %17, %24, %9;\n\t"
      "madc.lo.cc.u32 %10, %19, %24, %10;\n\t"
      "madc.hi.cc.u32 %11, %19, %24, %11;\n\t"
      "madc.lo.cc.u32 %12, %21, %24, %12;\n\t"
      "madc.hi.cc.u32 %13, %21, %24, %13;\n\t"
      "madc.lo.cc.u32 %14, %23, %24, %14;\n\t"
      "madc.hi.u32 %15, %23, %24, %15;\n\t"
      "mad.lo.cc.u32 %0, %16, %24, %0;\n\t"
      "madc.hi.cc.u32 %1, %16, %24, %1;\n\t"
      "madc.lo.cc.u32 %2, %18, %24, %2;\n\t"
      "madc.hi.cc.u32 %3, %18, %24, %3;\n\t"
      "madc.lo.cc.u32 %4, %20, %24, %4;\n\t"
      "madc.hi.cc.u32 %5, %20, %24, %5;\n\t"
      "madc.lo.cc.u32 %6, %22, %24, %6;\n\t"
      "madc.hi.cc.u32 %7, %22, %24, %7;\n\t"
      "addc.u32 %15, %15, 0;"
      : "+r"(e[0]), "+r"(e[1]), "+r"(e[2]), "+r"(e[3]), "+r"(e[4]),
        "+r"(e[5]), "+r"(e[6]), "+r"(e[7]), "+r"(o[0]), "+r"(o[1]),
        "+r"(o[2]), "+r"(o[3]), "+r"(o[4]), "+r"(o[5]), "+r"(o[6]),
        "+r"(o[7])
      : "r"(p[0]), "r"(p[1]), "r"(p[2]), "r"(p[3]), "r"(p[4]), "r"(p[5]),
        "r"(p[6]), "r"(p[7]), "r"(m));
}

// T = T / 2^32 + a b, where e[0] = 0: the even accumulator becomes o
// (o[0] + e[1] at word 0, o[1..7]), the odd one e (e[2..7] moved down
// two words, at words 1..6), each plus its half of a b.
__device__ __forceinline__ void eo_row(uint32_t e[8], uint32_t o[8],
                                       const uint32_t a[8], uint32_t b) {
  asm("add.cc.u32 %8, %8, %1;\n\t"
      "madc.lo.cc.u32 %0, %17, %24, %2;\n\t"
      "madc.hi.cc.u32 %1, %17, %24, %3;\n\t"
      "madc.lo.cc.u32 %2, %19, %24, %4;\n\t"
      "madc.hi.cc.u32 %3, %19, %24, %5;\n\t"
      "madc.lo.cc.u32 %4, %21, %24, %6;\n\t"
      "madc.hi.cc.u32 %5, %21, %24, %7;\n\t"
      "madc.lo.cc.u32 %6, %23, %24, 0;\n\t"
      "madc.hi.u32 %7, %23, %24, 0;\n\t"
      "mad.lo.cc.u32 %8, %16, %24, %8;\n\t"
      "madc.hi.cc.u32 %9, %16, %24, %9;\n\t"
      "madc.lo.cc.u32 %10, %18, %24, %10;\n\t"
      "madc.hi.cc.u32 %11, %18, %24, %11;\n\t"
      "madc.lo.cc.u32 %12, %20, %24, %12;\n\t"
      "madc.hi.cc.u32 %13, %20, %24, %13;\n\t"
      "madc.lo.cc.u32 %14, %22, %24, %14;\n\t"
      "madc.hi.cc.u32 %15, %22, %24, %15;\n\t"
      "addc.u32 %7, %7, 0;"
      : "+r"(e[0]), "+r"(e[1]), "+r"(e[2]), "+r"(e[3]), "+r"(e[4]),
        "+r"(e[5]), "+r"(e[6]), "+r"(e[7]), "+r"(o[0]), "+r"(o[1]),
        "+r"(o[2]), "+r"(o[3]), "+r"(o[4]), "+r"(o[5]), "+r"(o[6]),
        "+r"(o[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(b));
}

// r = T / 2^32 after the last reduction: e (even, e[0] = 0) moved down
// a word plus o
__device__ __forceinline__ void eo_merge(uint32_t r[8], const uint32_t e[8],
                                         const uint32_t o[8]) {
  asm("add.cc.u32 %0, %9, %16;\n\t"
      "addc.cc.u32 %1, %10, %17;\n\t"
      "addc.cc.u32 %2, %11, %18;\n\t"
      "addc.cc.u32 %3, %12, %19;\n\t"
      "addc.cc.u32 %4, %13, %20;\n\t"
      "addc.cc.u32 %5, %14, %21;\n\t"
      "addc.cc.u32 %6, %15, %22;\n\t"
      "addc.u32 %7, %23, 0;"
      : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]),
        "+r"(r[5]), "+r"(r[6]), "+r"(r[7])
      : "r"(e[0]), "r"(e[1]), "r"(e[2]), "r"(e[3]), "r"(e[4]), "r"(e[5]),
        "r"(e[6]), "r"(e[7]), "r"(o[0]), "r"(o[1]), "r"(o[2]), "r"(o[3]),
        "r"(o[4]), "r"(o[5]), "r"(o[6]), "r"(o[7]));
}

template <class P>
__device__ __forceinline__ Fp<P> mul_eo(const Fp<P>& a, const Fp<P>& b) {
  uint32_t pw[8], e[8], o[8], r[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    pw[i] = P::p(i);
    e[i] = o[i] = r[i] = 0u;          // the blocks' outputs are "+r"
  }
  eo_first(e, o, a.v, b.v[0]);
  eo_redc(e, o, pw, e[0] * P::np0);
#pragma unroll
  for (int i = 1; i < 8; ++i) {
    if (i & 1) {                      // even words in o after the row
      eo_row(e, o, a.v, b.v[i]);
      eo_redc(o, e, pw, o[0] * P::np0);
    } else {                          // and back in e
      eo_row(o, e, a.v, b.v[i]);
      eo_redc(e, o, pw, e[0] * P::np0);
    }
  }
  eo_merge(r, o, e);                  // row 7 left the even words in o
  return reduce_once<P>(r);           // < 2p
}

template <class P>
__device__ __forceinline__ bool is_zero(const Fp<P>& a) {
  uint32_t acc = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) acc |= a.v[i];
  return acc == 0u;
}

// Fermat inverse a^(p-2), square-and-multiply from the top bit; 0 -> 0.
template <class P>
__device__ __noinline__ Fp<P> inv(const Fp<P>& a) {
  Fp<P> acc = fp_one<P>();
#pragma unroll 1
  for (int w = 7; w >= 0; --w) {
    uint32_t e = P::p(w) - (w == 0 ? 2u : 0u);  // p is odd: no borrow
#pragma unroll 1
    for (int b = 31; b >= 0; --b) {
      acc = sqr(acc);
      if ((e >> b) & 1u) acc = mul(acc, a);
    }
  }
  return acc;
}

// -- inversion by Bernstein-Yang divsteps (safegcd) ---------------------------
//
// The Fermat inverse above is 364 dependent Montgomery products in one
// thread.  inv_gcd computes the same canonical value from divsteps on
// machine words: 20 batches of 30 (590 suffice below 2^256), each
// batch's 2x2 transition matrix built from the low 30 bits of f and g
// alone and then applied to the full f, g (divided by 2^30 exactly) and
// to the coefficients d, e mod p (made divisible by 2^30 with a multiple
// of p).  Values are nine signed 30-bit limbs in int32, sums in int64:
// the signed30 layout of libsecp256k1's modinv32.  Invariants: d x = f,
// e x = g (mod p); at the end g = 0, f = +-1, so x^-1 = +-d.  The input
// is the Montgomery form aR, so x^-1 = a^-1 R^-1 and one Montgomery
// product with R^3 mod p gives a^-1 R.  0 -> 0.
// tests/test_torch_inverse.py holds a step-for-step model of it.

constexpr int32_t M30 = 0x3fffffff;

struct S30 {
  int32_t v[9];  // sum v[i] 2^(30 i); v[0..7] in [0, 2^30) between steps
};

__device__ __forceinline__ S30 to_s30(const uint32_t w[8]) {
  S30 r;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const int word = 30 * i / 32, sh = 30 * i % 32;
    uint32_t lo = w[word] >> sh;
    if (sh > 2 && word < 7) lo |= w[word + 1] << (32 - sh);
    r.v[i] = (int32_t)(lo & M30);
  }
  return r;
}

// canonical limbs in [0, 2^30), value < 2^256
__device__ __forceinline__ void from_s30(const S30& a, uint32_t w[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int i = 32 * j / 30, sh = 32 * j % 30;
    w[j] = ((uint32_t)a.v[i] >> sh) | ((uint32_t)a.v[i + 1] << (30 - sh));
  }
}

// 30 divsteps on the low words f0 (odd) and g0; zeta = -(delta + 1/2).
// Returns the new zeta; t = (u, v, q, r) with 2^30 (f', g') = t (f, g).
__device__ __forceinline__ int32_t divsteps_30(int32_t zeta, uint32_t f0,
                                               uint32_t g0, int32_t t[4]) {
  uint32_t u = 1, v = 0, q = 0, r = 1, f = f0, g = g0;
#pragma unroll
  for (int i = 0; i < 30; ++i) {
    uint32_t c1 = (uint32_t)(zeta >> 31);  // zeta < 0
    const uint32_t c2 = 0u - (g & 1u);     // g odd
    const uint32_t x = (f ^ c1) - c1, y = (u ^ c1) - c1, z = (v ^ c1) - c1;
    g += x & c2;
    q += y & c2;
    r += z & c2;
    c1 &= c2;                              // swap: zeta < 0 and g odd
    zeta = (zeta ^ (int32_t)c1) - 1;
    f += g & c1;
    u += q & c1;
    v += r & c1;
    g >>= 1;
    u <<= 1;
    v <<= 1;
  }
  t[0] = (int32_t)u;
  t[1] = (int32_t)v;
  t[2] = (int32_t)q;
  t[3] = (int32_t)r;
  return zeta;
}

// (f, g) <- t (f, g) / 2^30, exact
__device__ __forceinline__ void update_fg_30(S30& f, S30& g,
                                             const int32_t t[4]) {
  int64_t cf = (int64_t)t[0] * f.v[0] + (int64_t)t[1] * g.v[0];
  int64_t cg = (int64_t)t[2] * f.v[0] + (int64_t)t[3] * g.v[0];
  cf >>= 30;
  cg >>= 30;
#pragma unroll
  for (int i = 1; i < 9; ++i) {
    cf += (int64_t)t[0] * f.v[i] + (int64_t)t[1] * g.v[i];
    cg += (int64_t)t[2] * f.v[i] + (int64_t)t[3] * g.v[i];
    f.v[i - 1] = (int32_t)cf & M30;
    g.v[i - 1] = (int32_t)cg & M30;
    cf >>= 30;
    cg >>= 30;
  }
  f.v[8] = (int32_t)cf;
  g.v[8] = (int32_t)cg;
}

// (d, e) <- (t (d, e) + p (md, me)) / 2^30, md, me chosen so the division
// is exact; d, e stay in (-2p, p)
template <class P>
__device__ __forceinline__ void update_de_30(S30& d, S30& e,
                                             const int32_t t[4],
                                             const S30& p) {
  const uint32_t pinv = (0u - P::np0) & M30;  // p^-1 mod 2^30
  const int32_t sd = d.v[8] >> 31, se = e.v[8] >> 31;
  int32_t md = (t[0] & sd) + (t[1] & se);
  int32_t me = (t[2] & sd) + (t[3] & se);
  int64_t cd = (int64_t)t[0] * d.v[0] + (int64_t)t[1] * e.v[0];
  int64_t ce = (int64_t)t[2] * d.v[0] + (int64_t)t[3] * e.v[0];
  md -= (int32_t)((pinv * (uint32_t)cd + (uint32_t)md) & M30);
  me -= (int32_t)((pinv * (uint32_t)ce + (uint32_t)me) & M30);
  cd += (int64_t)p.v[0] * md;
  ce += (int64_t)p.v[0] * me;
  cd >>= 30;
  ce >>= 30;
#pragma unroll
  for (int i = 1; i < 9; ++i) {
    cd += (int64_t)t[0] * d.v[i] + (int64_t)t[1] * e.v[i] +
          (int64_t)p.v[i] * md;
    ce += (int64_t)t[2] * d.v[i] + (int64_t)t[3] * e.v[i] +
          (int64_t)p.v[i] * me;
    d.v[i - 1] = (int32_t)cd & M30;
    e.v[i - 1] = (int32_t)ce & M30;
    cd >>= 30;
    ce >>= 30;
  }
  d.v[8] = (int32_t)cd;
  e.v[8] = (int32_t)ce;
}

// a in (-2p, p) with limbs in (-2^30, 2^30) -> sign * a mod p in [0, p)
__device__ __forceinline__ void normalize_30(S30& a, int32_t sign,
                                             const S30& p) {
  int32_t add = a.v[8] >> 31;
#pragma unroll
  for (int i = 0; i < 9; ++i) a.v[i] += p.v[i] & add;
  const int32_t ng = sign >> 31;
#pragma unroll
  for (int i = 0; i < 9; ++i) a.v[i] = (a.v[i] ^ ng) - ng;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    a.v[i + 1] += a.v[i] >> 30;
    a.v[i] &= M30;
  }
  add = a.v[8] >> 31;
#pragma unroll
  for (int i = 0; i < 9; ++i) a.v[i] += p.v[i] & add;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    a.v[i + 1] += a.v[i] >> 30;
    a.v[i] &= M30;
  }
}

template <class P>
__device__ __noinline__ Fp<P> inv_gcd(const Fp<P>& a) {
  uint32_t pw[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) pw[i] = P::p(i);
  const S30 p = to_s30(pw);
  S30 d = {{0}}, e = {{1}}, f = p, g = to_s30(a.v);
  int32_t zeta = -1;  // delta = 1/2
#pragma unroll 1
  for (int i = 0; i < 20; ++i) {
    int32_t t[4];
    zeta = divsteps_30(zeta, (uint32_t)f.v[0], (uint32_t)g.v[0], t);
    update_de_30<P>(d, e, t, p);
    update_fg_30(f, g, t);
  }
  normalize_30(d, f.v[8], p);
  Fp<P> x, r3;
  from_s30(d, x.v);
#pragma unroll
  for (int i = 0; i < 8; ++i) r3.v[i] = P::r3(i);
  return mul(x, r3);
}

// -- Fq2 ----------------------------------------------------------------------

__device__ __forceinline__ Fq2 add(const Fq2& a, const Fq2& b) {
  return Fq2{add(a.c0, b.c0), add(a.c1, b.c1)};
}
__device__ __forceinline__ Fq2 sub(const Fq2& a, const Fq2& b) {
  return Fq2{sub(a.c0, b.c0), sub(a.c1, b.c1)};
}
__device__ __forceinline__ Fq2 neg(const Fq2& a) {
  return Fq2{neg(a.c0), neg(a.c1)};
}
// Karatsuba: 3 base multiplications
__device__ __forceinline__ Fq2 mul(const Fq2& a, const Fq2& b) {
  Fq t0 = mul(a.c0, b.c0);
  Fq t1 = mul(a.c1, b.c1);
  Fq t2 = mul(add(a.c0, a.c1), add(b.c0, b.c1));
  return Fq2{sub(t0, t1), sub(sub(t2, t0), t1)};
}
__device__ __forceinline__ Fq2 sqr(const Fq2& a) { return mul(a, a); }
__device__ __forceinline__ bool is_zero(const Fq2& a) {
  return is_zero(a.c0) && is_zero(a.c1);
}
// The norm N(a) = a0^2 + a1^2 = a conj(a) lies in Fq and is nonzero for
// a != 0 (-1 is not a square mod q), so (a0 + a1 i)^-1 = conj(a) N(a)^-1:
// one base-field inversion.
__device__ __forceinline__ Fq norm(const Fq2& a) {
  return add(sqr(a.c0), sqr(a.c1));
}
__device__ __forceinline__ Fq2 conj_scale(const Fq2& a, const Fq& s) {
  return Fq2{mul(a.c0, s), neg(mul(a.c1, s))};
}
__device__ __noinline__ Fq2 inv(const Fq2& a) {
  return conj_scale(a, inv(norm(a)));
}

// -- block-wide batch inversion ------------------------------------------------

// The single-element inversion block_inverse runs on one thread: Fermat
// or Gcd (inv_gcd; Fq2 through the norm), for any field.
struct Fermat {
  template <class F>
  __device__ static __forceinline__ F inv(const F& a) { return za::inv(a); }
};
struct Gcd {
  template <class P>
  __device__ static __forceinline__ Fp<P> inv(const Fp<P>& a) {
    return inv_gcd(a);
  }
  __device__ static __forceinline__ Fq2 inv(const Fq2& a) {
    return conj_scale(a, inv_gcd(norm(a)));
  }
};

// Every thread of a block of TB threads (a power of two) passes a
// nonzero acc and gets acc^-1 back, for one Fermat per block: a product
// tree over the thread values in shared memory (tree: 2 TB elements),
// one thread inverts the root, the tree is unwound
// (inv(left) = inv(parent) * right).  About 3 multiplications per thread.
template <class F, int TB, class Inv = Fermat>
__device__ __forceinline__ F block_inverse(const F& acc, F* tree) {
  const int t = threadIdx.x;
  tree[TB + t] = acc;
  __syncthreads();
  for (int s = TB / 2; s >= 1; s >>= 1) {
    if (t < s) tree[s + t] = mul(tree[2 * (s + t)], tree[2 * (s + t) + 1]);
    __syncthreads();
  }
  if (t == 0) tree[1] = Inv::inv(tree[1]);
  __syncthreads();
  for (int s = 1; s < TB; s <<= 1) {
    if (t < s) {
      const int nd = s + t;
      const F iv = tree[nd];
      const F lft = tree[2 * nd];
      const F rgt = tree[2 * nd + 1];
      tree[2 * nd] = mul(iv, rgt);
      tree[2 * nd + 1] = mul(iv, lft);
    }
    __syncthreads();
  }
  return tree[TB + t];
}

// block_inverse with inv_gcd at the root, the tree always on Fq (tree:
// 2 TB elements of Fq).  Fq2 values go in as their norms, one Fq
// product per tree level in place of an Fq2 product's three, and come
// back as conj(acc) N(acc)^-1: 2 squarings and 2 products more a thread.
template <int TB>
__device__ __forceinline__ Fq block_inverse_gcd(const Fq& acc, Fq* tree) {
  return block_inverse<Fq, TB, Gcd>(acc, tree);
}
template <int TB>
__device__ __forceinline__ Fq2 block_inverse_gcd(const Fq2& acc, Fq* tree) {
  return conj_scale(acc, block_inverse<Fq, TB, Gcd>(norm(acc), tree));
}

// -- loads and stores of limb planes ------------------------------------------

template <class P>
__device__ __forceinline__ void load(Fp<P>& r, const uint32_t* base,
                                     size_t plane, size_t idx) {
#pragma unroll
  for (int j = 0; j < 8; ++j) r.v[j] = base[j * plane + idx];
}
template <class P>
__device__ __forceinline__ void store(uint32_t* base, size_t plane,
                                      size_t idx, const Fp<P>& a) {
#pragma unroll
  for (int j = 0; j < 8; ++j) base[j * plane + idx] = a.v[j];
}
__device__ __forceinline__ void load(Fq2& r, const uint32_t* base,
                                     size_t plane, size_t idx) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    r.c0.v[j] = base[(2 * j) * plane + idx];
    r.c1.v[j] = base[(2 * j + 1) * plane + idx];
  }
}
__device__ __forceinline__ void store(uint32_t* base, size_t plane,
                                      size_t idx, const Fq2& a) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    base[(2 * j) * plane + idx] = a.c0.v[j];
    base[(2 * j + 1) * plane + idx] = a.c1.v[j];
  }
}

// number of 32-bit limb planes of one element
template <class F> struct Planes;
template <> struct Planes<Fq> { static constexpr int n = 8; };
template <> struct Planes<Fq2> { static constexpr int n = 16; };

}  // namespace za

// Error text for the codes the C entry points return.
extern "C" const char* za_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
