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
// (a0 + a1 i)^-1 = (a0 - a1 i) / (a0^2 + a1^2): one base-field Fermat
__device__ __noinline__ Fq2 inv(const Fq2& a) {
  Fq ninv = inv(add(sqr(a.c0), sqr(a.c1)));
  return Fq2{mul(a.c0, ninv), neg(mul(a.c1, ninv))};
}

// -- block-wide batch inversion ------------------------------------------------

// Every thread of a block of TB threads (a power of two) passes a
// nonzero acc and gets acc^-1 back, for one Fermat per block: a product
// tree over the thread values in shared memory (tree: 2 TB elements),
// one thread inverts the root, the tree is unwound
// (inv(left) = inv(parent) * right).  About 3 multiplications per thread.
template <class F, int TB>
__device__ __forceinline__ F block_inverse(const F& acc, F* tree) {
  const int t = threadIdx.x;
  tree[TB + t] = acc;
  __syncthreads();
  for (int s = TB / 2; s >= 1; s >>= 1) {
    if (t < s) tree[s + t] = mul(tree[2 * (s + t)], tree[2 * (s + t) + 1]);
    __syncthreads();
  }
  if (t == 0) tree[1] = inv(tree[1]);
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
