// The complete projective group law of G1 (over Fq) and G2 (over Fq2),
// shared by the curve kernels (ec.cu) and the dense window sums
// (dense.cu): header-only __device__ code over field.cuh.

#pragma once

#include "field.cuh"

namespace za {

template <class F> __device__ __forceinline__ F b3();
template <> __device__ __forceinline__ Fq b3<Fq>() {  // 3 * 3, Montgomery
  Fq r;
  constexpr uint32_t v[8] = {0x410d7ff7u, 0xf60647ceu, 0xd31bd011u,
                             0x2f3d6f4du, 0x3940c6d1u, 0x2943337eu,
                             0xa7e39857u, 0x1d9598e8u};
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = v[i];
  return r;
}
template <> __device__ __forceinline__ Fq2 b3<Fq2>() {  // 3 * 3/(9+i)
  Fq2 r;
  constexpr uint32_t c0[8] = {0xb62e0d6au, 0x3baa927cu, 0xd1b664fdu,
                              0xd71e7c52u, 0xd95d4664u, 0x03873e63u,
                              0x082ab8f4u, 0x0e75b5b1u};
  constexpr uint32_t c1[8] = {0x7596fe35u, 0xaab7c666u, 0xbb6a27bau,
                              0x31d21a78u, 0x680401ffu, 0x85dd7297u,
                              0xdf39a7e9u, 0x03c52d6au};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    r.c0.v[i] = c0[i];
    r.c1.v[i] = c1[i];
  }
  return r;
}

// The product by 3b.  In G1, 3b = 9 and 9 a = 8 a + a: three modular
// doublings and an add on canonical values: the same canonical value as
// the Montgomery product by 9 R mod q, in four modular additions, so a
// G1 add runs 12 products, not 14.  In G2, 3b' is a full Fq2
// constant and stays a product.
__device__ __forceinline__ Fq mul_b3(const Fq& a) {
  Fq r = add(a, a);
  r = add(r, r);
  r = add(r, r);
  return add(r, a);
}
__device__ __forceinline__ Fq2 mul_b3(const Fq2& a) {
  return mul(b3<Fq2>(), a);
}

// The field products of point_add.  Ops is the default: products
// inlined, 3b by mul_b3.  OpsEo serves ec_add_g2 (ec.cu): the Fq2
// products as Karatsuba over mul_eo, inlined.  The others serve
// tools/torch_dense_sweep.py's variants of the dense kernel: OpsB3Mul
// multiplies by 3b as by any constant (the add before mul_b3); OpsCall
// runs each product as a call of one out-of-line body, OpsCallFq the
// Fq2 products as Karatsuba over calls of the Fq mul.
struct Ops {
  template <class F>
  __device__ static __forceinline__ F mul(const F& a, const F& b) {
    return za::mul(a, b);
  }
  template <class F>
  __device__ static __forceinline__ F mul3b(const F& a) {
    return mul_b3(a);
  }
};
struct OpsB3Mul : Ops {
  template <class F>
  __device__ static __forceinline__ F mul3b(const F& a) {
    return za::mul(b3<F>(), a);
  }
};
template <class F>
__device__ __noinline__ F mul_call(const F& a, const F& b) {
  return mul(a, b);
}
struct OpsCall {
  template <class F>
  __device__ static __forceinline__ F mul(const F& a, const F& b) {
    return mul_call(a, b);
  }
  __device__ static __forceinline__ Fq mul3b(const Fq& a) {
    return mul_b3(a);
  }
  __device__ static __forceinline__ Fq2 mul3b(const Fq2& a) {
    return mul_call(b3<Fq2>(), a);
  }
};
// The Fq2 products as Karatsuba over C::f, the Fq product
template <class C>
struct OpsKaratsuba {
  __device__ static __forceinline__ Fq mul(const Fq& a, const Fq& b) {
    return C::f(a, b);
  }
  __device__ static __forceinline__ Fq2 mul(const Fq2& a, const Fq2& b) {
    const Fq t0 = C::f(a.c0, b.c0);
    const Fq t1 = C::f(a.c1, b.c1);
    const Fq t2 = C::f(add(a.c0, a.c1), add(b.c0, b.c1));
    return Fq2{sub(t0, t1), sub(sub(t2, t0), t1)};
  }
  __device__ static __forceinline__ Fq mul3b(const Fq& a) {
    return mul_b3(a);
  }
  __device__ static __forceinline__ Fq2 mul3b(const Fq2& a) {
    return mul(b3<Fq2>(), a);
  }
};
struct CallMul {
  __device__ static __forceinline__ Fq f(const Fq& a, const Fq& b) {
    return mul_call(a, b);
  }
};
struct MulEo {
  __device__ static __forceinline__ Fq f(const Fq& a, const Fq& b) {
    return mul_eo(a, b);
  }
};
using OpsCallFq = OpsKaratsuba<CallMul>;
using OpsEo = OpsKaratsuba<MulEo>;

// (x1:y1:z1) + (x2:y2:z2), RCB algorithm 7 (a = 0): the same operation
// order as engine/ec.py point_add, so both give the same coordinates.
// The outputs may alias the inputs: no input is read after xo is set.
// z01: 1 where z2 is 0 or 1 (Montgomery), the Z of a flagged affine
// point, 2 where z1 is too: z1 z2 is then z1 or 0, and with both the
// cross terms y1 z2 + y2 z1 and x1 z2 + x2 z1 (the two products less t1
// + t2 and t0 + t2) are sums of selections, the same canonical values
// in 9 products instead of 12.
template <class F, class O = Ops>
__device__ __forceinline__ void point_add(const F& x1, const F& y1,
                                          const F& z1, const F& x2,
                                          const F& y2, const F& z2, F& xo,
                                          F& yo, F& zo, int z01 = 0) {
  F t0 = O::mul(x1, x2);
  F t1 = O::mul(y1, y2);
  F t2 = z01 ? (is_zero(z2) ? zero<F>() : z1) : O::mul(z1, z2);
  F t3 = O::mul(add(x1, y1), add(x2, y2));
  F t4 = add(t0, t1);
  t3 = sub(t3, t4);
  F x3, y3;
  if (z01 == 2) {
    const F z = zero<F>();
    const bool f1 = !is_zero(z1), f2 = !is_zero(z2);
    t4 = add(f2 ? y1 : z, f1 ? y2 : z);
    y3 = add(f2 ? x1 : z, f1 ? x2 : z);
  } else {
    t4 = O::mul(add(y1, z1), add(y2, z2));
    x3 = add(t1, t2);
    t4 = sub(t4, x3);
    x3 = O::mul(add(x1, z1), add(x2, z2));
    y3 = add(t0, t2);
    y3 = sub(x3, y3);
  }
  x3 = add(t0, t0);
  t0 = add(x3, t0);
  t2 = O::mul3b(t2);
  F z3 = add(t1, t2);
  t1 = sub(t1, t2);
  y3 = O::mul3b(y3);
  x3 = O::mul(t4, y3);
  t2 = O::mul(t3, t1);
  xo = sub(t2, x3);
  y3 = O::mul(y3, t0);
  t1 = O::mul(t1, z3);
  yo = add(t1, y3);
  t0 = O::mul(t0, t3);
  z3 = O::mul(z3, t4);
  zo = add(z3, t0);
}

}  // namespace za
