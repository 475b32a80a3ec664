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

// (x1:y1:z1) + (x2:y2:z2), RCB algorithm 7 (a = 0): the same operation
// order as engine/ec.py point_add, so both give the same coordinates.
// The outputs may alias the inputs: no input is read after xo is set.
template <class F>
__device__ __forceinline__ void point_add(const F& x1, const F& y1,
                                          const F& z1, const F& x2,
                                          const F& y2, const F& z2, F& xo,
                                          F& yo, F& zo) {
  const F k = b3<F>();
  F t0 = mul(x1, x2);
  F t1 = mul(y1, y2);
  F t2 = mul(z1, z2);
  F t3 = mul(add(x1, y1), add(x2, y2));
  F t4 = add(t0, t1);
  t3 = sub(t3, t4);
  t4 = mul(add(y1, z1), add(y2, z2));
  F x3 = add(t1, t2);
  t4 = sub(t4, x3);
  x3 = mul(add(x1, z1), add(x2, z2));
  F y3 = add(t0, t2);
  y3 = sub(x3, y3);
  x3 = add(t0, t0);
  t0 = add(x3, t0);
  t2 = mul(k, t2);
  F z3 = add(t1, t2);
  t1 = sub(t1, t2);
  y3 = mul(k, y3);
  x3 = mul(t4, y3);
  t2 = mul(t3, t1);
  xo = sub(t2, x3);
  y3 = mul(y3, t0);
  t1 = mul(t1, z3);
  yo = add(t1, y3);
  t0 = mul(t0, t3);
  z3 = mul(z3, t4);
  zo = add(z3, t0);
}

}  // namespace za
