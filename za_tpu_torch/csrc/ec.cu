// Elementwise curve kernels for G1 (over Fq) and G2 (over Fq2).
//
// ec_add: complete projective addition (Renes-Costello-Batina 2015,
// algorithm 7, a = 0), one point pair per thread.  It serves the
// {1P..8P} table build at staging, the per-chunk projective carry and
// the lane fold of the tree MSM.
// horner: the window combine sum_w 2^(bits w) S_w of M MSMs in one
// launch, one thread per MSM (320 dependent adds each at radix 16, 381
// at radix 4): as that many ec_add launches on a few points it cost
// more in launches than in arithmetic.  The group law is curve.cuh's.
// In the reference all of these are XLA code (za_tpu/engine/ec.py
// point_add, msm.build_multiples, msm.lane_fold, msm.horner_windows),
// not Pallas kernels.
// to_affine: projective -> affine (Z = 0 maps to 0), the reference's
// msm_tree._normalize_affine: a block batch-inverts the Z of its TB * K
// points (prefix products per thread, block_inverse, walk back), so a
// point costs ~5 multiplications and the block one Fermat (~380).
//
// Bound: integer multiplies.  An add is 12 field multiplications plus
// two by 3b (G1: ~3.6k 32-bit multiply-adds; G2 x3 with Karatsuba), a
// normalisation ~5 (3 for the batch inversion, 2 for X/Z and Y/Z); bytes
// are 6 (resp. 3) elements in and 3 (resp. 2) out.  The design keeps
// every operand in registers and launches one thread per point (K per
// thread for to_affine); the work is independent, so the card fills
// once there are more than ~100k points, as at table build.

#include "curve.cuh"

namespace za {

template <class F>
__global__ void ec_add_kernel(const uint32_t* __restrict__ X1,
                              const uint32_t* __restrict__ Y1,
                              const uint32_t* __restrict__ Z1,
                              const uint32_t* __restrict__ X2,
                              const uint32_t* __restrict__ Y2,
                              const uint32_t* __restrict__ Z2,
                              uint32_t* __restrict__ X3,
                              uint32_t* __restrict__ Y3,
                              uint32_t* __restrict__ Z3, int n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)n) return;
  F x1, y1, z1, x2, y2, z2, x3, y3, z3;
  load(x1, X1, n, i); load(y1, Y1, n, i); load(z1, Z1, n, i);
  load(x2, X2, n, i); load(y2, Y2, n, i); load(z2, Z2, n, i);
  point_add(x1, y1, z1, x2, y2, z2, x3, y3, z3);
  store(X3, n, i, x3);
  store(Y3, n, i, y3);
  store(Z3, n, i, z3);
}

// Horner over the window sums of M MSMs: one thread per MSM walks the
// W windows MSB first, acc = 2^bits acc + S_w (bits doublings through
// the complete add, then one add; bits = 4 for signed radix-16, 2 for
// radix-4).  Input (E, M, W), output (E, M).
template <class F>
__global__ void horner_kernel(const uint32_t* __restrict__ WX,
                              const uint32_t* __restrict__ WY,
                              const uint32_t* __restrict__ WZ,
                              uint32_t* __restrict__ X,
                              uint32_t* __restrict__ Y,
                              uint32_t* __restrict__ Z, int M, int W,
                              int bits) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const size_t plane = (size_t)M * W;
  F x = zero<F>(), y = one<F>(), z = zero<F>();
#pragma unroll 1
  for (int w = W - 1; w >= 0; --w) {
#pragma unroll 1
    for (int k = 0; k < bits; ++k) point_add(x, y, z, x, y, z, x, y, z);
    F sx, sy, sz;
    const size_t idx = (size_t)m * W + w;
    load(sx, WX, plane, idx);
    load(sy, WY, plane, idx);
    load(sz, WZ, plane, idx);
    point_add(x, y, z, sx, sy, sz, x, y, z);
  }
  store(X, M, m, x);
  store(Y, M, m, y);
  store(Z, M, m, z);
}

constexpr int AFF_TB = 128;  // threads per to_affine block

// Thread t of a block walks points t, t + AFF_TB, ... of the block's
// AFF_TB * K (coalesced across the warp), keeping the exclusive prefix
// products of its nonzero Z; after block_inverse it walks back, emitting
// 1/Z = inv_acc * prefix and stepping inv_acc past Z.
template <class F, int K>
__global__ void __launch_bounds__(AFF_TB)
to_affine_kernel(const uint32_t* __restrict__ X,
                 const uint32_t* __restrict__ Y,
                 const uint32_t* __restrict__ Z, uint32_t* __restrict__ x,
                 uint32_t* __restrict__ y, int n) {
  __shared__ F tree[2 * AFF_TB];
  const size_t i0 = (size_t)blockIdx.x * AFF_TB * K + threadIdx.x;
  F pre[K];
  F acc = one<F>();
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const size_t i = i0 + (size_t)j * AFF_TB;
    pre[j] = acc;
    if (i < (size_t)n) {
      F z;
      load(z, Z, n, i);
      if (!is_zero(z)) acc = mul(acc, z);
    }
  }
  F inv_acc = block_inverse<F, AFF_TB>(acc, tree);
#pragma unroll
  for (int j = K - 1; j >= 0; --j) {
    const size_t i = i0 + (size_t)j * AFF_TB;
    if (i >= (size_t)n) continue;
    F a, b, z;
    load(z, Z, n, i);
    F zi = zero<F>();
    if (!is_zero(z)) {
      zi = mul(inv_acc, pre[j]);
      inv_acc = mul(inv_acc, z);
    }
    load(a, X, n, i);
    load(b, Y, n, i);
    store(x, n, i, mul(a, zi));
    store(y, n, i, mul(b, zi));
  }
}

template <class F>
int launch_add(const void* X1, const void* Y1, const void* Z1,
               const void* X2, const void* Y2, const void* Z2, void* X3,
               void* Y3, void* Z3, int n, void* stream) {
  if (n > 0) {
    const int tb = 128;
    ec_add_kernel<F><<<(n + tb - 1) / tb, tb, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)X1, (const uint32_t*)Y1, (const uint32_t*)Z1,
        (const uint32_t*)X2, (const uint32_t*)Y2, (const uint32_t*)Z2,
        (uint32_t*)X3, (uint32_t*)Y3, (uint32_t*)Z3, n);
  }
  return (int)cudaGetLastError();
}

template <class F>
int launch_horner(const void* WX, const void* WY, const void* WZ, void* X,
                  void* Y, void* Z, int M, int W, int bits, void* stream) {
  if (M > 0) {
    const int tb = 32;
    horner_kernel<F><<<(M + tb - 1) / tb, tb, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)WX, (const uint32_t*)WY, (const uint32_t*)WZ,
        (uint32_t*)X, (uint32_t*)Y, (uint32_t*)Z, M, W, bits);
  }
  return (int)cudaGetLastError();
}

template <class F, int K>
int launch_affine(const void* X, const void* Y, const void* Z, void* x,
                  void* y, int n, void* stream) {
  if (n > 0) {
    const int per = AFF_TB * K;
    to_affine_kernel<F, K><<<(n + per - 1) / per, AFF_TB, 0,
                             (cudaStream_t)stream>>>(
        (const uint32_t*)X, (const uint32_t*)Y, (const uint32_t*)Z,
        (uint32_t*)x, (uint32_t*)y, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace za

extern "C" {

int ec_add_g1(const void* X1, const void* Y1, const void* Z1, const void* X2,
              const void* Y2, const void* Z2, void* X3, void* Y3, void* Z3,
              int n, void* stream) {
  return za::launch_add<za::Fq>(X1, Y1, Z1, X2, Y2, Z2, X3, Y3, Z3, n,
                                stream);
}

int ec_add_g2(const void* X1, const void* Y1, const void* Z1, const void* X2,
              const void* Y2, const void* Z2, void* X3, void* Y3, void* Z3,
              int n, void* stream) {
  return za::launch_add<za::Fq2>(X1, Y1, Z1, X2, Y2, Z2, X3, Y3, Z3, n,
                                 stream);
}

int horner_g1(const void* WX, const void* WY, const void* WZ, void* X,
              void* Y, void* Z, int M, int W, int bits, void* stream) {
  return za::launch_horner<za::Fq>(WX, WY, WZ, X, Y, Z, M, W, bits, stream);
}

int horner_g2(const void* WX, const void* WY, const void* WZ, void* X,
              void* Y, void* Z, int M, int W, int bits, void* stream) {
  return za::launch_horner<za::Fq2>(WX, WY, WZ, X, Y, Z, M, W, bits, stream);
}

int to_affine_g1(const void* X, const void* Y, const void* Z, void* x,
                 void* y, int n, void* stream) {
  return za::launch_affine<za::Fq, 8>(X, Y, Z, x, y, n, stream);
}

int to_affine_g2(const void* X, const void* Y, const void* Z, void* x,
                 void* y, int n, void* stream) {
  return za::launch_affine<za::Fq2, 4>(X, Y, Z, x, y, n, stream);
}

}  // extern "C"
