// Dense window sums of the MSM, for G1 (Fq) and G2 (Fq2), at two radices.
//
// Replaces two Pallas kernels of the reference that compute one function:
//   pallas_msm_rns.py dense_window_sums_pallas (_kernel), signed radix 16
//     -> dense_window_sums_g1, dense_window_sums_g2
//   pallas_msm.py dense_msm_window_sums, unsigned radix 4
//     -> dense4_window_sums_g1, dense4_window_sums_g2
//
// What a launch computes, on canonical Montgomery values.  M same-size
// MSMs of n points each come with the multiples {1P..KP} of every point
// (K = 8 signed, 3 radix-4; built by ec_add, once per pk at staging) and
// digits d (W, M, n): W = 64 signed digits in [-8, 8], or W = 127
// unsigned 2-bit digits.  For MSM m, window w and lane l < L:
//   S[m, w, l] = sum over i = l, l + L, l + 2L, ... < n of |d_i| P_i,
// negated (Y -> -Y) where d_i < 0; d_i = 0 adds nothing.  The sums are
// projective (complete additions, RCB), output as (E planes, M, W, L);
// the lane fold and the Horner combine follow (engine/msm.py).  The
// radix-4 Pallas kernel adds the identity for a zero digit; skipping
// the add gives the same point with fewer additions.
//
// Design.  One thread owns one accumulator (m, w, l) and walks its
// n / L points in order, so no thread ever waits on another and the
// result is deterministic.  Neighbouring threads take neighbouring
// lanes of one (m, w): the digit and limb-plane reads of a warp are
// consecutive words, and the W windows re-read the same multiples out of
// L2.  The host picks L so that M * W * L is about 2^15 threads, which
// fills the card at the ~8 resident warps per SM the register use allows.
//
// Bound: integer multiplies, one add per nonzero digit.  An add needs
// 12 field multiplications plus two by 3b: in G1, 3b = 9 takes adds
// only, so 12 (~3.1k 32-bit multiply-adds); in G2, 14 Fq2 ones (x3).
// (point_add multiplies by 3b as by any constant.)  Bytes are the
// multiples and digits read once and the sums written once.  A warp runs the add whenever any of its 32 lanes
// has a nonzero digit, so zero digits save time only where they cluster.

#include "curve.cuh"

namespace za {

constexpr int DTB = 128;  // threads per block

template <class F, bool SIGNED>
__global__ void __launch_bounds__(DTB)
dense_sums_kernel(const uint32_t* __restrict__ mx,
                  const uint32_t* __restrict__ my,
                  const uint32_t* __restrict__ mz,
                  const int8_t* __restrict__ d, uint32_t* __restrict__ ox,
                  uint32_t* __restrict__ oy, uint32_t* __restrict__ oz,
                  int M, int W, int n, int L) {
  const size_t total = (size_t)M * W * L;
  const size_t t = (size_t)blockIdx.x * DTB + threadIdx.x;
  if (t >= total) return;
  const int l = (int)(t % L);
  const int r = (int)(t / L);  // m * W + w
  const int m = r / W, w = r - m * W;
  const size_t plane = (size_t)M * n;
  const size_t entry = (size_t)Planes<F>::n * plane;
  const size_t col0 = (size_t)m * n;
  const int8_t* drow = d + ((size_t)w * M + m) * n;
  F x = zero<F>(), y = one<F>(), z = zero<F>();
#pragma unroll 1
  for (int i = l; i < n; i += L) {
    const int dv = drow[i];
    if (dv == 0) continue;
    const size_t k = (size_t)((dv < 0 ? -dv : dv) - 1);
    F px, py, pz;
    load(px, mx + k * entry, plane, col0 + i);
    load(py, my + k * entry, plane, col0 + i);
    load(pz, mz + k * entry, plane, col0 + i);
    if (SIGNED && dv < 0) py = neg(py);
    point_add(x, y, z, px, py, pz, x, y, z);
  }
  store(ox, total, t, x);
  store(oy, total, t, y);
  store(oz, total, t, z);
}

template <class F, bool SIGNED>
int launch(const void* mx, const void* my, const void* mz, const void* d,
           void* ox, void* oy, void* oz, int M, int W, int n, int L,
           void* stream) {
  const size_t total = (size_t)M * W * L;
  if (total > 0) {
    dense_sums_kernel<F, SIGNED>
        <<<(unsigned)((total + DTB - 1) / DTB), DTB, 0,
           (cudaStream_t)stream>>>(
            (const uint32_t*)mx, (const uint32_t*)my, (const uint32_t*)mz,
            (const int8_t*)d, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, M,
            W, n, L);
  }
  return (int)cudaGetLastError();
}

}  // namespace za

extern "C" {

// mx, my, mz: (8, 8, M, n) int32 (multiple, limb plane, query, point);
// d: (64, M, n) int8 -> ox, oy, oz: (8, M, 64, L) per-lane window sums
int dense_window_sums_g1(const void* mx, const void* my, const void* mz,
                         const void* d, void* ox, void* oy, void* oz, int M,
                         int n, int L, void* stream) {
  return za::launch<za::Fq, true>(mx, my, mz, d, ox, oy, oz, M, 64, n, L,
                                  stream);
}

// (8, 16, M, n): limb plane 2j + c holds limb j of component c
int dense_window_sums_g2(const void* mx, const void* my, const void* mz,
                         const void* d, void* ox, void* oy, void* oz, int M,
                         int n, int L, void* stream) {
  return za::launch<za::Fq2, true>(mx, my, mz, d, ox, oy, oz, M, 64, n, L,
                                   stream);
}

// mx, my, mz: (3, 8, M, n); d: (127, M, n) int8 in [0, 3]
int dense4_window_sums_g1(const void* mx, const void* my, const void* mz,
                          const void* d, void* ox, void* oy, void* oz, int M,
                          int n, int L, void* stream) {
  return za::launch<za::Fq, false>(mx, my, mz, d, ox, oy, oz, M, 127, n, L,
                                   stream);
}

int dense4_window_sums_g2(const void* mx, const void* my, const void* mz,
                          const void* d, void* ox, void* oy, void* oz, int M,
                          int n, int L, void* stream) {
  return za::launch<za::Fq2, false>(mx, my, mz, d, ox, oy, oz, M, 127, n, L,
                                    stream);
}

}  // extern "C"
