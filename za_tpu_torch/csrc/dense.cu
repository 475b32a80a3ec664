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
// unsigned 2-bit digits.  For MSM m, window w and lane l < L, with S
// segments a lane:
//   S[m, w, l] = fold-half over s < S of T[m, w, l + s L],
//   T[m, w, j] = sum over i = j, j + S L, j + 2 S L, ... < n of |d_i| P_i
// (negated, Y -> -Y, where d_i < 0; d_i = 0 adds nothing), the fold-half
// adding segment s + h into segment s for h = S/2, ..., 1.  That is the
// per-lane sum at S L lanes and the first log2 S levels of the lane fold
// (msm.lane_fold), so every split of S L into (L, S) gives the same
// MSM, bit for bit.  The sums are projective (complete additions, RCB),
// output as (E planes, M, W, L); the lane fold and the Horner combine
// follow (engine/msm.py).  The radix-4 Pallas kernel adds the identity
// for a zero digit; skipping the add gives the same point with fewer
// additions.
//
// What bounded the first design: one thread owned one accumulator and
// walked its n / L points, and the host kept M W L at 2^15 threads, 7.8
// warps an SM: two warps a scheduler to cover each add's Montgomery
// chains (1.357 ms in G1, 0.965 ms in G2, 3.0-3.1x the bound), the G2
// kernel held to 2 blocks an SM by its 255 registers (48 B of spills),
// and the last query of the stacked g1x4 (h, twice the nonzero digits
// of a, b1 and l) ran alone at the end of the launch.
//
// Design.  A block holds DTB / S lanes and their S segments: thread
// (s, j) walks the points of segment s of lane j in order, then, where
// S > 1, the block folds the segments in shared memory (fold-half, one
// __syncthreads a level, the add out of line) and segment 0 stores the
// lane.  The host (engine/msm_dense.lanes) sizes S L from the card: its
// SMs times the blocks of this kernel one SM holds (dense_resident_blocks,
// cudaOccupancyMaxActiveBlocksPerMultiprocessor) times a number of
// waves; blocks take the accumulators window by window with the M
// queries side by side, so every wave mixes queries of unequal work.
// Neighbouring threads take neighbouring lanes: the digit and
// limb-plane reads of a warp are consecutive words, and the W windows
// re-read the same multiples out of L2.  G1 multiplies by 3b = 9 with
// additions (curve.cuh mul_b3); G2 runs its products as calls of one
// out-of-line Fq2 product (OpsCall), which leaves no spills.
//
// Measured (tools/torch_dense_sweep.py, NVIDIA H100 80GB HBM3, 700.00 W,
// device time at the 2^13 shapes): G1 1.03 ms at 512 lanes, S = 1, 156
// registers, 12 warps an SM (parent kernel at 512 lanes 1.17, x9 by a
// product 1.18); G2 0.90 ms at 128 lanes, S = 4, 251 registers, 8 warps
// (inlined products 1.06, 152 B of spills).  More warps did not help:
// capped at 128 or 96 registers G1 ran within 0.06 ms of uncapped; G2
// capped at 168 or 128 spilled 0.5-4.8 KB and lost 8-150%.  At 8-12
// warps an SM both run at 37-44% of the INT32 multiply-add rate the
// bound assumes: the product's instruction stream, not the chains in
// flight, holds them.
//
// Bound: integer multiplies, one add per nonzero digit and S - 1 a lane
// for the fold.  A G1 add runs 12 field products: its two products by 3b
// = 9 are four modular additions each (curve.cuh mul_b3); a G2 add 14
// Fq2 ones (x3).  Bytes are the multiples and digits read once and the
// sums written once.  A warp runs the add whenever any of its 32 lanes
// has a nonzero digit, so zero digits save time only where they cluster.

#include "curve.cuh"

namespace za {

constexpr int DTB = 128;  // threads per block

// Segment a += segment b of a block's fold, both points in shared memory
// (planes of DTB words): out of line, so the walk's inlined add is the
// only one the kernel's registers are sized for.
template <class F, class O>
__device__ __noinline__ void fold_add(uint32_t* part, int a, int b) {
  constexpr int NP = Planes<F>::n;
  F x1, y1, z1, x2, y2, z2;
  load(x1, part, DTB, a);
  load(y1, part + NP * DTB, DTB, a);
  load(z1, part + 2 * NP * DTB, DTB, a);
  load(x2, part, DTB, b);
  load(y2, part + NP * DTB, DTB, b);
  load(z2, part + 2 * NP * DTB, DTB, b);
  point_add<F, O>(x1, y1, z1, x2, y2, z2, x1, y1, z1);
  store(part, DTB, a, x1);
  store(part + NP * DTB, DTB, a, y1);
  store(part + 2 * NP * DTB, DTB, a, z1);
}

template <class F, bool SIGNED, int MINB, class O>
__global__ void __launch_bounds__(DTB, MINB)
dense_sums_kernel(const uint32_t* __restrict__ mx,
                  const uint32_t* __restrict__ my,
                  const uint32_t* __restrict__ mz,
                  const int8_t* __restrict__ d, uint32_t* __restrict__ ox,
                  uint32_t* __restrict__ oy, uint32_t* __restrict__ oz,
                  int M, int W, int n, int L, int S) {
  constexpr int NP = Planes<F>::n;
  __shared__ uint32_t part[3 * NP * DTB];  // the segments' sums, S > 1
  const int per = DTB / S;                 // lanes of the block
  const int j = threadIdx.x % per, s = threadIdx.x / per;
  const size_t total = (size_t)M * W * L;
  const size_t a = (size_t)blockIdx.x * per + j;  // (w, m, l), l fastest
  const bool live = a < total;
  const int l = (int)(a % L);
  const int r = (int)(a / L);  // w * M + m: the digit row
  const int w = r / M, m = r - w * M;
  F x = zero<F>(), y = one<F>(), z = zero<F>();
  if (live) {
    const size_t plane = (size_t)M * n;
    const size_t entry = (size_t)NP * plane;
    const size_t col0 = (size_t)m * n;
    const int8_t* drow = d + (size_t)r * n;
#pragma unroll 1
    for (int i = l + s * L; i < n; i += S * L) {
      const int dv = drow[i];
      if (dv == 0) continue;
      const size_t k = (size_t)((dv < 0 ? -dv : dv) - 1);
      F px, py, pz;
      load(px, mx + k * entry, plane, col0 + i);
      load(py, my + k * entry, plane, col0 + i);
      load(pz, mz + k * entry, plane, col0 + i);
      if (SIGNED && dv < 0) py = neg(py);
      point_add<F, O>(x, y, z, px, py, pz, x, y, z);
    }
  }
  if (S > 1) {  // fold-half over the segments: s += s + h
    const int self = s * per + j;
    store(part, DTB, self, x);
    store(part + NP * DTB, DTB, self, y);
    store(part + 2 * NP * DTB, DTB, self, z);
    __syncthreads();
#pragma unroll 1
    for (int h = S >> 1; h > 0; h >>= 1) {
      if (s < h) fold_add<F, O>(part, self, self + h * per);
      __syncthreads();
    }
    load(x, part, DTB, self);
    load(y, part + NP * DTB, DTB, self);
    load(z, part + 2 * NP * DTB, DTB, self);
  }
  if (live && s == 0) {
    const size_t t = ((size_t)m * W + w) * L + l;
    store(ox, total, t, x);
    store(oy, total, t, y);
    store(oz, total, t, z);
  }
}

template <class F, bool SIGNED, int MINB, class O>
int launch(const void* mx, const void* my, const void* mz, const void* d,
           void* ox, void* oy, void* oz, int M, int W, int n, int L, int S,
           void* stream) {
  if (S < 1 || S > DTB || (S & (S - 1)) || L < 1)
    return (int)cudaErrorInvalidValue;
  const size_t total = (size_t)M * W * L, per = DTB / S;
  if (total > 0) {
    dense_sums_kernel<F, SIGNED, MINB, O>
        <<<(unsigned)((total + per - 1) / per), DTB, 0,
           (cudaStream_t)stream>>>(
            (const uint32_t*)mx, (const uint32_t*)my, (const uint32_t*)mz,
            (const int8_t*)d, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, M,
            W, n, L, S);
  }
  return (int)cudaGetLastError();
}

// blocks of the kernel one SM holds at once (negative: a CUDA error)
template <class F, bool SIGNED, int MINB, class O>
int resident_blocks() {
  int nb = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &nb, dense_sums_kernel<F, SIGNED, MINB, O>, DTB, 0);
  return e == cudaSuccess ? nb : -(int)e;
}

// The register cap (min blocks an SM in __launch_bounds__) and the
// products of each field, chosen by tools/torch_dense_sweep.py (PERF.md):
// no cap in either (above); G2's products as calls.
template <class F> struct Dense;
template <> struct Dense<Fq> {
  static constexpr int MINB = 1;
  using O = Ops;
};
template <> struct Dense<Fq2> {
  static constexpr int MINB = 1;
  using O = OpsCall;
};

template <class F, bool SIGNED>
int launch_dense(const void* mx, const void* my, const void* mz,
                 const void* d, void* ox, void* oy, void* oz, int M, int W,
                 int n, int L, int S, void* stream) {
  return launch<F, SIGNED, Dense<F>::MINB, typename Dense<F>::O>(
      mx, my, mz, d, ox, oy, oz, M, W, n, L, S, stream);
}

template <class F, bool SIGNED>
int resident_dense() {
  return resident_blocks<F, SIGNED, Dense<F>::MINB, typename Dense<F>::O>();
}

}  // namespace za

extern "C" {

#ifndef ZA_DENSE_VARIANT

// mx, my, mz: (8, 8, M, n) int32 (multiple, limb plane, query, point);
// d: (64, M, n) int8 -> ox, oy, oz: (8, M, 64, L) per-lane window sums,
// S segments a lane (a power of two up to DTB)
int dense_window_sums_g1(const void* mx, const void* my, const void* mz,
                         const void* d, void* ox, void* oy, void* oz, int M,
                         int n, int L, int S, void* stream) {
  return za::launch_dense<za::Fq, true>(mx, my, mz, d, ox, oy, oz, M, 64, n,
                                        L, S, stream);
}

// (8, 16, M, n): limb plane 2j + c holds limb j of component c
int dense_window_sums_g2(const void* mx, const void* my, const void* mz,
                         const void* d, void* ox, void* oy, void* oz, int M,
                         int n, int L, int S, void* stream) {
  return za::launch_dense<za::Fq2, true>(mx, my, mz, d, ox, oy, oz, M, 64,
                                         n, L, S, stream);
}

// mx, my, mz: (3, 8, M, n); d: (127, M, n) int8 in [0, 3]
int dense4_window_sums_g1(const void* mx, const void* my, const void* mz,
                          const void* d, void* ox, void* oy, void* oz, int M,
                          int n, int L, int S, void* stream) {
  return za::launch_dense<za::Fq, false>(mx, my, mz, d, ox, oy, oz, M, 127,
                                         n, L, S, stream);
}

int dense4_window_sums_g2(const void* mx, const void* my, const void* mz,
                          const void* d, void* ox, void* oy, void* oz, int M,
                          int n, int L, int S, void* stream) {
  return za::launch_dense<za::Fq2, false>(mx, my, mz, d, ox, oy, oz, M, 127,
                                          n, L, S, stream);
}

// resident blocks an SM of the kernel behind dense{4 if radix4}_window_
// sums_{g2 if g2 else g1}
int dense_resident_blocks(int g2, int radix4) {
  if (g2)
    return radix4 ? za::resident_dense<za::Fq2, false>()
                  : za::resident_dense<za::Fq2, true>();
  return radix4 ? za::resident_dense<za::Fq, false>()
                : za::resident_dense<za::Fq, true>();
}

#else  // one variant of the signed kernel, for tools/torch_dense_sweep.py:
       // -DZA_DENSE_VARIANT -DZA_DV_F=Fq2 -DZA_DV_MINB=4 -DZA_DV_OPS=OpsCall

int dense_variant(const void* mx, const void* my, const void* mz,
                  const void* d, void* ox, void* oy, void* oz, int M, int n,
                  int L, int S, void* stream) {
  return za::launch<za::ZA_DV_F, true, ZA_DV_MINB, za::ZA_DV_OPS>(
      mx, my, mz, d, ox, oy, oz, M, 64, n, L, S, stream);
}

int dense_variant_blocks() {
  return za::resident_blocks<za::ZA_DV_F, true, ZA_DV_MINB, za::ZA_DV_OPS>();
}

#endif

}  // extern "C"
