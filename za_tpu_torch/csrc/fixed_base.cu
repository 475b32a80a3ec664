// Fixed-base scalar multiplication for the trusted setup: s_i * G for a
// vector of scalars s_i and one generator G of G1 (over Fq) or G2 (over
// Fq2).  The pk's queries are ~5 n G1 and n G2 multiples of the two
// generators at n constraints, so a window table of G's multiples turns
// each into W gathered adds.
//
// Replaces XLA code of the reference (za_tpu/engine/msm.py
// fixed_base_table, generator_doubles and fixed_base_msm, behind
// za_tpu/engine/engine.py fixed_base_g1/g2), not a Pallas kernel.
//
// fixed_base_table: T[w, d] = d 2^(c w) G for w < W = ceil(254 / c) and
// d < 2^c, entry w 2^c + d.  Two kernels, each behind a C entry point of
// its own (engine/fixed_base.py calls the ladder, then the levels launch
// by launch, each launch counted), both on warp_add.cuh's staged
// complete add (two product latencies an add in G1, three in G2, the
// Horner kernels' own), operands in a warp's slots of shared memory:
// * the ladder (fixed_base_ladder_kernel): one warp walks D_i = 2^i G,
//   D_0 .. D_(n-1) with n = min(c W, 255) as in the reference (a bit past
//   D_254 adds nothing), each doubling the add of a point to itself, into
//   D (8[,2], n);
// * the windows by levels (fixed_base_levels_kernel): level k makes the
//   entries d of top bit k, T[w, d] = T[w, d - 2^k] + D_(c w + k), a warp
//   an entry; T[w, 2^k] is D_(c w + k), copied, and where c w + k is past
//   the ladder the entry copies T[w, d - 2^k] (the identity for d = 2^k).
//   The launch from level 0 also writes T[w, 0], the identity.  Levels
//   0 .. 4 (at most 16 entries a window) run in one launch, a block of 16
//   warps a window, __syncthreads between levels; each level above is a
//   launch of its own over every window, 2^k / 16 blocks each.
// The adds are the plain version's, in its order: low bits first, the
// first term copied, so the coordinates are equal.  The time is the
// ladder's 254 dependent staged adds, then c - 1 levels (PERF.md section
// 6; tools/torch_fixed_base_sweep.py times the two apart).
//
// fixed_base_msm: one thread a scalar.  Each window's unsigned c-bit
// digit comes from the scalar's plain 16-bit limbs, (16, n) int32 as
// GpuEngine uploads scalars; a nonzero digit gathers T[w, d] (the table,
// 32 x 256 points at c = 8: 0.8 MB in G1, 1.5 MB in G2, stays in L2) and
// adds it with the complete add, the first one copied.  A zero digit adds
// nothing.  Output: projective (8[,2], n), which to_affine (ec.cu)
// normalizes.
//
// engine/fixed_base.py holds the plain versions, which take the same
// adds in the same order: with canonical values the coordinates are
// equal bit for bit.
//
// Bound: integer multiplies: one complete add (12 Fq products in G1, 42
// in G2 with Karatsuba) per nonzero digit; bytes are the scalars (64 B)
// and the output point (96 or 192 B) each.  The MSM keeps a thread's
// point in registers; the table's gathers hit L2.  G1 adds inline on mul
// (Ops), G2 on Karatsuba over mul_eo (OpsEo), as ec_add (ec.cu).

#include "curve.cuh"
#include "warp_add.cuh"

namespace za {

constexpr int FB_TB = 128;       // threads of an MSM block
constexpr int FB_LADDER = 255;   // D_0 .. D_254: the reference's SCALAR_BITS + 1
// warps of a window-levels block; levels 0 .. FB_BLOCK_LEVELS - 1 of a
// window (at most FB_WARPS entries a level) run in one block
constexpr int FB_WARPS = 16;
constexpr int FB_BLOCK_LEVELS = 5;
static_assert(FB_WARPS == 1 << (FB_BLOCK_LEVELS - 1),
              "a level of a block: an entry a warp");

template <class F>
__device__ __forceinline__ void set_identity(F& x, F& y, F& z) {
  x = zero<F>();
  y = one<F>();
  z = zero<F>();
}

// One warp: base (8[,2], 1) -> D (8[,2], n), D_i = 2^i base.
template <class F>
__global__ void __launch_bounds__(32)
fixed_base_ladder_kernel(const uint32_t* __restrict__ BX,
                         const uint32_t* __restrict__ BY,
                         const uint32_t* __restrict__ BZ,
                         uint32_t* __restrict__ DX, uint32_t* __restrict__ DY,
                         uint32_t* __restrict__ DZ, int n) {
  using S = Staged<F>;
  __shared__ Fq s[S::SLOTS];
  const int lane = threadIdx.x;
  S::init(s, lane);
  for (int r = lane; r < 8 * S::NS; r += 32) {
    int c, pl, slot, limb;
    point_word<F>(r, c, pl, slot, limb);
    s[S::P + slot].v[limb] = (c == 0 ? BX : c == 1 ? BY : BZ)[pl];
  }
  __syncwarp();
#pragma unroll 1
  for (int i = 0;; ++i) {
    for (int r = lane; r < 8 * S::NS; r += 32) {
      int c, pl, slot, limb;
      point_word<F>(r, c, pl, slot, limb);
      (c == 0 ? DX : c == 1 ? DY : DZ)[pl * (size_t)n + i] =
          s[S::P + slot].v[limb];
    }
    if (i + 1 == n) break;
    // D_(i+1) = D_i + D_i; its first write to P follows a __syncwarp,
    // so every lane has stored D_i by then
    S::add(s, s + S::P, s + S::P, lane);
  }
}

// Levels k0 .. k1 - 1 of every window from D (n = min(c W, FB_LADDER)
// points), a warp an entry: warp v of the window's gridDim.x / W blocks
// takes the entries 2^k + i, i = v, v + FB_WARPS gridDim.x / W, ...
// With k0 = 0 the launch also writes T[w, 0].  A lane moves the words
// lane and lane + 32 of a point, the same words each time, so a point's
// store and the next entry's loads need no sync between them.
template <class F>
__global__ void __launch_bounds__(32 * FB_WARPS)
fixed_base_levels_kernel(const uint32_t* __restrict__ DX,
                         const uint32_t* __restrict__ DY,
                         const uint32_t* __restrict__ DZ,
                         uint32_t* __restrict__ TX, uint32_t* __restrict__ TY,
                         uint32_t* __restrict__ TZ, int c, int W, int k0,
                         int k1) {
  using S = Staged<F>;
  __shared__ Fq scratch[FB_WARPS][S::SLOTS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Fq* s = scratch[warp];
  const int n = min(c * W, FB_LADDER);
  const size_t entries = (size_t)W << c;
  const unsigned per = gridDim.x / W;  // blocks a window
  const int w = blockIdx.x / per;
  const unsigned v = (blockIdx.x % per) * FB_WARPS + warp;
  const unsigned nv = per * FB_WARPS;
  const size_t e0 = (size_t)w << c;
  S::init(s, lane);
  if (k0 == 0 && v == 0)
    for (int r = lane; r < 8 * S::NS; r += 32) {
      int co, pl, slot, limb;  // (0 : 1 : 0): 1 at Y's limbs, Y.c0 in G2
      point_word<F>(r, co, pl, slot, limb);
      (co == 0 ? TX : co == 1 ? TY : TZ)[pl * entries + e0] =
          slot == S::NS / 3 ? QParams::one(limb) : 0u;
    }
  __syncwarp();
#pragma unroll 1
  for (int k = k0; k < k1; ++k) {
    const unsigned h = 1u << k;
    const int j = c * w + k;    // T[w, 2^k] = D_j
    const bool past = j >= n;   // 2^k adds nothing
#pragma unroll 1
    for (unsigned i = v; i < h; i += nv) {
      const size_t e = e0 + h + i;
      const bool sum = i > 0 && !past;  // else D_j, T[w, i] or (0 : 1 : 0)
      for (int r = lane; r < 8 * S::NS; r += 32) {
        int co, pl, slot, limb;
        point_word<F>(r, co, pl, slot, limb);
        uint32_t* t = (co == 0 ? TX : co == 1 ? TY : TZ) + pl * entries;
        const uint32_t d = past ? 0u
                                : (co == 0 ? DX : co == 1 ? DY : DZ)
                                      [pl * (size_t)n + j];
        if (sum) {
          s[S::P + slot].v[limb] = t[e0 + i];
          s[S::Q + slot].v[limb] = d;
        } else {
          t[e] = !past ? d
                 : i   ? t[e0 + i]
                       : (slot == S::NS / 3 ? QParams::one(limb) : 0u);
        }
      }
      if (!sum) continue;
      __syncwarp();
      S::add(s, s + S::P, s + S::Q, lane);  // T[w, i] + D_j
      for (int r = lane; r < 8 * S::NS; r += 32) {
        int co, pl, slot, limb;
        point_word<F>(r, co, pl, slot, limb);
        (co == 0 ? TX : co == 1 ? TY : TZ)[pl * entries + e] =
            s[S::P + slot].v[limb];
      }
    }
    if (k + 1 < k1) __syncthreads();
  }
}

// T: the table; S: (16, n) int32 plain 16-bit limbs of scalars below
// 2^254; out: (8[,2], n)
template <class F, class O>
__global__ void fixed_base_msm_kernel(const uint32_t* __restrict__ TX,
                                      const uint32_t* __restrict__ TY,
                                      const uint32_t* __restrict__ TZ,
                                      const int32_t* __restrict__ S,
                                      uint32_t* __restrict__ OX,
                                      uint32_t* __restrict__ OY,
                                      uint32_t* __restrict__ OZ, int n, int c,
                                      int W) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)n) return;
  const size_t entries = (size_t)W << c;
  const uint32_t mask = (1u << c) - 1;
  F ax, ay, az;
  set_identity(ax, ay, az);
  bool empty = true;
  for (int w = 0; w < W; ++w) {
    // bits [c w, c w + c): c <= 16 and a limb offset below 16 span at
    // most two limbs
    const int bit = c * w, j = bit >> 4, sh = bit & 15;
    uint32_t v = ((uint32_t)S[(size_t)j * n + i] & 0xffffu) >> sh;
    if (sh + c > 16 && j + 1 < 16)
      v |= ((uint32_t)S[(size_t)(j + 1) * n + i] & 0xffffu) << (16 - sh);
    const uint32_t d = v & mask;
    if (d == 0) continue;
    const size_t e = ((size_t)w << c) + d;
    F px, py, pz;
    load(px, TX, entries, e);
    load(py, TY, entries, e);
    load(pz, TZ, entries, e);
    if (empty) {
      ax = px;
      ay = py;
      az = pz;
      empty = false;
    } else {
      point_add<F, O>(ax, ay, az, px, py, pz, ax, ay, az);
    }
  }
  store(OX, (size_t)n, i, ax);
  store(OY, (size_t)n, i, ay);
  store(OZ, (size_t)n, i, az);
}

template <class F>
int launch_ladder(const void* bx, const void* by, const void* bz, void* dx,
                  void* dy, void* dz, int n, void* stream) {
  if (n < 1 || n > FB_LADDER) return (int)cudaErrorInvalidValue;
  fixed_base_ladder_kernel<F><<<1, 32, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)bx, (const uint32_t*)by, (const uint32_t*)bz,
      (uint32_t*)dx, (uint32_t*)dy, (uint32_t*)dz, n);
  return (int)cudaGetLastError();
}

// Levels k0 .. k1 - 1 in one launch: in a block a window where k1 <=
// FB_BLOCK_LEVELS (__syncthreads orders them), else one level k over
// 2^k / FB_WARPS blocks a window.
template <class F>
int launch_levels(const void* dx, const void* dy, const void* dz, void* tx,
                  void* ty, void* tz, int c, int W, int k0, int k1,
                  void* stream) {
  if (c < 1 || c > 16 || W <= 0 || k0 < 0 || k1 <= k0 || k1 > c ||
      (k1 > FB_BLOCK_LEVELS && k1 - k0 > 1))
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)W << max(0, k1 - FB_BLOCK_LEVELS);
  fixed_base_levels_kernel<F>
      <<<blocks, 32 * FB_WARPS, 0, (cudaStream_t)stream>>>(
          (const uint32_t*)dx, (const uint32_t*)dy, (const uint32_t*)dz,
          (uint32_t*)tx, (uint32_t*)ty, (uint32_t*)tz, c, W, k0, k1);
  return (int)cudaGetLastError();
}

template <class F, class O>
int launch_msm(const void* tx, const void* ty, const void* tz, const void* s,
               void* ox, void* oy, void* oz, int n, int c, int W,
               void* stream) {
  if (c < 1 || c > 16 || W <= 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const unsigned blocks = (unsigned)((n + FB_TB - 1) / FB_TB);
    fixed_base_msm_kernel<F, O><<<blocks, FB_TB, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)tx, (const uint32_t*)ty, (const uint32_t*)tz,
        (const int32_t*)s, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, n, c,
        W);
  }
  return (int)cudaGetLastError();
}

}  // namespace za

extern "C" {

// bx, by, bz: G, (8, 1) int32 projective Montgomery -> dx, dy, dz:
// D_0 .. D_(n-1), (8, n)
int fixed_base_ladder_g1(const void* bx, const void* by, const void* bz,
                         void* dx, void* dy, void* dz, int n, void* stream) {
  return za::launch_ladder<za::Fq>(bx, by, bz, dx, dy, dz, n, stream);
}

// (8, 2, 1) -> (8, 2, n): limb plane 2j + k holds limb j of component k
int fixed_base_ladder_g2(const void* bx, const void* by, const void* bz,
                         void* dx, void* dy, void* dz, int n, void* stream) {
  return za::launch_ladder<za::Fq2>(bx, by, bz, dx, dy, dz, n, stream);
}

// D (8, min(c W, 255)) -> levels k0 .. k1 - 1 of the table tx, ty, tz
// (8, W << c), the levels below k0 in place
int fixed_base_levels_g1(const void* dx, const void* dy, const void* dz,
                         void* tx, void* ty, void* tz, int c, int W, int k0,
                         int k1, void* stream) {
  return za::launch_levels<za::Fq>(dx, dy, dz, tx, ty, tz, c, W, k0, k1,
                                   stream);
}

// (8, 2, n) -> (8, 2, W << c)
int fixed_base_levels_g2(const void* dx, const void* dy, const void* dz,
                         void* tx, void* ty, void* tz, int c, int W, int k0,
                         int k1, void* stream) {
  return za::launch_levels<za::Fq2>(dx, dy, dz, tx, ty, tz, c, W, k0, k1,
                                    stream);
}

// table (8, W << c), scalars s (16, n) int32 -> ox, oy, oz (8, n)
int fixed_base_msm_g1(const void* tx, const void* ty, const void* tz,
                      const void* s, void* ox, void* oy, void* oz, int n,
                      int c, int W, void* stream) {
  return za::launch_msm<za::Fq, za::Ops>(tx, ty, tz, s, ox, oy, oz, n, c, W,
                                         stream);
}

// table (8, 2, W << c), scalars (16, n) -> (8, 2, n)
int fixed_base_msm_g2(const void* tx, const void* ty, const void* tz,
                      const void* s, void* ox, void* oy, void* oz, int n,
                      int c, int W, void* stream) {
  return za::launch_msm<za::Fq2, za::OpsEo>(tx, ty, tz, s, ox, oy, oz, n, c,
                                            W, stream);
}

}  // extern "C"
