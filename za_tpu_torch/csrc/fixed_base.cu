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
// d < 2^c, one thread an entry.  A thread walks the doubling ladder
// D_i = 2^i G itself, in registers (every thread of a window computes
// the same doublings, so no thread waits for another and one launch
// does it all), and adds D_(c w + j) for each set bit j of d, low bits
// first; the first such D is copied, not added to the identity.  As in
// the reference the ladder has D_0 .. D_254; a bit past it adds nothing.
// Its time is one thread's chain: up to 254 doublings and c adds.
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
// and the output point (96 or 192 B) each.  The design keeps a thread's
// point in registers; the table's gathers hit L2.  G1 adds inline on mul
// (Ops), G2 on Karatsuba over mul_eo (OpsEo), as ec_add (ec.cu).

#include "curve.cuh"

namespace za {

constexpr int FB_TB = 128;       // threads of a block
constexpr int FB_LADDER = 255;   // D_0 .. D_254: the reference's SCALAR_BITS + 1

template <class F>
__device__ __forceinline__ void set_identity(F& x, F& y, F& z) {
  x = zero<F>();
  y = one<F>();
  z = zero<F>();
}

// base: (8[,2], 1); T: (8[,2], W << c), entry (w << c) + d
template <class F, class O>
__global__ void fixed_base_table_kernel(const uint32_t* __restrict__ BX,
                                        const uint32_t* __restrict__ BY,
                                        const uint32_t* __restrict__ BZ,
                                        uint32_t* __restrict__ TX,
                                        uint32_t* __restrict__ TY,
                                        uint32_t* __restrict__ TZ, int c,
                                        int W) {
  const size_t entries = (size_t)W << c;
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= entries) return;
  const int w = (int)(t >> c);
  const unsigned d = (unsigned)(t & ((1u << c) - 1));
  F ax, ay, az;
  set_identity(ax, ay, az);
  if (d != 0) {
    F cx, cy, cz;
    load(cx, BX, 1, 0);
    load(cy, BY, 1, 0);
    load(cz, BZ, 1, 0);
    // the last ladder index this entry adds
    const int top = min(c * w + 31 - __clz(d), FB_LADDER - 1);
    bool empty = true;
    for (int i = 0; i <= top; ++i) {
      const int j = i - c * w;
      if (j >= 0 && ((d >> j) & 1u)) {
        if (empty) {
          ax = cx;
          ay = cy;
          az = cz;
          empty = false;
        } else {
          point_add<F, O>(ax, ay, az, cx, cy, cz, ax, ay, az);
        }
      }
      if (i < top) point_add<F, O>(cx, cy, cz, cx, cy, cz, cx, cy, cz);
    }
  }
  store(TX, entries, t, ax);
  store(TY, entries, t, ay);
  store(TZ, entries, t, az);
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

template <class F, class O>
int launch_table(const void* bx, const void* by, const void* bz, void* tx,
                 void* ty, void* tz, int c, int W, void* stream) {
  if (c < 1 || c > 16 || W <= 0) return (int)cudaErrorInvalidValue;
  const size_t entries = (size_t)W << c;
  const unsigned blocks = (unsigned)((entries + FB_TB - 1) / FB_TB);
  fixed_base_table_kernel<F, O><<<blocks, FB_TB, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)bx, (const uint32_t*)by, (const uint32_t*)bz,
      (uint32_t*)tx, (uint32_t*)ty, (uint32_t*)tz, c, W);
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

// bx, by, bz: G, (8, 1) int32 projective Montgomery -> tx, ty, tz:
// (8, W << c)
int fixed_base_table_g1(const void* bx, const void* by, const void* bz,
                        void* tx, void* ty, void* tz, int c, int W,
                        void* stream) {
  return za::launch_table<za::Fq, za::Ops>(bx, by, bz, tx, ty, tz, c, W,
                                           stream);
}

// (8, 2, 1) -> (8, 2, W << c): limb plane 2j + k holds limb j of
// component k
int fixed_base_table_g2(const void* bx, const void* by, const void* bz,
                        void* tx, void* ty, void* tz, int c, int W,
                        void* stream) {
  return za::launch_table<za::Fq2, za::OpsEo>(bx, by, bz, tx, ty, tz, c, W,
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
