// Batch-affine tree levels of the MSM, for G1 (Fq) and G2 (Fq2).
//
// Replaces the four Pallas kernels of za_tpu/engine/pallas_tree.py:
//   tree_level0_fused     -> tree_level0_g1
//   tree_level            -> tree_level_g1
//   tree_level0_fused_g2  -> tree_level0_g2
//   tree_level_g2         -> tree_level_g2
// Each reference level is three pallas_calls (A: per-tile chain
// products of the denominators, N: one Fermat over all tile totals,
// B: unwind and affine add); here one launch does a level.
//
// What a launch computes, on canonical Montgomery values.  A level
// holds rows (query m, window w) of n affine points with infinity
// flags; point i pairs with point i + n/2 (fold-half) and the row halves:
//   den = x2 - x1 (1 where either side is infinity)
//   lam = (y2 - y1) / den, x3 = lam^2 - x1 - x2, y3 = lam (x1 - x3) - y1
//   inf + Q = Q, P + inf = P, inf + inf = inf (then x3, y3 = x2, y2).
// Two finite operands with equal x (a pair the reference's contract
// excludes, and which sums of repeated query points reach: one pk point
// in several columns, or a small witness's digits) take the rare branch:
// P + P doubles, den = 2 y1 and lam = 3 x1^2 / den; P + (-P) is
// infinity (den = 1, x3, y3 = x2, y2).  Such a pair zeroes its thread's
// product of denominators, and only a thread whose product is zero walks
// its pairs again with them handled (out of line), so the common path's
// code is as it was without them.
// Level 0 reads the staged affine {1P..8P} tables directly: |d| picks
// entry |d| - 1, d < 0 negates y, d = 0 is infinity (and reads entry 0);
// the selected points never reach device memory.
//
// Design.  A block owns a contiguous slice of TB * K pairs of one row;
// thread t walks pairs t, t + TB, ... (coalesced across the warp),
// keeping the exclusive prefix products of its denominators in shared
// memory.  The block multiplies the thread totals in a shared-memory
// product tree, one thread inverts the root by inv_gcd (G2 through the
// norm, so the tree runs on Fq), the tree is unwound
// (inv(left) = inv(parent) * right), and each thread walks its pairs
// backwards, emitting per-pair inverses and the affine adds.  Both
// walks are loops (not unrolled), and the registers are capped for a
// given number of blocks per SM.  Nothing crosses blocks, so no second
// pass.
//
// Bound: integer multiplies.  Per pair about 6 field multiplications
// (1 forward, 2 unwinding, 3 in the add) = ~1.5k 32-bit multiply-adds
// for G1, x3 for G2 (Karatsuba); bytes per pair are two points in and
// one out.  The design spends ~2 extra multiplications per thread on
// the shared tree and one inversion per block of TB * K pairs.
//
// What bounded the first version was not that work but each block's
// serial chain: the product tree, a one-thread Fermat root (364
// dependent products, ~0.20 ms) and walks unrolled into more code than
// an SM's instruction cache holds, a floor of 0.23-0.32 ms under every
// wave of blocks whatever it held (NVIDIA H100 80GB HBM3, 700 W).  With
// inv_gcd and rolled walks (same card, one 2^17 chunk): tree_level_g1
// 1.40 -> 0.43 ms at n = 2^14, 0.05-0.11 ms for n = 2^12 ... 2^8;
// tree_level_g2 1.80 -> 0.41 ms at n = 2^14, 0.44 -> 0.16 ms at 2^12
// and 0.07-0.10 ms below; tree_level0_g2 3.81 -> 0.83 ms;
// tree_level0_g1 2.32 -> 0.97-0.98 ms.  A G2 block alone on
// an SM takes ~0.055 ms plus ~0.011 ms for each pair a thread holds
// (four at K = 4): the chain of dependent Fq2 products.

#include "field.cuh"

namespace za {

constexpr int TB = 128;  // threads per block (a power of two)
// Pairs per thread and blocks per SM of the rolled kernels; the blocks
// cap the registers at 65536 / (TB * blocks).  G1 fits five in 96
// registers; G2 four in 128 with 150-300 bytes of spills, which measured
// faster than 170-182 registers without (two blocks per SM), 168 (three)
// and 96 (five), and than K = 2.  G1 level 0 (digits, the gather from
// eight entries) takes 110 registers at four blocks, which measured
// faster than 96 at five, 80 with spills at six (shared memory holds
// five) and than K = 4.
constexpr int G1_K = 8, G1_BLOCKS = 5;  // tree_level_g1; K of level 0
constexpr int G1_L0_BLOCKS = 4;         // tree_level0_g1
constexpr int G2_K = 4, G2_BLOCKS = 4;  // tree_level0_g2, tree_level_g2

// Operands of pair p of row r.  Level 0: tables (8 entries, E planes,
// M, n) and digits (W, M, n); otherwise points (E planes, M * W, n)
// and flags (M * W, n).
template <class F, bool L0>
struct Level {
  const uint32_t* xa;
  const uint32_t* ya;
  const uint8_t* inf;
  const int8_t* d;
  int M, W, n;

  __device__ __forceinline__ void operands(int r, long p, bool need_y,
                                           F& x1, F& x2, F& y1, F& y2,
                                           bool& i1, bool& i2) const {
    const long half = n / 2;
    if (L0) {
      const int m = r / W, w = r - (r / W) * W;
      const size_t plane = (size_t)M * n;
      const size_t entry = (size_t)Planes<F>::n * plane;
      const size_t col = (size_t)m * n + p;
      const int8_t d1 = d[((size_t)w * M + m) * n + p];
      const int8_t d2 = d[((size_t)w * M + m) * n + p + half];
      const int a1 = d1 < 0 ? -d1 : d1, a2 = d2 < 0 ? -d2 : d2;
      i1 = a1 == 0;
      i2 = a2 == 0;
      const size_t k1 = (size_t)(a1 > 0 ? a1 - 1 : 0);
      const size_t k2 = (size_t)(a2 > 0 ? a2 - 1 : 0);
      load(x1, xa + k1 * entry, plane, col);
      load(x2, xa + k2 * entry, plane, col + half);
      if (need_y) {
        load(y1, ya + k1 * entry, plane, col);
        load(y2, ya + k2 * entry, plane, col + half);
        if (d1 < 0) y1 = neg(y1);
        if (d2 < 0) y2 = neg(y2);
      }
    } else {
      const size_t plane = (size_t)M * W * n;
      const size_t c1 = (size_t)r * n + p;
      load(x1, xa, plane, c1);
      load(x2, xa, plane, c1 + half);
      i1 = inf[c1] != 0;
      i2 = inf[c1 + half] != 0;
      if (need_y) {
        load(y1, ya, plane, c1);
        load(y2, ya, plane, c1 + half);
      }
    }
  }
};

// The denominator of a finite pair whose x are equal: 2 y1 for P + P,
// 1 for P + (-P) (y2 = -y1), which then adds no factor to the products.
template <class F>
__device__ __forceinline__ F equal_x_den(const F& y1, const F& y2) {
  return is_zero(sub(y2, y1)) ? add(y1, y1) : one<F>();
}

template <class F>
using Prefixes = uint32_t (*)[Planes<F>::n][TB];

// A thread's first walk over its K pairs: the exclusive prefix products
// of their denominators into pre, -> the thread's product.  EQX: pairs
// with equal x take their denominators from equal_x_den (y reloaded);
// without it such a pair makes the product zero.
template <class F, bool L0, int K, bool EQX>
__device__ __forceinline__ F first_walk(const Level<F, L0>& lv, int r,
                                        long p0, Prefixes<F> pre) {
  const int t = threadIdx.x;
  const long half = lv.n / 2;
  F acc = one<F>();
#pragma unroll 1  // unrolled, the two walks outgrow the instruction cache
  for (int j = 0; j < K; ++j) {
    const long p = p0 + (long)j * TB + t;
    store(&pre[j][0][0], TB, t, acc);
    if (p < half) {
      F x1, x2, y1, y2;
      bool i1, i2;
      lv.operands(r, p, false, x1, x2, y1, y2, i1, i2);
      if (!(i1 || i2)) {
        F den = sub(x2, x1);
        if (EQX && is_zero(den)) {
          lv.operands(r, p, true, x1, x2, y1, y2, i1, i2);
          den = equal_x_den(y1, y2);
        }
        acc = mul(acc, den);
      }
    }
  }
  return acc;
}

// The second walk, backwards: each pair's inverse from the running
// inverse and its prefix, the affine add, the outputs.  EQX: P + P
// doubles (lam = 3 x1^2 / (2 y1)) and P + (-P) is infinity.
template <class F, bool L0, int K, bool EQX>
__device__ __forceinline__ void second_walk(
    const Level<F, L0>& lv, int r, long p0, Prefixes<F> pre, F inv_acc,
    uint32_t* __restrict__ x3, uint32_t* __restrict__ y3,
    uint8_t* __restrict__ inf3) {
  const int t = threadIdx.x;
  const long half = lv.n / 2;
  const size_t out_plane = (size_t)lv.M * lv.W * half;
#pragma unroll 1
  for (int j = K - 1; j >= 0; --j) {
    const long p = p0 + (long)j * TB + t;
    if (p >= half) continue;
    F x1, x2, y1, y2;
    bool i1, i2;
    lv.operands(r, p, true, x1, x2, y1, y2, i1, i2);
    F xo, yo;
    bool cancel = false;  // P + (-P)
    if (i1) {
      xo = x2;
      yo = y2;
    } else if (i2) {
      xo = x1;
      yo = y1;
    } else {
      F pj;
      load(pj, &pre[j][0][0], TB, t);
      F den = sub(x2, x1);
      F num = sub(y2, y1);
      if (EQX && is_zero(den)) {
        den = equal_x_den(y1, y2);
        cancel = !is_zero(num);
        const F xx = sqr(x1);
        num = add(add(xx, xx), xx);
      }
      const F dinv = mul(inv_acc, pj);
      inv_acc = mul(inv_acc, den);
      if (EQX && cancel) {
        xo = x2;
        yo = y2;
      } else {
        const F lam = mul(num, dinv);
        xo = sub(sub(sqr(lam), x1), x2);
        yo = sub(mul(lam, sub(x1, xo)), y1);
      }
    }
    const size_t o = (size_t)r * half + p;
    store(x3, out_plane, o, xo);
    store(y3, out_plane, o, yo);
    inf3[o] = (uint8_t)((i1 && i2) || cancel);
  }
}

// The walks of a thread that holds a pair with equal x, out of line: the
// common path's code and registers stay as they were without them.
template <class F, bool L0, int K>
__device__ __noinline__ F first_walk_equal_x(const Level<F, L0> lv, int r,
                                             long p0, Prefixes<F> pre) {
  return first_walk<F, L0, K, true>(lv, r, p0, pre);
}

template <class F, bool L0, int K>
__device__ __noinline__ void second_walk_equal_x(
    const Level<F, L0> lv, int r, long p0, Prefixes<F> pre, F inv_acc,
    uint32_t* __restrict__ x3, uint32_t* __restrict__ y3,
    uint8_t* __restrict__ inf3) {
  second_walk<F, L0, K, true>(lv, r, p0, pre, inv_acc, x3, y3, inf3);
}

// One level (Design above): the root inverted by inv_gcd (for Fq2
// through the norm: block_inverse_gcd) and both walks rolled into loops
// over prefix products kept in shared memory, so that a block's serial
// chain is short and its code small.  Shared memory: K * Planes<F>::n * TB words
// of prefixes and 2 TB Fq of tree, 40 KB for G1 (K = 8) and G2 (K = 4).
// A thread whose product comes out zero holds a finite pair with equal
// x (the product of nonzero factors is not zero): it walks again with
// those pairs handled, before the block's inversion.
template <class F, bool L0, int K, int BLOCKS>
__global__ void __launch_bounds__(TB, BLOCKS)
tree_level_rolled_kernel(Level<F, L0> lv, uint32_t* __restrict__ x3,
                         uint32_t* __restrict__ y3,
                         uint8_t* __restrict__ inf3) {
  __shared__ Fq tree[2 * TB];
  __shared__ uint32_t pre[K][Planes<F>::n][TB];  // exclusive prefixes
  const int r = blockIdx.y;
  const long p0 = (long)blockIdx.x * TB * K;

  F acc = first_walk<F, L0, K, false>(lv, r, p0, pre);
  const bool equal_x = is_zero(acc);
  if (equal_x) acc = first_walk_equal_x<F, L0, K>(lv, r, p0, pre);
  const F inv_acc = block_inverse_gcd<TB>(acc, tree);
  if (equal_x)
    second_walk_equal_x<F, L0, K>(lv, r, p0, pre, inv_acc, x3, y3, inf3);
  else
    second_walk<F, L0, K, false>(lv, r, p0, pre, inv_acc, x3, y3, inf3);
}

template <class F, bool L0>
using LevelKernel = void (*)(Level<F, L0>, uint32_t*, uint32_t*, uint8_t*);

// One launch of kern over M * W rows of n points (blocks of TB * K pairs)
template <class F, bool L0, int K>
int launch(LevelKernel<F, L0> kern, const void* xa, const void* ya,
           const void* inf, const void* d, void* x3, void* y3, void* inf3,
           int M, int W, int n, void* stream) {
  const long half = n / 2;
  if (half > 0 && M > 0 && W > 0) {
    Level<F, L0> lv{(const uint32_t*)xa, (const uint32_t*)ya,
                    (const uint8_t*)inf, (const int8_t*)d, M, W, n};
    dim3 grid((unsigned)((half + (long)TB * K - 1) / ((long)TB * K)),
              (unsigned)(M * W));
    kern<<<grid, TB, 0, (cudaStream_t)stream>>>(
        lv, (uint32_t*)x3, (uint32_t*)y3, (uint8_t*)inf3);
  }
  return (int)cudaGetLastError();
}

}  // namespace za

extern "C" {

using za::Fq;
using za::Fq2;

// tabx, taby: (8, 8, M, S) int32 (entry, limb plane, query, column);
// d: (64, M, S) int8 -> x3, y3: (8, M, 64, S/2), inf3: (M, 64, S/2) u8
int tree_level0_g1(const void* tabx, const void* taby, const void* d,
                   void* x3, void* y3, void* inf3, int M, int W, int S,
                   void* stream) {
  constexpr int K = za::G1_K, B = za::G1_L0_BLOCKS;
  return za::launch<Fq, true, K>(
      za::tree_level_rolled_kernel<Fq, true, K, B>, tabx, taby, nullptr, d,
      x3, y3, inf3, M, W, S, stream);
}

// x, y: (8, M, W, n) int32; inf: (M, W, n) u8 -> halved
int tree_level_g1(const void* x, const void* y, const void* inf, void* x3,
                  void* y3, void* inf3, int M, int W, int n, void* stream) {
  constexpr int K = za::G1_K, B = za::G1_BLOCKS;
  return za::launch<Fq, false, K>(
      za::tree_level_rolled_kernel<Fq, false, K, B>, x, y, inf, nullptr, x3,
      y3, inf3, M, W, n, stream);
}

// tabx, taby: (8, 16, M, S): limb plane 2j + c holds limb j of component c
int tree_level0_g2(const void* tabx, const void* taby, const void* d,
                   void* x3, void* y3, void* inf3, int M, int W, int S,
                   void* stream) {
  constexpr int K = za::G2_K, B = za::G2_BLOCKS;
  return za::launch<Fq2, true, K>(
      za::tree_level_rolled_kernel<Fq2, true, K, B>, tabx, taby, nullptr, d,
      x3, y3, inf3, M, W, S, stream);
}

int tree_level_g2(const void* x, const void* y, const void* inf, void* x3,
                  void* y3, void* inf3, int M, int W, int n, void* stream) {
  constexpr int K = za::G2_K, B = za::G2_BLOCKS;
  return za::launch<Fq2, false, K>(
      za::tree_level_rolled_kernel<Fq2, false, K, B>, x, y, inf, nullptr, x3,
      y3, inf3, M, W, n, stream);
}

}  // extern "C"
