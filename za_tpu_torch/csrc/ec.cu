// Elementwise curve kernels for G1 (over Fq) and G2 (over Fq2).
//
// ec_add: complete projective addition (Renes-Costello-Batina 2015,
// algorithm 7, a = 0), one point pair per thread.  It serves the
// {1P..8P} table build at staging: G1 inlined on mul, G2 with its 42 Fq
// products as Karatsuba over mul_eo (on mul the inlined G2 add held 255
// registers and spilled).
// ec_fold: the lane fold of both MSM routes, one launch per MSM, and
// ec_carry: the tree MSM's chunk carry, one launch per MSM over every
// chunk's partials; both fold-half levels in shared memory, on
// curve.cuh's add a thread or the Horner kernels' staged add
// (warp_add.cuh).
// horner: the window combine sum_w 2^(bits w) S_w of M MSMs in one
// launch (320 dependent adds each at radix 16, 381 at radix 4): as that
// many ec_add launches on a few points it cost more in launches than in
// arithmetic.  The group law is curve.cuh's.  Run by one thread per
// MSM, its time was that thread's chain of dependent Fq products: 42 an
// add in G2 (15.25 ms at radix 16, 18.13 ms at radix 4), 14 in G1 (3.2
// and 4.5 ms, ~10 us an add).  Both now run one warp per MSM that
// spreads each add's products over the lanes (horner_warp_g1_kernel,
// horner_warp_g2_kernel): two product latencies an add in G1 (0.73-0.76
// and 0.89 ms, ~2.3 us an add), three in G2 (1.29-1.33 and 1.55-1.59
// ms); NVIDIA H100 80GB HBM3, 700 W.
// In the reference all of these are XLA code (za_tpu/engine/ec.py
// point_add, msm.build_multiples, msm.lane_fold, msm.horner_windows,
// the carry scan of msm_tree.tree_window_sums), not Pallas kernels.
// to_affine: projective -> affine (Z = 0 maps to 0), the reference's
// msm_tree._normalize_affine, for both groups one wave of blocks
// (to_affine_wave_kernel): a block batch-inverts the keys of its J
// AFF_TB points (Z in G1, the norm of Z in Fq in G2) with inv_gcd at the
// root of its tree, all blocks at once, and the per-point products run
// on mul_eo: 5 a point in G1, 13 in G2.  Before, each block inverted
// with Fermat (~380 dependent products, ~0.2 ms) wave after wave of
// blocks: 0.95 ms for 1.57M G1 points against a 0.12 ms bound.
//
// Bound: integer multiplies.  An add is 12 field multiplications plus
// two by 3b (G1: ~3.6k 32-bit multiply-adds; G2 x3 with Karatsuba), a
// normalisation 5 (G1) or 13 (G2), and one inversion a block;
// bytes are 6 (resp. 3) elements in and 3 (resp. 2) out.  The
// design keeps every operand in registers and launches one thread per
// add (J points a thread for to_affine); the work is independent, so
// the card fills once there are more than ~100k points.

#include <cooperative_groups.h>

#include <type_traits>

#include "curve.cuh"
#include "warp_add.cuh"

namespace za {

constexpr int ADD_TB = 128;  // threads per ec_add block

// One add a thread on the products O, with no launch bounds (bounds
// would change G1's code; G2's comes out the same without them).
// G1: inlined on mul (Ops).  G2: Karatsuba over inlined mul_eo (OpsEo),
// so that ptxas interleaves independent products; 242 registers, no
// spill.  Measured (NVIDIA H100 80GB HBM3, 700 W;
// tools/torch_hpipe_sweep.py --variants ec), ms at 32,768 / 16,384 G2
// pairs: OpsEo .0368-.0374 / .0329-.0330; inlined on mul .0528-.0537 /
// .0497-.0498 (255 registers, 8 B spill); the staged add of 8 lanes a
// pair (Staged<Fq2, 8>, mul_eo) .0756 / .042.  At 2^14 pairs, fewer
// than two warps a scheduler, one thread's chain of 42 products is the
// kernel's time whatever the design.
template <class F, class O>
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
  point_add<F, O>(x1, y1, z1, x2, y2, z2, x3, y3, z3);
  store(X3, n, i, x3);
  store(Y3, n, i, y3);
  store(Z3, n, i, z3);
}

// Horner over the window sums of M MSMs, one warp per MSM: the chain
// walks the W windows MSB first, acc = 2^bits acc + S_w (bits doublings
// through the complete add, then one add; bits = 4 for signed
// radix-16, 2 for radix-4), each add warp_add.cuh's staged hw1 add.
// Input (8, M, W) limb planes, output (8, M); block m is MSM m.
__global__ void __launch_bounds__(32)
horner_warp_g1_kernel(const uint32_t* __restrict__ WX,
                      const uint32_t* __restrict__ WY,
                      const uint32_t* __restrict__ WZ,
                      uint32_t* __restrict__ X, uint32_t* __restrict__ Y,
                      uint32_t* __restrict__ Z, int M, int W, int bits) {
  __shared__ Fq s[hw1::SLOTS];
  const int lane = threadIdx.x, m = blockIdx.x;
  const size_t plane = (size_t)M * W;
  // word k = lane < 24 of the three Fq of a point: coordinate k / 8,
  // limb k & 7
  const int c = lane >> 3, j = lane & 7;
  if (lane < 8) s[hw1::ZERO].v[j] = 0u;
  if (lane < 24)  // (0 : 1 : 0)
    s[hw1::P + c].v[j] = c == 1 ? QParams::one(j) : 0u;
  __syncwarp();
#pragma unroll 1
  for (int w = W - 1; w >= 0; --w) {
    uint32_t sw = 0u;  // S_w, loaded while the doublings run
    if (lane < 24) {
      const uint32_t* src = c == 0 ? WX : c == 1 ? WY : WZ;
      sw = src[j * plane + (size_t)m * W + w];
    }
#pragma unroll 1
    for (int d = 0; d < bits; ++d)
      hw1::point_add(s, s + hw1::P, s + hw1::P, lane);
    if (lane < 24) s[hw1::Q + c].v[j] = sw;
    __syncwarp();
    hw1::point_add(s, s + hw1::P, s + hw1::Q, lane);
  }
  if (lane < 24) {
    uint32_t* dst = c == 0 ? X : c == 1 ? Y : Z;
    dst[(size_t)j * M + m] = s[hw1::P + c].v[j];
  }
}

// Horner over G2 window sums, one warp per MSM.  The chain is G1's
// (bits doublings and one add per window, each RCB algorithm 7) on
// warp_add.cuh's staged hw2 add.
// Input (8, 2, M, W) limb planes, output (8, 2, M); block m is MSM m.
__global__ void __launch_bounds__(32)
horner_warp_g2_kernel(const uint32_t* __restrict__ WX,
                   const uint32_t* __restrict__ WY,
                   const uint32_t* __restrict__ WZ, uint32_t* __restrict__ X,
                   uint32_t* __restrict__ Y, uint32_t* __restrict__ Z, int M,
                   int W, int bits) {
  __shared__ Fq s[hw2::SLOTS];
  const int lane = threadIdx.x, m = blockIdx.x;
  const size_t plane = (size_t)M * W;
  // word k < 48 of the six Fq of a point: coordinate k / 16, component
  // (k / 8) & 1, limb k & 7 (lanes take k = lane and lane + 32)
  if (lane < 16) {
    const Fq2 b = b3<Fq2>();
    s[lane >> 3].v[lane & 7] = 0u;                     // ZERO
    s[hw2::B3 + (lane >> 3)].v[lane & 7] =
        (lane >> 3) ? b.c1.v[lane & 7] : b.c0.v[lane & 7];
  }
  for (int k = lane; k < 48; k += 32)  // (0 : 1 : 0)
    s[hw2::P + (k >> 3)].v[k & 7] = (k >> 3) == 2 ? QParams::one(k & 7) : 0u;
  __syncwarp();
#pragma unroll 1
  for (int w = W - 1; w >= 0; --w) {
    uint32_t sw[2];  // S_w, loaded while the doublings run
    for (int i = 0; i < 2; ++i) {
      const int k = lane + 32 * i;
      if (k < 48) {
        const uint32_t* src = (k >> 4) == 0 ? WX : (k >> 4) == 1 ? WY : WZ;
        sw[i] = src[(2 * (k & 7) + ((k >> 3) & 1)) * plane + m * W + w];
      }
    }
#pragma unroll 1
    for (int d = 0; d < bits; ++d)
      hw2::point_add(s, s + hw2::P, s + hw2::P, lane);
    for (int i = 0; i < 2; ++i) {
      const int k = lane + 32 * i;
      if (k < 48) s[hw2::Q + (k >> 3)].v[k & 7] = sw[i];
    }
    __syncwarp();
    hw2::point_add(s, s + hw2::P, s + hw2::Q, lane);
  }
  for (int k = lane; k < 48; k += 32) {
    uint32_t* dst = (k >> 4) == 0 ? X : (k >> 4) == 1 ? Y : Z;
    dst[(2 * (k & 7) + ((k >> 3) & 1)) * M + m] = s[hw2::P + (k >> 3)].v[k & 7];
  }
}

// -- the lane fold and the chunk carry: staged adds on shared memory ---------
//
// Both sum points by fold-half levels in shared memory (one kernel,
// ec_sum_kernel below), a level's adds one a thread (curve.cuh's add in
// registers, thread_add) or on the Horner kernels' staged add (hw1 /
// hw2 point_add): one add on WIDTH lanes with a scratch of SLOTS Fq of
// its own, UNITS of them a warp: five G1 adds on lanes 0-29 (lanes 30
// and 31 ride along with the fifth and only read), in G2 32 / WIDTH
// adds of WIDTH = 32, 16 or 8 lanes.  A point is NS consecutive Fq
// slots, hw1::P's and hw2::P's layout: X, Y, Z (G1); X.c0, X.c1, Y.c0,
// Y.c1, Z.c0, Z.c1 (G2).  The staged add's latency is two (G1) or three
// (G2, WIDTH 32) products where one thread's add is a chain of 12 or 42
// (~10 and ~48 us, NVIDIA H100 80GB HBM3, 700 W); it costs more
// instructions an add (lanes idle in the combines, the scratch's
// traffic), so in G1 a level with many adds runs one add a thread (the
// carry's levels, the fold's from 128 adds a block) and one with few
// staged; G2 runs every level staged (CARRY_G2_WIDTH, FOLD_G2_WIDTH).
// Measured on that card (tools/torch_fold_sweep.py): a fold 0.028-0.072
// ms (G1) and 0.058-0.075 ms (G2) at the proofs' shapes: ~6 us of
// launch, load and store, ~2.5 us a narrow G1 level and ~4-5 us a G2
// one (the chain), and the widest levels at the card's rate for their
// adds.  Bound: operations at these shapes (0.0015-0.024 ms); what holds
// a fold is its chain of log2 L dependent levels (a floor of
// 0.017-0.028 ms).  The add's adapter (Staged, point_word) is
// warp_add.cuh's.

__device__ __forceinline__ void get(Fq& r, const Fq* s) { r = s[0]; }
__device__ __forceinline__ void get(Fq2& r, const Fq* s) {
  r.c0 = s[0];
  r.c1 = s[1];
}
__device__ __forceinline__ void put(Fq* s, const Fq& a) { s[0] = a; }
__device__ __forceinline__ void put(Fq* s, const Fq2& a) {
  s[0] = a.c0;
  s[1] = a.c1;
}

// lane i += lane i + h on one thread: curve.cuh's add in registers;
// LEAVES: 1 where lane i + h is a flagged affine point (Z 0 or 1), 2
// where lane i is too (point_add's z01)
template <class F, int LEAVES>
__device__ __noinline__ void thread_add(Fq* pts, int i, int h) {
  constexpr int w = Staged<F>::NS / 3;
  Fq* a = pts + Staged<F>::NS * i;
  const Fq* b = pts + Staged<F>::NS * (i + h);
  F x1, y1, z1, x2, y2, z2;
  get(x1, a);
  get(y1, a + w);
  get(z1, a + 2 * w);
  get(x2, b);
  get(y2, b + w);
  get(z2, b + 2 * w);
  point_add(x1, y1, z1, x2, y2, z2, x1, y1, z1, LEAVES);
  put(a, x1);
  put(a + w, y1);
  put(a + 2 * w, z1);
}

constexpr int FOLD_MAX_LANES = 512;    // lanes of one window
constexpr int FOLD_MAX_THREADS = 512;  // threads of a fold or carry block
constexpr int FOLD_MAX_SPLIT = 8;      // blocks of a window (a cluster)
// G2's staged adds (no thread add compiled in, which would hold the
// registers at the cap and spill): the carry's on 8 lanes, four a warp
// (1.3-1.9x the warp's 32 at C = 5, 8 and 64), the fold's on 16, two a
// warp (inside the proof's stages 0.058 ms a G2 fold against 0.060 on
// 32 lanes and 0.075 on 8: a fold's narrow levels wait on one add's
// latency); tools/torch_fold_sweep.py, NVIDIA H100 80GB HBM3, 700 W
constexpr int CARRY_G2_WIDTH = 8;
constexpr int FOLD_G2_WIDTH = 16;

// Fold-half levels of lanes 0 .. n-1 (n a power of two times `stop`),
// of which lanes 0 .. nv-1 hold points (nv > n/2), on the block: level h
// = n/2, n/4, .., stop adds lane i + h into lane i for i < h where lane
// i + h holds a point (i + h < nv; a missing lane is no add, not an add
// of the identity), __syncthreads after each.  A level of more than
// `wide` adds runs one add per thread; a narrower one runs staged adds,
// unit u (of warps * UNITS) taking adds u, u + warps * UNITS, ...
// LEAVES: the lanes start as flagged affine points, so lane j is still
// one at level h where j + 2h >= nv (no earlier level added into it),
// and a thread's add then runs fewer products (point_add's z01): lane i
// + h is a leaf where i + 3h >= nv, lane i too where i + 2h >= nv.
// !THREADS: every level staged (no add in registers compiled in, which
// would hold G2's registers at the cap).
template <class F, int W, bool THREADS, bool LEAVES>
__device__ __forceinline__ void fold_levels(Fq* pts, Fq* s, int n, int stop,
                                            int nv, int wide, int k,
                                            int sub) {
  using S = Staged<F, W>;
  const int tid = threadIdx.x, nt = blockDim.x, warp = tid >> 5;
  const int units = (nt >> 5) * S::UNITS;
#pragma unroll 1
  for (int h = n >> 1; h >= stop; h >>= 1) {
    if (THREADS && h > wide) {
      for (int i = tid; i < h; i += nt) {
        if (i + h >= nv) continue;
        if (LEAVES && i + 2 * h >= nv) thread_add<F, 2>(pts, i, h);
        else if (LEAVES && i + 3 * h >= nv) thread_add<F, 1>(pts, i, h);
        else thread_add<F, 0>(pts, i, h);
      }
    } else {
#pragma unroll 1
      for (int b = warp * S::UNITS; b < h; b += units) {
        const int i = b + k;  // else the unit adds its own P and Q
        const bool on = i < h && i + h < nv;
        S::add(s, on ? pts + i * S::NS : s + S::P,
               on ? pts + (i + h) * S::NS : s + S::Q, sub);
      }
    }
    __syncthreads();
  }
}

// The lane fold and the tree MSM's chunk carry, one kernel: block b
// sums each of B columns over its lanes by fold-half levels in shared
// memory, lane c of column col at c B + col, so that fold_levels on
// those lanes stopped at level B leaves column col's sum in lane col.
// FOLD, the lane fold of msm.lane_fold in one launch: input X, Y, Z
// (*E, N, C), output (*E, N), N windows of C = L lanes, the sum equal
// to the plain fold-half's bit for bit.  A window may be split over a
// cluster of K blocks: fold-half pairs lane i with i + h, and for h >=
// K both lie in one residue class mod K, so block r of the cluster
// takes lanes r, r + K, r + 2K, ... of its B windows (L/K a column) and
// folds them alone, ending with lane r of each; after a cluster barrier
// block 0 reads the other blocks' B sums from their shared memory
// (Hopper's distributed shared memory) and folds the K B lanes.  B and
// K spread the windows over the card's SMs (msm.fold_plan): a G2 MSM's
// 64 windows on 128 SMs at K = 2, the 192 of 2^17 g1abl on 128 at B =
// 3, K = 2, the 256 of 2^13 g1x4 on 128 at B = 2; and several windows
// keep a block's staged units busy in the narrow levels.  Replaces the
// reference's lane fold (za_tpu/engine/msm.py lane_fold, XLA code, no
// Pallas kernel) and the port's log2 L ec_add launches a MSM.
// !FOLD, the chunk carry, one launch a MSM: the C chunks' flagged affine
// partials of each of the N columns (m, w, t) summed into the
// projective (*E, M, W, T) that msm.lane_fold takes.  Input: x, y (C,
// *E, M, W, T) limb planes, inf (C, M, W, T) bytes, the last tree
// level's output of each chunk (cuda_tree.tree_window_sums); a partial
// flagged inf is (0 : 1 : 0) under the complete add.  C is padded to a
// power of two P in the schedule only: level h = P/2, .., 1 adds chunk
// c + h into chunk c for c < h where c + h < C, in lanes fold_levels on
// P B lanes of which C B hold points, so the plain version
// (cuda_tree.chunk_carry_plain) is that fold-half on the chunk axis.
// The first level's operands are affine, and a later level's where no
// level added into them (leaves): a thread's add there runs 9 products
// (both leaves) or 11 (the second), point_add's z01.  Replaces the
// reference's carry scan (za_tpu/engine/msm_tree.py tree_window_sums,
// point_add(carry, chunk) under jax.lax.scan, XLA code, no Pallas
// kernel) and the port's carry launch a chunk.
// Bound: operations, (C - 1) N adds.  Measured (NVIDIA H100 80GB HBM3,
// 700 W, tools/torch_fold_sweep.py): the carry's levels one add a thread
// in G1, the staged add on 8 lanes in G2 (cuda_tree.carry_plan); at
// 2^17 a carry level holds too few adds to fill the card.
template <bool FOLD>  // the third input: Z limb planes, or inf flags
using SumIn = typename std::conditional<FOLD, uint32_t, uint8_t>::type;

template <class F, int W, bool THREADS, bool FOLD>
__global__ void __launch_bounds__(FOLD_MAX_THREADS)
ec_sum_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
              const SumIn<FOLD>* __restrict__ zi, uint32_t* __restrict__ X,
              uint32_t* __restrict__ Y, uint32_t* __restrict__ Z, int C,
              int N, int B, int wide) {
  using S = Staged<F, W>;
  namespace cg = cooperative_groups;
  extern __shared__ Fq smem[];  // max(n, K) B points, then the scratch
  int K = 1, r = 0;
  if constexpr (FOLD) {
    K = (int)cg::this_cluster().num_blocks();
    r = (int)cg::this_cluster().block_rank();
  }
  const int n = C / K;  // lanes of a column in this block
  int P = 1;
  while (P < n) P <<= 1;
  const int nv = n * B, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int k = min(lane / S::WIDTH, S::UNITS - 1);
  const int sub = lane - S::WIDTH * k;
  Fq* pts = smem;
  Fq* s = smem + max(n, K) * B * S::NS + (warp * S::UNITS + k) * S::SLOTS;
  const size_t j0 = (size_t)(blockIdx.x / K) * B;
  constexpr int per = S::NS / 3;  // Fq slots of a coordinate
  for (int e = tid; e < 8 * S::NS * nv; e += nt) {  // coalesced over columns
    const int col = e % B, a = e / B, c = a % n;
    int cc, pl, slot, limb;
    point_word<F>(a / n, cc, pl, slot, limb);
    uint32_t v;
    if constexpr (FOLD) {
      const uint32_t* src = cc == 0 ? x : cc == 1 ? y : zi;
      v = src[(pl * (size_t)N + j0 + col) * C + c * K + r];
    } else {
      // (x : y : 1), or (0 : 1 : 0) where inf; 1 in Montgomery form in
      // component 0, 0 in component 1
      const bool at_inf = zi[(size_t)c * N + j0 + col] != 0;
      const uint32_t one_w = pl % per == 0 ? QParams::one(limb) : 0u;
      if (cc == 2) v = at_inf ? 0u : one_w;
      else if (at_inf) v = cc == 1 ? one_w : 0u;
      else v = (cc == 0 ? x : y)[((size_t)c * 8 * per + pl) * N + j0 + col];
    }
    pts[(c * B + col) * S::NS + slot].v[limb] = v;
  }
  if (!THREADS || wide >= B) S::init(s, sub);  // a staged level runs
  __syncthreads();
  fold_levels<F, W, THREADS, !FOLD>(pts, s, P * B, B, nv, wide, k, sub);
  if constexpr (FOLD) {
    if (K > 1) {
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();  // every block's B sums are final
      if (r == 0) {
        for (int e = tid; e < S::NS * B * (K - 1); e += nt) {
          const Fq* far = cluster.map_shared_rank(smem, e / (S::NS * B) + 1);
          pts[S::NS * B + e] = far[e % (S::NS * B)];
        }
      }
      cluster.sync();  // read: the other blocks may leave
      if (r != 0) return;
      fold_levels<F, W, THREADS, false>(pts, s, K * B, B, K * B, wide, k,
                                        sub);
    }
  }
  for (int e = tid; e < 8 * S::NS * B; e += nt) {
    const int col = e % B;
    int c, pl, slot, limb;
    point_word<F>(e / B, c, pl, slot, limb);
    (c == 0 ? X : c == 1 ? Y : Z)[pl * (size_t)N + j0 + col] =
        pts[col * S::NS + slot].v[limb];
  }
}

constexpr int AFF_TB = 128;  // threads per to_affine block

// to_affine's per-point products run on ZA_AFF_MUL, its roots'
// inversions on ZA_AFF_INV (variants for tools/torch_hpipe_sweep.py).
#ifndef ZA_AFF_MUL
#define ZA_AFF_MUL mul_eo
#endif
#ifndef ZA_AFF_INV
#define ZA_AFF_INV Gcd
#endif
__device__ __forceinline__ Fq aff_mul(const Fq& a, const Fq& b) {
  return ZA_AFF_MUL(a, b);
}
__device__ __forceinline__ Fq2 aff_mul(const Fq2& a, const Fq2& b) {
  const Fq t0 = aff_mul(a.c0, b.c0);  // Karatsuba, as mul(Fq2, Fq2)
  const Fq t1 = aff_mul(a.c1, b.c1);
  const Fq t2 = aff_mul(add(a.c0, a.c1), add(b.c0, b.c1));
  return Fq2{sub(t0, t1), sub(sub(t2, t0), t1)};
}

// What the batch inversion inverts for a Z (its key, always in Fq), and
// 1/Z from the key's inverse.  G1: the key is Z, and the walk back
// reloads it.  G2: the key is the norm N(Z) = Z0^2 + Z1^2, nonzero
// exactly where Z is (-1 is not a square mod q), parked in x's c1
// planes beside the prefix in its c0 planes; 1/Z = conj(Z) N(Z)^-1.
// The tree and the root's inversion stay on Fq, and a G2 point costs 13
// Fq products: 2 squarings and the prefix, 2 in the walk back, 2 for
// conj(Z) N^-1 and 3 + 3 for X/Z and Y/Z (the multi-wave kernel before
// ran the tree, the prefixes and the walk in Fq2: 15 and a Fermat a
// block).
template <class F> struct Affine;
template <> struct Affine<Fq> {
  using Park = Fq;
  __device__ static __forceinline__ Fq key(const Fq& z) { return z; }
  __device__ static __forceinline__ Park park(const Fq& pre, const Fq&) {
    return pre;
  }
  __device__ static __forceinline__ Fq pre(const Park& p) { return p; }
  __device__ static __forceinline__ Fq key(const Park&, const Fq& z) {
    return z;
  }
  __device__ static __forceinline__ Fq inv(const Fq&, const Fq& ki) {
    return ki;
  }
};
template <> struct Affine<Fq2> {
  using Park = Fq2;
  __device__ static __forceinline__ Fq key(const Fq2& z) {
    return add(aff_mul(z.c0, z.c0), aff_mul(z.c1, z.c1));
  }
  __device__ static __forceinline__ Park park(const Fq& pre, const Fq& k) {
    return Fq2{pre, k};
  }
  __device__ static __forceinline__ Fq pre(const Park& p) { return p.c0; }
  __device__ static __forceinline__ Fq key(const Park& p, const Fq2&) {
    return p.c1;
  }
  __device__ static __forceinline__ Fq2 inv(const Fq2& z, const Fq& ki) {
    return Fq2{aff_mul(z.c0, ki), neg(aff_mul(z.c1, ki))};
  }
};

// to_affine in one wave: the grid is as many blocks as the card holds
// at once, each block takes J AFF_TB consecutive points (thread t the
// points t + j AFF_TB, coalesced), its threads keep the exclusive
// prefix products of their nonzero keys and park each in x, where the
// walk back reads it before writing the point.  block_inverse inverts
// the threads' products (a tree in shared memory, one inversion at the
// root), so every block inverts once, all at the same time: one
// inversion's latency for the launch, not one for each wave of blocks.
// Each walk loads its next point while it multiplies the current one.
// Measured (NVIDIA H100 80GB HBM3, 700 W; tools/torch_hpipe_sweep.py):
// G1 on 1.57M points 0.226 ms against 0.372 for a multi-wave kernel
// with inv_gcd and 0.946 with Fermat; 0.242 without the loads in
// flight, 0.455 with Fermat at the root, 0.262 on mul; 0.185 with no
// inversion at all (a timing probe); 0.205-0.207 once the launch bounds
// name one block an SM (116 registers, 96 before).  G2 on 262,144
// points 0.114 against 0.757 for the multi-wave kernel in Fq2 with
// Fermat; 0.253 with Fermat at the roots, 0.136-0.139 on mul, 0.090
// with no inversion; capped at 3 or 4 blocks an SM 0.128-0.131,
// spilling.
template <class F, class Inv>
__global__ void __launch_bounds__(AFF_TB, 1)
to_affine_wave_kernel(const uint32_t* __restrict__ X,
                      const uint32_t* __restrict__ Y,
                      const uint32_t* __restrict__ Z, uint32_t* x,
                      uint32_t* __restrict__ y, int n, int J) {
  using A = Affine<F>;
  using Park = typename A::Park;
  __shared__ Fq tree[2 * AFF_TB];
  const size_t i0 = (size_t)blockIdx.x * J * AFF_TB + threadIdx.x;
  // the thread's points are i0 + j AFF_TB for j < m
  const long left = ((long)n - (long)i0 + AFF_TB - 1) / AFF_TB;
  const int m = left < 0 ? 0 : left < J ? (int)left : J;
  Fq acc = one<Fq>();
  F z;
  if (m > 0) load(z, Z, n, i0);
  for (int j = 0; j < m; ++j) {     // the next Z in flight
    const size_t i = i0 + (size_t)j * AFF_TB;
    F zn;
    if (j + 1 < m) load(zn, Z, n, i + AFF_TB);
    const Fq k = A::key(z);
    store(x, n, i, A::park(acc, k));
    if (!is_zero(k)) acc = aff_mul(acc, k);
    z = zn;
  }
  Fq inv_acc = block_inverse<Fq, AFF_TB, Inv>(acc, tree);
  Park pk;
  F a, b;
  if (m > 0) {
    const size_t i = i0 + (size_t)(m - 1) * AFF_TB;
    load(z, Z, n, i);
    load(pk, x, n, i);
    load(a, X, n, i);
    load(b, Y, n, i);
  }
  for (int j = m - 1; j >= 0; --j) {  // the previous point's loads in flight
    const size_t i = i0 + (size_t)j * AFF_TB;
    F zp, ap, bp;
    Park pp;
    if (j > 0) {
      load(zp, Z, n, i - AFF_TB);
      load(pp, x, n, i - AFF_TB);
      load(ap, X, n, i - AFF_TB);
      load(bp, Y, n, i - AFF_TB);
    }
    const Fq k = A::key(pk, z);
    F zi = zero<F>();
    if (!is_zero(k)) {
      zi = A::inv(z, aff_mul(inv_acc, A::pre(pk)));
      inv_acc = aff_mul(inv_acc, k);
    }
    store(x, n, i, aff_mul(a, zi));
    store(y, n, i, aff_mul(b, zi));
    z = zp;
    pk = pp;
    a = ap;
    b = bp;
  }
}

// The one-wave split of n points: J points a thread, so that the blocks
// (returned) fit on the card at once; negative: a CUDA error.
template <class F, class Inv>
long affine_split(int n, int& J) {
  int dev = 0, sms = 0, per = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per, to_affine_wave_kernel<F, Inv>, AFF_TB, 0);
  if (rc != cudaSuccess) return -(long)rc;
  const long threads = ((long)n + AFF_TB - 1) / AFF_TB;
  const long slots = (long)sms * (per > 0 ? per : 1);
  J = (int)((threads + slots - 1) / slots);
  return (threads + J - 1) / J;
}

template <class F, class Inv>
int launch_affine_wave(const void* X, const void* Y, const void* Z, void* x,
                       void* y, int n, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  int J = 0;
  const long blocks = affine_split<F, Inv>(n, J);
  if (blocks < 0) return (int)-blocks;
  to_affine_wave_kernel<F, Inv><<<(unsigned)blocks, AFF_TB, 0,
                                  (cudaStream_t)stream>>>(
      (const uint32_t*)X, (const uint32_t*)Y, (const uint32_t*)Z,
      (uint32_t*)x, (uint32_t*)y, n, J);
  return (int)cudaGetLastError();
}

template <class F, class O>
int launch_add(const void* X1, const void* Y1, const void* Z1,
               const void* X2, const void* Y2, const void* Z2, void* X3,
               void* Y3, void* Z3, int n, void* stream) {
  if (n > 0) {
    ec_add_kernel<F, O><<<(n + ADD_TB - 1) / ADD_TB, ADD_TB, 0,
                          (cudaStream_t)stream>>>(
        (const uint32_t*)X1, (const uint32_t*)Y1, (const uint32_t*)Z1,
        (const uint32_t*)X2, (const uint32_t*)Y2, (const uint32_t*)Z2,
        (uint32_t*)X3, (uint32_t*)Y3, (uint32_t*)Z3, n);
  }
  return (int)cudaGetLastError();
}

// Lets kernel take smem bytes of dynamic shared memory; 0 or the error.
template <class K>
int allow_smem(K kernel, int smem) {
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) cudaGetLastError();  // or the next launch reports it
  return (int)rc;
}

// The sum of N columns over C lanes each (FOLD: windows of C = L lanes,
// a window over a cluster of K blocks; else chunks, K = 1), B columns a
// block of `warps` warps; levels of more than `wide` adds one add a
// thread where F is G1's Fq (G2's thread add is never compiled in).
template <class F, int W, bool FOLD>
int launch_sum(const void* x, const void* y, const void* z, void* X,
               void* Y, void* Z, int C, int N, int B, int K, int wide,
               int warps, void* stream) {
  if (C < 1 || N < 0 || B < 1 || N % B || warps < 1
      || 32 * warps > FOLD_MAX_THREADS || K < 1 || K > FOLD_MAX_SPLIT
      || (K & (K - 1)) || C % K || (!FOLD && K != 1)
      || (FOLD && (C > FOLD_MAX_LANES || (C & (C - 1)))))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaGetLastError();
  using S = Staged<F, W>;
  const int n = C / K, lanes = (n > K ? n : K) * B;
  int P = 1;
  while (P < n) P <<= 1;
  // a level wider than `wide` (the first is the widest) runs thread adds
  constexpr bool g1 = sizeof(F) == sizeof(Fq);
  const bool threads = g1 && (P > K ? P : K) * B / 2 > wide;
  const int scratch = !threads || wide >= B ? warps * S::UNITS * S::SLOTS : 0;
  const int smem = (lanes * S::NS + scratch) * (int)sizeof(Fq);
  auto kernel = ec_sum_kernel<F, W, false, FOLD>;
  if constexpr (g1) {
    if (threads) kernel = ec_sum_kernel<F, W, true, FOLD>;
  }
  int rc = allow_smem(kernel, smem);
  if (rc) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(N / B * K));
  cfg.blockDim = dim3(32 * warps);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = K > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, (const uint32_t*)x, (const uint32_t*)y,
      (const SumIn<FOLD>*)z, (uint32_t*)X, (uint32_t*)Y, (uint32_t*)Z, C, N,
      B, wide);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  return (int)cudaGetLastError();
}

#ifdef ZA_EC_VARIANTS
// tools/torch_fold_sweep.py's variants: G2 on staged adds of 32, 16 or 8
// lanes
template <bool FOLD>
int g2_width(const void* x, const void* y, const void* z, void* X, void* Y,
             void* Z, int C, int N, int B, int K, int wide, int warps,
             int width, void* stream) {
  if (width == 32)
    return launch_sum<Fq2, 32, FOLD>(x, y, z, X, Y, Z, C, N, B, K, wide,
                                     warps, stream);
  if (width == 16)
    return launch_sum<Fq2, 16, FOLD>(x, y, z, X, Y, Z, C, N, B, K, wide,
                                     warps, stream);
  if (width == 8)
    return launch_sum<Fq2, 8, FOLD>(x, y, z, X, Y, Z, C, N, B, K, wide,
                                    warps, stream);
  return (int)cudaErrorInvalidValue;
}
#endif

}  // namespace za

extern "C" {

int ec_add_g1(const void* X1, const void* Y1, const void* Z1, const void* X2,
              const void* Y2, const void* Z2, void* X3, void* Y3, void* Z3,
              int n, void* stream) {
  return za::launch_add<za::Fq, za::Ops>(X1, Y1, Z1, X2, Y2, Z2, X3, Y3, Z3,
                                         n, stream);
}

int ec_add_g2(const void* X1, const void* Y1, const void* Z1, const void* X2,
              const void* Y2, const void* Z2, void* X3, void* Y3, void* Z3,
              int n, void* stream) {
  return za::launch_add<za::Fq2, za::OpsEo>(X1, Y1, Z1, X2, Y2, Z2, X3, Y3,
                                           Z3, n, stream);
}

int ec_fold_g1(const void* X, const void* Y, const void* Z, void* OX,
               void* OY, void* OZ, int G, int L, int B, int split, int wide,
               int warps, void* stream) {
  return za::launch_sum<za::Fq, 6, true>(X, Y, Z, OX, OY, OZ, L, G, B, split,
                                         wide, warps, stream);
}

int ec_fold_g2(const void* X, const void* Y, const void* Z, void* OX,
               void* OY, void* OZ, int G, int L, int B, int split, int wide,
               int warps, void* stream) {
  return za::launch_sum<za::Fq2, za::FOLD_G2_WIDTH, true>(
      X, Y, Z, OX, OY, OZ, L, G, B, split, wide, warps, stream);
}

int ec_carry_g1(const void* x, const void* y, const void* inf, void* X,
                void* Y, void* Z, int C, int N, int B, int wide, int warps,
                void* stream) {
  return za::launch_sum<za::Fq, 6, false>(x, y, inf, X, Y, Z, C, N, B, 1,
                                          wide, warps, stream);
}

int ec_carry_g2(const void* x, const void* y, const void* inf, void* X,
                void* Y, void* Z, int C, int N, int B, int wide, int warps,
                void* stream) {
  return za::launch_sum<za::Fq2, za::CARRY_G2_WIDTH, false>(
      x, y, inf, X, Y, Z, C, N, B, 1, wide, warps, stream);
}

#ifdef ZA_EC_VARIANTS
// the G2 carry and fold on staged adds of 32, 16 or 8 lanes
int ec_carry_g2_width(const void* x, const void* y, const void* inf,
                      void* X, void* Y, void* Z, int C, int N, int B,
                      int wide, int warps, int width, void* stream) {
  return za::g2_width<false>(x, y, inf, X, Y, Z, C, N, B, 1, wide, warps,
                             width, stream);
}

int ec_fold_g2_width(const void* X, const void* Y, const void* Z, void* OX,
                     void* OY, void* OZ, int G, int L, int B, int split,
                     int wide, int warps, int width, void* stream) {
  return za::g2_width<true>(X, Y, Z, OX, OY, OZ, L, G, B, split, wide,
                            warps, width, stream);
}
#endif

int horner_g1(const void* WX, const void* WY, const void* WZ, void* X,
              void* Y, void* Z, int M, int W, int bits, void* stream) {
  if (M > 0) {
    za::horner_warp_g1_kernel<<<M, 32, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)WX, (const uint32_t*)WY, (const uint32_t*)WZ,
        (uint32_t*)X, (uint32_t*)Y, (uint32_t*)Z, M, W, bits);
  }
  return (int)cudaGetLastError();
}

int horner_g2(const void* WX, const void* WY, const void* WZ, void* X,
              void* Y, void* Z, int M, int W, int bits, void* stream) {
  if (M > 0) {
    za::horner_warp_g2_kernel<<<M, 32, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)WX, (const uint32_t*)WY, (const uint32_t*)WZ,
        (uint32_t*)X, (uint32_t*)Y, (uint32_t*)Z, M, W, bits);
  }
  return (int)cudaGetLastError();
}

int to_affine_g1(const void* X, const void* Y, const void* Z, void* x,
                 void* y, int n, void* stream) {
  return za::launch_affine_wave<za::Fq, za::ZA_AFF_INV>(X, Y, Z, x, y, n,
                                                        stream);
}

int to_affine_g2(const void* X, const void* Y, const void* Z, void* x,
                 void* y, int n, void* stream) {
  return za::launch_affine_wave<za::Fq2, za::ZA_AFF_INV>(X, Y, Z, x, y, n,
                                                         stream);
}

// The blocks to_affine_g1 (g2 = 0) or _g2 launches for n points, each
// inverting once (chip_smoke.py counts them in the bound); negative: a
// CUDA error.
long to_affine_blocks(int n, int g2) {
  int J = 0;
  if (n <= 0) return 0;
  return g2 ? za::affine_split<za::Fq2, za::ZA_AFF_INV>(n, J)
            : za::affine_split<za::Fq, za::ZA_AFF_INV>(n, J);
}

}  // extern "C"
