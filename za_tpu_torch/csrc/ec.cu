// Elementwise curve kernels for G1 (over Fq) and G2 (over Fq2).
//
// ec_add: complete projective addition (Renes-Costello-Batina 2015,
// algorithm 7, a = 0), one point pair per thread.  It serves the
// {1P..8P} table build at staging, the per-chunk projective carry and
// the lane fold of the tree MSM.
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

// Horner over the window sums of M MSMs, one warp per MSM: the chain
// walks the W windows MSB first, acc = 2^bits acc + S_w (bits doublings
// through the complete add, then one add; bits = 4 for signed
// radix-16, 2 for radix-4).  Each complete add (RCB algorithm 7) runs
// in stages, operands passing through the warp's slots in shared memory
// (one Fq each), __syncwarp between stages: six independent Fq
// products on six lanes, a combine on one lane per value, six more
// products, a combine into X3, Y3, Z3.  In G1 3b = 9, so the products
// by 3b are three doublings and an add inside the first combine: two
// product latencies an add.  Every value is canonical, so the
// coordinates equal the plain version's bit for bit.
namespace hw1 {
constexpr int ZERO = 0;   // an Fq zero (the absent operand)
constexpr int P = 1;      // the accumulator X, Y, Z: 1..3
constexpr int Q = 4;      // the window sum S_w: 4..6
constexpr int L1 = 7;     // level-1 products: 7..12
constexpr int C1 = 13;    // 3 t0, t3, t4, 3b y3, t1', Z3': 13..18
constexpr int L3 = 19;    // level-3 products: 19..24
constexpr int SLOTS = 25;

// level 1: X1 X2, Y1 Y2, Z1 Z2, (X1+Y1)(X2+Y2), (Y1+Z1)(Y2+Z2),
// (X1+Z1)(X2+Z2): the two coordinates summed (offsets from P or Q;
// -1 none), the same on both sides
__device__ const int8_t L1_OPS[6][2] = {{0, -1}, {1, -1}, {2, -1},
                                        {0, 1},  {1, 2},  {0, 2}};
// level 3 (a, b): t4 3b y3, t3 t1', 3b y3 3 t0, t1' Z3', 3 t0 t3, Z3' t4
__device__ const int8_t L3_OPS[6][2] = {
    {C1 + 2, C1 + 3}, {C1 + 1, C1 + 4}, {C1 + 3, C1 + 0},
    {C1 + 4, C1 + 5}, {C1 + 0, C1 + 1}, {C1 + 5, C1 + 2}};
// combine stages: value v = 9^NINE[v] (sum of +-K_j over the terms
// +-(j + 1) of row v) +- K_j of POST[v] (0: none), K_j the stage's
// j-th product
__device__ const int8_t C1_TERMS[6][3] = {
    {1, 1, 1}, {4, -1, -2}, {5, -2, -3},  // 3 t0, m3 - t0 - t1, m4 - t1 - t2
    {6, -1, -3}, {-3, 0, 0}, {3, 0, 0}};  // m5 - t0 - t2, -t2, t2
__device__ const int8_t C1_NINE[6] = {0, 0, 0, 1, 1, 1};
__device__ const int8_t C1_POST[6] = {0, 0, 0, 0, 2, 2};  // t1' = t1 - 9 t2,
                                                          // Z3' = t1 + 9 t2
__device__ const int8_t C3_TERMS[3][3] = {
    {2, -1, 0}, {4, 3, 0}, {6, 5, 0}};  // X3, Y3, Z3

// Lane l < 6: product l, (s[a1] + s[a2]) (s[b1] + s[b2]).
__device__ __forceinline__ void product(Fq* s, int out, int lane, int a1,
                                        int a2, int b1, int b2) {
  const Fq r = mul(add(s[a1], s[a2]), add(s[b1], s[b2]));
  if (lane < 6) s[out + lane] = r;
}

// r +- K_j for the term e = +-(j + 1) of the products at L (0: r)
__device__ __forceinline__ Fq term(const Fq* s, int L, const Fq& r, int e) {
  const Fq& k = s[e ? L + (e < 0 ? -e : e) - 1 : ZERO];
  return e < 0 ? sub(r, k) : add(r, k);
}

// Lane l < nv: value v = l of the stage (see C1_TERMS).
__device__ __forceinline__ void combine(Fq* s, int out, int nv, int lane,
                                        int L, const int8_t (*terms)[3],
                                        const int8_t* nine,
                                        const int8_t* post) {
  const int v = min(lane, nv - 1);
  Fq r = s[ZERO];
#pragma unroll
  for (int i = 0; i < 3; ++i) r = term(s, L, r, terms[v][i]);
  if (nine && nine[v]) {  // 9 r = 8 r + r
    Fq r8 = add(r, r);
    r8 = add(r8, r8);
    r8 = add(r8, r8);
    r = add(r8, r);
  }
  if (post) r = term(s, L, r, post[v]);
  if (lane < nv) s[out + lane] = r;
}

// acc = acc + (the point at slot qb: P doubles, Q adds S_w)
__device__ __noinline__ void point_add(Fq* s, int qb, int lane) {
  const int j = min(lane, 5);
  const int o1 = L1_OPS[j][0], o2 = L1_OPS[j][1];
  product(s, L1, lane, P + o1, o2 < 0 ? ZERO : P + o2, qb + o1,
          o2 < 0 ? ZERO : qb + o2);
  __syncwarp();
  combine(s, C1, 6, lane, L1, C1_TERMS, C1_NINE, C1_POST);
  __syncwarp();
  product(s, L3, lane, L3_OPS[j][0], ZERO, L3_OPS[j][1], ZERO);
  __syncwarp();
  combine(s, P, 3, lane, L3, C3_TERMS, nullptr, nullptr);
  __syncwarp();
}
}  // namespace hw1

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
    for (int d = 0; d < bits; ++d) hw1::point_add(s, hw1::P, lane);
    if (lane < 24) s[hw1::Q + c].v[j] = sw;
    __syncwarp();
    hw1::point_add(s, hw1::Q, lane);
  }
  if (lane < 24) {
    uint32_t* dst = c == 0 ? X : c == 1 ? Y : Z;
    dst[(size_t)j * M + m] = s[hw1::P + c].v[j];
  }
}

// Horner over G2 window sums, one warp per MSM.  The chain is G1's
// (bits doublings and one add per window, each RCB algorithm 7); each
// group operation's Fq products run on separate lanes: its
// three product levels (6, 2 and 6 Fq2 products, each Fq2 product as
// four Fq sub-products on four lanes: 24, 8, 24 lanes) each take one
// product's latency, and the additions between them run on one lane
// per output component.  Operands pass through the warp's scratch in
// shared memory (slots of one Fq, below), __syncwarp between stages.
// Every value is canonical, so the coordinates equal the plain
// version's bit for bit.
namespace hw2 {
constexpr int ZERO = 0;  // 0, 1: an Fq2 zero (the absent operand)
constexpr int P = 2;     // the accumulator X, Y, Z (c0, c1 each): 2..7
constexpr int Q = 8;     // the window sum S_w: 8..13
constexpr int B3 = 14;   // 3b: 14, 15
constexpr int L1 = 16;   // level-1 sub-products: 16..39
constexpr int C1 = 40;   // 3 t0, t1, t2, t3, t4, y3: 40..51
constexpr int L2 = 52;   // level-2 sub-products: 52..59
constexpr int C2 = 60;   // 3b y3, t1 - 3b t2, t1 + 3b t2: 60..65
constexpr int L3 = 66;   // level-3 sub-products: 66..89
constexpr int SLOTS = 90;

// level 1: X1 X2, Y1 Y2, Z1 Z2, (X1+Y1)(X2+Y2), (Y1+Z1)(Y2+Z2),
// (X1+Z1)(X2+Z2): the two coordinates summed (offsets from P or Q;
// -1 none), the same on both sides
__device__ const int8_t L1_OPS[6][2] = {{0, -1}, {2, -1}, {4, -1},
                                        {0, 2},  {2, 4},  {0, 4}};
// level 3 (a, b): t4 3b y3, t3 t1', 3b y3 3 t0, t1' Z3, 3 t0 t3, Z3 t4
__device__ const int8_t L3_OPS[6][2] = {
    {C1 + 8, C2 + 0}, {C1 + 6, C2 + 2}, {C2 + 0, C1 + 0},
    {C2 + 2, C2 + 4}, {C1 + 0, C1 + 6}, {C2 + 4, C1 + 8}};
// combine stages: Fq2 value v = keep[v] + sum of +-K_j over the terms
// +-(j + 1) of row v (0: none), K_j the stage's j-th Fq2 product
__device__ const int8_t C1_TERMS[6][3] = {
    {1, 1, 1}, {2, 0, 0}, {3, 0, 0},  // 3 t0, t1, t2
    {4, -1, -2}, {5, -2, -3}, {6, -1, -3}};  // m3 - t0 - t1, m4 - t1 - t2,
                                             // m5 - t0 - t2
__device__ const int8_t C2_TERMS[3][3] = {{2, 0, 0}, {-1, 0, 0}, {1, 0, 0}};
__device__ const int8_t C2_KEEP[3] = {ZERO, C1 + 2, C1 + 2};  // +t1
__device__ const int8_t C3_TERMS[3][3] = {
    {2, -1, 0}, {4, 3, 0}, {6, 5, 0}};  // X3, Y3, Z3

// Lane l < 4 np: sub-product q = l & 3 of Fq2 product j = l >> 2,
// A_ca B_cb with (ca, cb) = (0,0), (1,1), (0,1), (1,0); A = s[a1] + s[a2]
// and B = s[b1] + s[b2] as Fq2 values (slots of their c0).
__device__ __forceinline__ void product(Fq* s, int out, int np, int lane,
                                        int a1, int a2, int b1, int b2) {
  const int q = lane & 3, ca = q & 1, cb = (q ^ (q >> 1)) & 1;
  const Fq r = mul(add(s[a1 + ca], s[a2 + ca]), add(s[b1 + cb], s[b2 + cb]));
  if (lane < 4 * np) s[out + lane] = r;
}

// Lane l < 2 nv: component c = l & 1 of value v = l >> 1 (see C1_TERMS),
// with K_j = (S_4j - S_4j+1, S_4j+2 + S_4j+3) from the sub-products at L.
__device__ __forceinline__ void combine(Fq* s, int out, int nv, int lane,
                                        int L, const int8_t (*terms)[3],
                                        const int8_t* keep) {
  const int v = min(lane >> 1, nv - 1), c = lane & 1;
  Fq r = s[(keep ? keep[v] : ZERO) + c];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int e = terms[v][i];
    const int at = e ? L + 4 * ((e < 0 ? -e : e) - 1) + 2 * c : ZERO;
    const Fq k = c ? add(s[at], s[at + 1]) : sub(s[at], s[at + 1]);
    r = e < 0 ? sub(r, k) : add(r, k);
  }
  if (lane < 2 * nv) s[out + lane] = r;
}

// acc = acc + (the Fq2 point at slot qb: P doubles, Q adds S_w)
__device__ __noinline__ void point_add(Fq* s, int qb, int lane) {
  const int j = min(lane >> 2, 5);
  const int o1 = L1_OPS[j][0], o2 = L1_OPS[j][1];
  product(s, L1, 6, lane, P + o1, o2 < 0 ? ZERO : P + o2, qb + o1,
          o2 < 0 ? ZERO : qb + o2);
  __syncwarp();
  combine(s, C1, 6, lane, L1, C1_TERMS, nullptr);
  __syncwarp();
  product(s, L2, 2, lane, B3, ZERO, (lane >> 2) & 1 ? C1 + 10 : C1 + 4,
          ZERO);  // 3b t2, 3b y3
  __syncwarp();
  combine(s, C2, 3, lane, L2, C2_TERMS, C2_KEEP);
  __syncwarp();
  product(s, L3, 6, lane, L3_OPS[j][0], ZERO, L3_OPS[j][1], ZERO);
  __syncwarp();
  combine(s, P, 3, lane, L3, C3_TERMS, nullptr);
  __syncwarp();
}
}  // namespace hw2

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
    for (int d = 0; d < bits; ++d) hw2::point_add(s, hw2::P, lane);
    for (int i = 0; i < 2; ++i) {
      const int k = lane + 32 * i;
      if (k < 48) s[hw2::Q + (k >> 3)].v[k & 7] = sw[i];
    }
    __syncwarp();
    hw2::point_add(s, hw2::Q, lane);
  }
  for (int k = lane; k < 48; k += 32) {
    uint32_t* dst = (k >> 4) == 0 ? X : (k >> 4) == 1 ? Y : Z;
    dst[(2 * (k & 7) + ((k >> 3) & 1)) * M + m] = s[hw2::P + (k >> 3)].v[k & 7];
  }
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
  return za::launch_affine<za::Fq, 8>(X, Y, Z, x, y, n, stream);
}

int to_affine_g2(const void* X, const void* Y, const void* Z, void* x,
                 void* y, int n, void* stream) {
  return za::launch_affine<za::Fq2, 4>(X, Y, Z, x, y, n, stream);
}

}  // extern "C"
