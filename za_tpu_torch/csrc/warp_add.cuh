// The warp-staged complete add of G1 (over Fq) and G2 (over Fq2): one
// group operation (RCB 2015 algorithm 7, a = 0, curve.cuh's point_add)
// whose Fq products run on separate lanes of a warp, operands passing
// through the warp's slots in shared memory (one Fq each), __syncwarp
// between stages, with Staged (the add's slots, lanes and scratch)
// and point_word (a point's words in the limb planes) over it.
// Shared by the Horner kernels and the lane fold and chunk carry
// (ec.cu) and the fixed-base table's doubling ladder and window levels
// (fixed_base.cu): header-only __device__ code over curve.cuh.
//
// hw1 (G1): six independent Fq products on six lanes, a combine on one
// lane per value, six more products, a combine into X3, Y3, Z3.  In G1
// 3b = 9, so the products by 3b are three doublings and an add inside
// the first combine: two product latencies an add.
// hw2 (G2): three product levels (6, 2 and 6 Fq2 products, each Fq2
// product as four Fq sub-products on four lanes: 24, 8, 24 lanes) each
// take one product's latency, and the additions between them run on
// one lane per output component: three product latencies an add.
// Every value is canonical, so the coordinates equal curve.cuh's
// point_add's bit for bit.

#pragma once

#include "curve.cuh"

namespace za {

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

// Lane l < 6: product l, (a1 + a2) (b1 + b2).
__device__ __forceinline__ void product(Fq* s, int out, int lane,
                                        const Fq& a1, const Fq& a2,
                                        const Fq& b1, const Fq& b2) {
  const Fq r = mul(add(a1, a2), add(b1, b2));
  if (lane < 6) s[out + lane] = r;
}

// r +- K_j for the term e = +-(j + 1) of the products at L (0: r)
__device__ __forceinline__ Fq term(const Fq* s, int L, const Fq& r, int e) {
  const Fq& k = s[e ? L + (e < 0 ? -e : e) - 1 : ZERO];
  return e < 0 ? sub(r, k) : add(r, k);
}

// Lane l < nv: value v = l of the stage (see C1_TERMS), into out[l].
__device__ __forceinline__ void combine(const Fq* s, Fq* out, int nv,
                                        int lane, int L,
                                        const int8_t (*terms)[3],
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
  if (lane < nv) out[lane] = r;
}

// p = p + q: p and q the X, Y, Z slots of two points (in this scratch
// or elsewhere in shared memory; the same slots double), s the scratch
__device__ __noinline__ void point_add(Fq* s, Fq* p, const Fq* q,
                                       int lane) {
  const int j = min(lane, 5);
  const int o1 = L1_OPS[j][0], o2 = L1_OPS[j][1];
  product(s, L1, lane, p[o1], o2 < 0 ? s[ZERO] : p[o2], q[o1],
          o2 < 0 ? s[ZERO] : q[o2]);
  __syncwarp();
  combine(s, s + C1, 6, lane, L1, C1_TERMS, C1_NINE, C1_POST);
  __syncwarp();
  product(s, L3, lane, s[L3_OPS[j][0]], s[ZERO], s[L3_OPS[j][1]], s[ZERO]);
  __syncwarp();
  combine(s, p, 3, lane, L3, C3_TERMS, nullptr, nullptr);
  __syncwarp();
}
}  // namespace hw1

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
// A_ca B_cb with (ca, cb) = (0,0), (1,1), (0,1), (1,0); A = a1 + a2 and
// B = b1 + b2 as Fq2 values (pointers to their c0).
__device__ __forceinline__ void product(Fq* s, int out, int np, int lane,
                                        const Fq* a1, const Fq* a2,
                                        const Fq* b1, const Fq* b2) {
  const int q = lane & 3, ca = q & 1, cb = (q ^ (q >> 1)) & 1;
  const Fq r = mul(add(a1[ca], a2[ca]), add(b1[cb], b2[cb]));
  if (lane < 4 * np) s[out + lane] = r;
}

// Lane l < 2 nv: component c = l & 1 of value v = l >> 1 (see C1_TERMS),
// with K_j = (S_4j - S_4j+1, S_4j+2 + S_4j+3) from the sub-products at
// L, into out[l].
__device__ __forceinline__ void combine(const Fq* s, Fq* out, int nv,
                                        int lane, int L,
                                        const int8_t (*terms)[3],
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
  if (lane < 2 * nv) out[lane] = r;
}

// p = p + q: p and q the six Fq slots (X, Y, Z; c0, c1 each) of two
// points (in this scratch or elsewhere in shared memory; the same slots
// double), s the scratch.  W lanes (sub = 0 .. W-1) run the add: a
// stage of n values takes ceil(n / W) rounds, lane sub taking the
// stage's lanes sub, sub + W, ... (W = 32: one round each, the Horner
// kernel's warp).
template <int W = 32>
__device__ __noinline__ void point_add(Fq* s, Fq* p, const Fq* q, int sub) {
  const Fq* z = s + ZERO;
#pragma unroll
  for (int lane = sub; lane < sub + 24 + (W - 24 % W) % W; lane += W) {
    const int j = min(lane >> 2, 5);
    const int o1 = L1_OPS[j][0], o2 = L1_OPS[j][1];
    product(s, L1, 6, lane, p + o1, o2 < 0 ? z : p + o2, q + o1,
            o2 < 0 ? z : q + o2);
  }
  __syncwarp();
#pragma unroll
  for (int lane = sub; lane < sub + 12 + (W - 12 % W) % W; lane += W)
    combine(s, s + C1, 6, lane, L1, C1_TERMS, nullptr);
  __syncwarp();
  product(s, L2, 2, sub, s + B3, z,
          s + ((sub >> 2) & 1 ? C1 + 10 : C1 + 4), z);  // 3b t2, 3b y3
  __syncwarp();
  combine(s, s + C2, 3, sub, L2, C2_TERMS, C2_KEEP);
  __syncwarp();
#pragma unroll
  for (int lane = sub; lane < sub + 24 + (W - 24 % W) % W; lane += W) {
    const int j = min(lane >> 2, 5);
    product(s, L3, 6, lane, s + L3_OPS[j][0], z, s + L3_OPS[j][1], z);
  }
  __syncwarp();
  combine(s, p, 3, sub, L3, C3_TERMS, nullptr);
  __syncwarp();
}
}  // namespace hw2

// The staged add over a scratch of SLOTS Fq of its own: a point is NS
// consecutive Fq slots from P (Q: the second operand), X, Y, Z (G1);
// X.c0, X.c1, Y.c0, Y.c1, Z.c0, Z.c1 (G2); WIDTH lanes run one add,
// UNITS adds a warp (lane sub = 0 .. WIDTH - 1 of its add).
// W: the add's lanes, by default G1's 6 and G2's warp
template <class F, int W = sizeof(F) == sizeof(Fq) ? 6 : 32> struct Staged;
template <> struct Staged<Fq, 6> {
  static constexpr int NS = 3, UNITS = 5, WIDTH = 6;
  static constexpr int SLOTS = hw1::SLOTS, P = hw1::P, Q = hw1::Q;
  __device__ static void init(Fq* s, int sub) {  // ZERO
    for (int w = sub; w < 8; w += WIDTH) s[hw1::ZERO].v[w] = 0u;
  }
  __device__ static void add(Fq* s, Fq* p, const Fq* q, int sub) {
    hw1::point_add(s, p, q, sub);
  }
};
template <int W> struct Staged<Fq2, W> {
  static constexpr int NS = 6, UNITS = 32 / W, WIDTH = W;
  static constexpr int SLOTS = hw2::SLOTS, P = hw2::P, Q = hw2::Q;
  __device__ static void init(Fq* s, int sub) {  // ZERO and 3b
    const Fq2 b = b3<Fq2>();
    for (int w = sub; w < 16; w += WIDTH) {
      s[hw2::ZERO + (w >> 3)].v[w & 7] = 0u;
      s[hw2::B3 + (w >> 3)].v[w & 7] = (w >> 3) ? b.c1.v[w & 7]
                                                : b.c0.v[w & 7];
    }
  }
  __device__ static void add(Fq* s, Fq* p, const Fq* q, int sub) {
    hw2::point_add<W>(s, p, q, sub);
  }
};

// Word r < 8 NS of a point: coordinate c, plane pl within it (the limb in
// G1, 2 limb + component in G2), and its slot and limb among the point's
// NS slots.
template <class F>
__device__ __forceinline__ void point_word(int r, int& c, int& pl, int& slot,
                                           int& limb) {
  constexpr int per = Staged<F>::NS / 3;  // Fq slots of a coordinate
  c = r / (8 * per);
  pl = r % (8 * per);
  slot = c * per + pl % per;
  limb = pl / per;
}

}  // namespace za
