// The NTT over Fr: the three kernels of the four-step transform
// (engine/ntt.py fourstep_core), which takes every domain size.
//
// Values are canonical Montgomery Fr elements as limb planes.  A batch
// of B sub-NTTs of length S, each applied to L lanes, is (8, B, S, L):
// the transform runs along S, lanes are independent columns.  Twiddle
// tables are (8, S/2) holding w^k.  DIT stage of half-length h pairs
// rows i = 2h g + j and i + h: (u, v) -> (u + w^(j S / 2h) v,
// u - w^(j S / 2h) v).
//
// ntt_prefix_fr replaces the reference's fused Pallas prefix
// (za_tpu/engine/pallas_ntt.py sub_ntt_fused, _prefix_kernel): the bit
// reversal along S and stages 2..m (m = m_fuse rows) in one pass.  One
// block owns a tile of rows = min(S, PREFIX_ROWS) rows x
// PREFIX_BLOCK_LANES lanes (rows / m segments of m rows); row i of the
// tile is gathered from row bitrev_S(tile rows + i), so the reference's
// separate gather is the load.  Each thread holds PREFIX_EL = 4 values in
// registers and runs the stages two at a time as radix-4 butterflies
// there (the first pass on four consecutive rows, where the twiddles are
// known per slot and the w^0 = 1 products are skipped; then rows at
// stride 4, 16, 64, 256), with an exchange through shared memory between
// passes (limb planes (8, rows, PREFIX_BLOCK_LANES), rows permuted so
// that every exchange hits 32 banks): log2(m) = 9 stages take four
// exchanges, not nine round trips.  The m/2 twiddles w_m^k are staged in
// shared memory once.  The Montgomery product's latency bounds it: four
// values a thread and four lanes a block (82 registers, 64 KB, 512
// threads) beat eight values and eight lanes (128 registers, 128 KB) by
// ~20% a proof (tools/torch_prefix_sweep.py).  Modes (flags, the torch
// code at a transform's boundaries taken in): SCALE_IN multiplies each
// value as it is gathered by a table indexed by its natural input index
// (the coset powers of the forward coset NTT); COMBINE reads three legs
// a, b, c at the same index and loads a b - c (h(x)'s combine, before
// the coset iNTT); SCALE_OUT (m = S only) multiplies each output by a
// table of plain values indexed by its natural output index, which
// yields the plain product (the coset and 1/Z scalings and from_mont of
// the coset iNTT in one product), and writes 16-bit plain limbs (16, B,
// S, L).  Every mode is exact on canonical values.  Bound: operations,
// (S / m)(m / 2 log2(m) - (m - 1)) L multiplications per transform (the
// butterflies whose twiddle is not w^0 = 1; 256 32-bit multiply-adds
// each), plus one per value per mode, against 64 B per value moved.
//
// ntt_twiddle_fr replaces XLA code of the reference's four-step
// (ntt_rns.py _fourstep_core: mont_mul_rns by the inter-factor twiddles,
// then swapaxes): out[b, c, r] = a[b, r, c] * inter[r, c].  Bound: bytes,
// 96 B a product (a and inter read, out written); at 2^17 (3 x 512 x
// 512) 58.7 MB, 17.5 us, and 786,432 products, which at the rate the
// Montgomery product reaches on this card (tools/torch_hpipe_sweep.py)
// take about as long, so the kernel has to keep the loads and the
// products busy at once.  A block of 256 threads takes a 16 x 32 tile
// of (r, c).  Each thread first issues every load it needs: TW_V = 2
// consecutive columns of one row, as one 8-byte load a limb plane of a
// and of inter; then runs its two products (mul_eo, whose two chains a
// row run side by side) into a shared-memory tile held column-major
// (one padding word a column: a warp's row writes hit 32 banks, its
// column reads two ways); then writes two consecutive rows of one column
// as one 8-byte store a limb plane.  60 registers, no spill, 4 blocks
// (32 warps) an SM; 1,536 blocks at 2^17.  It beat four columns a thread
// (16-byte accesses, 94 registers, 20 warps an SM), 32 x 32 tiles and
// mul at both rungs, alone and inside h (tools/torch_hpipe_sweep.py).
// Shapes whose R or C is no multiple of TW_V, or unaligned tensors, take
// the same schedule with 4-byte accesses and bounds checks.
//
// ntt_stage_fr replaces the reference's XLA stage loop (ntt_rns.py
// _ntt_core, _sub_ntt_axis1) where the prefix does not end a sub-NTT:
// the stages of half-lengths m_fuse .. S/2 (the tail; S > m_fuse = 512
// first at a 2^19 domain), out of place, with the prefix's store mode.
// The rows j + q hb (q < 2^s) of one transform b and lane l, j < hb,
// are closed under the stages of half-lengths hb .. 2^(s-1) hb, so one
// thread takes one such group: it loads its 2^s values (consecutive
// threads, consecutive lanes: 128 B a warp and limb plane), runs the s
// stages in registers and stores once; with PREFIX_SCALE_OUT it
// multiplies each output by the plain table and writes 16-bit plain
// limbs, the prefix's store code.  Stage u (half h = 2^u hb) pairs q and
// q + 2^u (bit u of q clear) with the twiddle w^(k S / 2h), k = j + (q
// mod 2^u) hb: the 2^s - 1 twiddles of a thread are loaded once each,
// and a warp's 32 lanes share them.  A launch runs up to
// TAIL_MAX_STAGES stages (8 values a thread); more take further
// launches (first at a 2^25 domain).  Products are mul_eo.  Bound:
// bytes, 64 B per value (32 in, 32 out) and 32 more for the table and
// 32 more out in the store mode, against one product per butterfly.

#include "field.cuh"

namespace za {

// the prefix's lane tile: L is a multiple of it (engine/ntt.py's
// PREFIX_LANES, held equal to it by a test); one block takes
// PREFIX_BLOCK_LANES of its lanes
constexpr int PREFIX_LANES = 8;
constexpr int PREFIX_BLOCK_LANES = 4;
constexpr int PREFIX_ROWS = 512;  // rows of one prefix tile, at most
constexpr int PREFIX_LOG_EL = 2;  // a thread holds 2^this values and
constexpr int PREFIX_EL = 1 << PREFIX_LOG_EL;  // runs that many stages a pass
constexpr int PREFIX_TB = PREFIX_ROWS * PREFIX_BLOCK_LANES / PREFIX_EL;
// ntt_prefix_fr modes (flags); engine/ntt.py's PREFIX_MODES
constexpr int PREFIX_SCALE_IN = 1;
constexpr int PREFIX_COMBINE = 2;
constexpr int PREFIX_SCALE_OUT = 4;
// the twiddle transpose's tile: TW_R rows x TW_C columns of (r, c); a
// thread loads TW_V consecutive columns of a row and stores TW_V
// consecutive rows of a column.  ZA_TW_* select variants for
// tools/torch_hpipe_sweep.py.
#ifndef ZA_TW_COLS
#define ZA_TW_COLS 2
#endif
#ifndef ZA_TW_ROWS
#define ZA_TW_ROWS 16
#endif
#ifndef ZA_TW_MUL
#define ZA_TW_MUL mul_eo
#endif
constexpr int TW_V = ZA_TW_COLS;
constexpr int TW_R = ZA_TW_ROWS;
constexpr int TW_C = 32;
constexpr int TW_TB = TW_R * TW_C / TW_V;   // threads of a block
// the tail: stages a launch at most (2^this values a thread; engine/ntt.py
// TAIL_MAX_STAGES, held equal by a test) and threads a block
constexpr int TAIL_MAX_STAGES = 3;
constexpr int TAIL_TB = 256;

__device__ __forceinline__ unsigned bitrev(unsigned i, int bits) {
  return bits ? __brev(i) >> (32 - bits) : 0u;
}

__device__ __forceinline__ void butterfly(Fr& u, Fr& v, const Fr& w) {
  const Fr vt = mul(v, w);
  v = sub(u, vt);
  u = add(u, vt);
}

// the products of the prefix (mul) and of the tail (mul_eo)
struct PrefixMul {
  __device__ static __forceinline__ Fr f(const Fr& a, const Fr& b) {
    return mul(a, b);
  }
};
struct TailMul {
  __device__ static __forceinline__ Fr f(const Fr& a, const Fr& b) {
    return mul_eo(a, b);
  }
};

// the store of value v where a pass ends its sub-NTT: at index at of
// planes plane_out; with PREFIX_SCALE_OUT the product by the plain table
// tout[dst] (planes sl), which is the plain value, as 16 planes of
// 16-bit limbs, else v as 8 planes
template <class M>
__device__ __forceinline__ void store_out(uint32_t* y, size_t plane_out,
                                          size_t at, const uint32_t* tout,
                                          size_t sl, size_t dst,
                                          const Fr& v, int mode) {
  if (mode & PREFIX_SCALE_OUT) {
    Fr w;
    load(w, tout, sl, dst);
    const Fr p = M::f(v, w);  // tout plain: the plain product
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      y[(2 * q) * plane_out + at] = p.v[q] & 0xffffu;
      y[(2 * q + 1) * plane_out + at] = p.v[q] >> 16;
    }
  } else {
    store(y, plane_out, at, v);
  }
}

// the stages of half-lengths hb .. 2^(s-1) hb of (8, B, S, L) x into y:
// thread t takes lane l = t mod L of transform b, rows r0 + q hb, r0 =
// seg 2^s hb + j (j < hb), from (b, seg, j) = t / L
template <int s>
__global__ void __launch_bounds__(TAIL_TB)
ntt_tail_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                const uint32_t* __restrict__ tw,
                const uint32_t* __restrict__ tout, int B, int S, int L,
                int hb, int mode) {
  constexpr int V = 1 << s;
  // B S L < 2^32 (the entry point checks it): 32-bit index arithmetic
  const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned per = (unsigned)(S >> s) * (unsigned)L;  // a transform's
  if (t >= (unsigned)B * per) return;
  const unsigned b = t / per, r = t - b * per;
  const unsigned g = r / (unsigned)L, l = r - g * (unsigned)L;
  const int log_hb = __ffs(hb) - 1;
  const unsigned seg = g >> log_hb, j = g & (unsigned)(hb - 1);
  const size_t sl = (size_t)S * L;
  const size_t plane = (size_t)B * sl;
  const size_t row0 = (size_t)seg * V * hb + j;
  const size_t step0 = (size_t)(S / 2) >> log_hb;   // S / 2hb
  Fr v[V];
#pragma unroll
  for (int q = 0; q < V; ++q)
    load(v[q], x, plane, b * sl + (row0 + (size_t)q * hb) * L + l);
#pragma unroll
  for (int u = 0; u < s; ++u) {
    const size_t step = step0 >> u;                  // S / 2h
#pragma unroll
    for (int e = 0; e < (1 << u); ++e) {
      const size_t k = j + (size_t)e * hb;   // the row mod h
      Fr w;
#pragma unroll
      for (int qq = 0; qq < 8; ++qq)
        w.v[qq] = __ldg(tw + (size_t)qq * (S / 2) + k * step);
#pragma unroll
      for (int hi = 0; hi < (V >> (u + 1)); ++hi) {
        const int q = (hi << (u + 1)) | e;
        const Fr vt = TailMul::f(v[q + (1 << u)], w);
        v[q + (1 << u)] = sub(v[q], vt);
        v[q] = add(v[q], vt);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < V; ++q) {
    const size_t dst = (row0 + (size_t)q * hb) * L + l;
    store_out<TailMul>(y, plane, b * sl + dst, tout, sl, dst, v[q], mode);
  }
}

// row of value idx of thread t (tile row) in a pass of s stages of
// half-lengths 2^ld .. 2^(ld + s - 1): the thread holds PREFIX_EL >> s
// groups of 2^s values at stride 2^ld
__device__ __forceinline__ int pass_row(int t, int idx, int s, int ld) {
  const int grp = t * (PREFIX_EL >> s) + (idx >> s);
  const int e = idx & ((1 << s) - 1);
  return ((grp >> ld) << (ld + s)) + (grp & ((1 << ld) - 1)) + (e << ld);
}

// slot of tile row r, lane l in a shared-memory plane: r's bit 3 XORed
// into bit 0 and bit 4 into bits 1 and 2, so that the rows of one value
// of one pass (stride 1 to 256) held by a warp's eight thread rows fall
// on 32 banks (tests/test_torch_hpipe.py checks every exchange at m =
// 512)
__device__ __forceinline__ int tile_slot(int r, int l) {
  return (r ^ ((r >> 3) & 1) ^ (((r >> 4) & 1) * 6)) * PREFIX_BLOCK_LANES
         + l;
}

// s DIT stages of half-lengths 2^ld .. on the thread's values; tws holds
// w_m^k, k < m / 2, as (8, m / 2).  The first pass (ld = 0) knows each
// slot's twiddle and skips w^0 = 1.
template <int s, bool first>
__device__ __forceinline__ void pass_stages(Fr (&v)[PREFIX_EL],
                                            const uint32_t* tws, int m,
                                            int t, int ld) {
  if (first) ld = 0;
#pragma unroll
  for (int q = 0; q < s; ++q) {
    const int tstep = m >> (ld + q + 1);   // m / (2 half)
#pragma unroll
    for (int idx = 0; idx < PREFIX_EL; ++idx) {
      const int e = idx & ((1 << s) - 1);
      if (e & (1 << q)) continue;
      const int elo = e & ((1 << q) - 1);
      Fr& u = v[idx];
      Fr& w = v[idx + (1 << q)];
      if (first && elo == 0) {
        const Fr wt = w;
        w = sub(u, wt);
        u = add(u, wt);
        continue;
      }
      const int grp = t * (PREFIX_EL >> s) + (idx >> s);
      const int j = (grp & ((1 << ld) - 1)) + (elo << ld);
      Fr tw;
#pragma unroll
      for (int qq = 0; qq < 8; ++qq) tw.v[qq] = tws[qq * (m / 2) + j * tstep];
      butterfly(u, w, tw);
    }
  }
}

// pass_stages for s <= PREFIX_LOG_EL, picked at run time (the clamps
// keep the instances a smaller PREFIX_LOG_EL never takes well-formed)
template <bool first>
__device__ __forceinline__ void run_pass(Fr (&v)[PREFIX_EL],
                                         const uint32_t* tws, int m, int t,
                                         int s, int ld) {
  constexpr int s3 = PREFIX_LOG_EL < 3 ? PREFIX_LOG_EL : 3;
  constexpr int s2 = PREFIX_LOG_EL < 2 ? PREFIX_LOG_EL : 2;
  if (s == 3) pass_stages<s3, first>(v, tws, m, t, ld);
  else if (s == 2) pass_stages<s2, first>(v, tws, m, t, ld);
  else pass_stages<1, first>(v, tws, m, t, ld);
}

__global__ void __launch_bounds__(PREFIX_TB)
ntt_prefix_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                  const uint32_t* __restrict__ tw,
                  const uint32_t* __restrict__ tin,
                  const uint32_t* __restrict__ tout, int B, int S, int L,
                  int m, int log_s, int rows, int mode) {
  extern __shared__ uint32_t sm[];  // twiddles (8, m/2), tile (8, rows, lanes)
  uint32_t* tws = sm;
  uint32_t* tile = sm + 4 * m;
  const int t = threadIdx.x / PREFIX_BLOCK_LANES;
  const int lane = threadIdx.x % PREFIX_BLOCK_LANES;
  for (int i = threadIdx.x; i < 4 * m; i += blockDim.x) {
    const int q = i / (m / 2), k = i % (m / 2);
    tws[i] = tw[(size_t)q * (S / 2) + (size_t)k * (S / m)];
  }
  const size_t sl = (size_t)S * L;       // values of one transform
  const size_t plane_out = (size_t)B * sl;
  const size_t plane_in = (mode & PREFIX_COMBINE) ? 3 * plane_out : plane_out;
  const int row0 = blockIdx.y * rows;
  const size_t col = (size_t)blockIdx.x * PREFIX_BLOCK_LANES + lane;
  const size_t b = blockIdx.z;
  Fr v[PREFIX_EL];
#pragma unroll
  for (int i = 0; i < PREFIX_EL; ++i) {
    const size_t src =
        (size_t)bitrev((unsigned)(row0 + PREFIX_EL * t + i), log_s) * L + col;
    if (mode & PREFIX_COMBINE) {
      Fr a, bb, c;
      load(a, x, plane_in, 3 * b * sl + src);
      load(bb, x, plane_in, (3 * b + 1) * sl + src);
      load(c, x, plane_in, (3 * b + 2) * sl + src);
      v[i] = sub(mul(a, bb), c);
    } else {
      load(v[i], x, plane_in, b * sl + src);
    }
    if (mode & PREFIX_SCALE_IN) {
      Fr w;
      load(w, tin, sl, src);
      v[i] = mul(v[i], w);
    }
  }
  __syncthreads();  // the twiddles
  const int log_m = __ffs(m) - 1;
  int s = log_m < PREFIX_LOG_EL ? log_m : PREFIX_LOG_EL, ld = 0;
  run_pass<true>(v, tws, m, t, s, 0);
  while (ld + s < log_m) {
    const int ld2 = ld + s;
    const int s2 = log_m - ld2 < PREFIX_LOG_EL ? log_m - ld2 : PREFIX_LOG_EL;
    const int plane = rows * PREFIX_BLOCK_LANES;
    __syncthreads();  // the last exchange's reads are done
#pragma unroll
    for (int i = 0; i < PREFIX_EL; ++i) {
      const int slot = tile_slot(pass_row(t, i, s, ld), lane);
#pragma unroll
      for (int q = 0; q < 8; ++q) tile[q * plane + slot] = v[i].v[q];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < PREFIX_EL; ++i) {
      const int slot = tile_slot(pass_row(t, i, s2, ld2), lane);
#pragma unroll
      for (int q = 0; q < 8; ++q) v[i].v[q] = tile[q * plane + slot];
    }
    s = s2;
    ld = ld2;
    run_pass<false>(v, tws, m, t, s, ld);
  }
#pragma unroll
  for (int i = 0; i < PREFIX_EL; ++i) {
    const size_t dst = (size_t)(row0 + pass_row(t, i, s, ld)) * L + col;
    store_out<PrefixMul>(y, plane_out, b * sl + dst, tout, sl, dst, v[i],
                         mode);
  }
}

// n (<= TW_V) consecutive words from p: one vector access where vec,
// else word by word
template <bool vec>
__device__ __forceinline__ void load_run(uint32_t (&w)[TW_V],
                                         const uint32_t* p, int n) {
  if (vec) {
    if (TW_V == 4) {
      const uint4 x = *reinterpret_cast<const uint4*>(p);
      w[0] = x.x; w[1] = x.y; w[2 % TW_V] = x.z; w[3 % TW_V] = x.w;
    } else {
      const uint2 x = *reinterpret_cast<const uint2*>(p);
      w[0] = x.x; w[1] = x.y;
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < TW_V; ++k) w[k] = k < n ? p[k] : 0u;
}

template <bool vec>
__device__ __forceinline__ void store_run(uint32_t* p,
                                          const uint32_t (&w)[TW_V], int n) {
  if (vec) {
    if (TW_V == 4)
      *reinterpret_cast<uint4*>(p) =
          make_uint4(w[0], w[1], w[2 % TW_V], w[3 % TW_V]);
    else
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    return;
  }
#pragma unroll
  for (int k = 0; k < TW_V; ++k)
    if (k < n) p[k] = w[k];
}

// vec: R and C multiples of TW_V and the tensors aligned to TW_V words
template <bool vec>
__global__ void __launch_bounds__(TW_TB)
ntt_twiddle_kernel(const uint32_t* __restrict__ a,
                   const uint32_t* __restrict__ inter,
                   uint32_t* __restrict__ out, int B, int R, int C) {
  __shared__ uint32_t tile[8][TW_C][TW_R + 1];   // [limb][column][row]
  const int c0 = blockIdx.x * TW_C, r0 = blockIdx.y * TW_R;
  const size_t rc = (size_t)R * C;
  const size_t plane = (size_t)B * rc;
  const size_t base = (size_t)blockIdx.z * rc;
  {  // loads, then products: row r, columns c .. c + TW_V - 1
    const int ri = threadIdx.x / (TW_C / TW_V);
    const int cl = threadIdx.x % (TW_C / TW_V) * TW_V;
    const int r = r0 + ri, c = c0 + cl;
    const int n = r < R && c < C ? min(TW_V, C - c) : 0;
    uint32_t va[8][TW_V], vw[8][TW_V];
    if (n > 0) {
      const size_t idx = (size_t)r * C + c;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        load_run<vec>(va[q], a + q * plane + base + idx, n);
        load_run<vec>(vw[q], inter + q * rc + idx, n);
      }
    }
#pragma unroll
    for (int k = 0; k < TW_V; ++k) {
      if (k < n) {
        Fr x, w;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          x.v[q] = va[q][k];
          w.v[q] = vw[q][k];
        }
        const Fr p = ZA_TW_MUL(x, w);
#pragma unroll
        for (int q = 0; q < 8; ++q) tile[q][cl + k][ri] = p.v[q];
      }
    }
  }
  __syncthreads();
  {  // column c, rows r .. r + TW_V - 1
    const int ci = threadIdx.x / (TW_R / TW_V);
    const int rl = threadIdx.x % (TW_R / TW_V) * TW_V;
    const int c = c0 + ci, r = r0 + rl;
    const int n = c < C && r < R ? min(TW_V, R - r) : 0;
    if (n > 0) {
      const size_t dst = base + (size_t)c * R + r;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        uint32_t w[TW_V];
#pragma unroll
        for (int k = 0; k < TW_V; ++k) w[k] = tile[q][ci][rl + k];
        store_run<vec>(out + q * plane + dst, w, n);
      }
    }
  }
}

inline bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

}  // namespace za

extern "C" {

// x -> y: (8, B, S, L) int32, the DIT stages of half-lengths h .. 2^(s-1)
// h along S (0 <= s <= TAIL_MAX_STAGES, 2^s h <= S); tw: (8, S/2).  mode:
// 0, or PREFIX_SCALE_OUT (tout (8, S L) plain values multiplied in on
// store; y (16, B, S, L) 16-bit plain limbs).  tout is not read without
// the flag.
int ntt_stage_fr(const void* x, void* y, const void* tw, const void* tout,
                 int B, int S, int L, int h, int s, int mode, void* stream) {
  if (!za::pow2(S) || !za::pow2(h) || s < 0 || s > za::TAIL_MAX_STAGES
      || ((long)h << s) > S || L < 1 || B < 0
      || (long)B * S * L >= (1L << 32)
      || (mode & ~za::PREFIX_SCALE_OUT) != 0)
    return (int)cudaErrorInvalidValue;
  const long total = (long)B * (S >> s) * L;
  if (total > 0) {
    const unsigned blocks =
        (unsigned)((total + za::TAIL_TB - 1) / za::TAIL_TB);
    const cudaStream_t st = (cudaStream_t)stream;
    const uint32_t* xi = (const uint32_t*)x;
    const uint32_t* twi = (const uint32_t*)tw;
    const uint32_t* ti = (const uint32_t*)tout;
    uint32_t* yo = (uint32_t*)y;
    switch (s) {
      case 0:
        za::ntt_tail_kernel<0><<<blocks, za::TAIL_TB, 0, st>>>(
            xi, yo, twi, ti, B, S, L, h, mode);
        break;
      case 1:
        za::ntt_tail_kernel<1><<<blocks, za::TAIL_TB, 0, st>>>(
            xi, yo, twi, ti, B, S, L, h, mode);
        break;
      case 2:
        za::ntt_tail_kernel<2><<<blocks, za::TAIL_TB, 0, st>>>(
            xi, yo, twi, ti, B, S, L, h, mode);
        break;
      default:
        za::ntt_tail_kernel<3><<<blocks, za::TAIL_TB, 0, st>>>(
            xi, yo, twi, ti, B, S, L, h, mode);
    }
  }
  return (int)cudaGetLastError();
}

// x -> y: (8, B, S, L) int32, natural order along S in; out, the rows
// bit-reversed along S and DIT stages 2..m applied.  tw: (8, S/2).
// m: a power of two, 2 <= m <= min(S, PREFIX_ROWS); S >= 8; L a multiple
// of PREFIX_LANES.  mode: PREFIX_SCALE_IN (tin (8, S L) Montgomery,
// multiplied in on load), PREFIX_COMBINE (x holds 3 B transforms, legs
// 3b, 3b + 1, 3b + 2 loaded as a b - c), PREFIX_SCALE_OUT (m = S; tout
// (8, S L) plain values multiplied in on store; y (16, B, S, L) 16-bit
// plain limbs).  tin / tout are not read without their flag.
int ntt_prefix_fr(const void* x, void* y, const void* tw, const void* tin,
                  const void* tout, int B, int S, int L, int m, int mode,
                  void* stream) {
  const int rows = S < za::PREFIX_ROWS ? S : za::PREFIX_ROWS;
  if (!za::pow2(S) || S < za::PREFIX_EL || !za::pow2(m) || m < 2
      || m > rows || L < 1 || L % za::PREFIX_LANES != 0 || B < 0
      || (mode & ~7) != 0 || ((mode & za::PREFIX_SCALE_OUT) && m != S))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  const bool exchange = m > za::PREFIX_EL;   // more than one pass
  const int smem =
      (4 * m + (exchange ? 8 * rows * za::PREFIX_BLOCK_LANES : 0))
      * (int)sizeof(uint32_t);
  cudaError_t rc = cudaFuncSetAttribute(
      za::ntt_prefix_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (rc != cudaSuccess) {
    cudaGetLastError();  // clear it, or the next launch reports it
    return (int)rc;
  }
  const int tb = rows * za::PREFIX_BLOCK_LANES / za::PREFIX_EL;
  const dim3 grid((unsigned)(L / za::PREFIX_BLOCK_LANES),
                  (unsigned)(S / rows), (unsigned)B);
  za::ntt_prefix_kernel<<<grid, tb, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (uint32_t*)y, (const uint32_t*)tw,
      (const uint32_t*)tin, (const uint32_t*)tout, B, S, L, m,
      __builtin_ctz((unsigned)S), rows, mode);
  return (int)cudaGetLastError();
}

// a: (8, B, R, C) int32; inter: (8, R, C) -> out: (8, B, C, R),
// out[b, c, r] = a[b, r, c] * inter[r, c]
int ntt_twiddle_fr(const void* a, const void* inter, void* out, int B,
                   int R, int C, void* stream) {
  if (B < 0 || R < 0 || C < 0) return (int)cudaErrorInvalidValue;
  if ((long)B * R * C > 0) {
    const dim3 grid((unsigned)((C + za::TW_C - 1) / za::TW_C),
                    (unsigned)((R + za::TW_R - 1) / za::TW_R), (unsigned)B);
    const uintptr_t align = 4 * za::TW_V - 1;
    const bool vec = R % za::TW_V == 0 && C % za::TW_V == 0
        && (((uintptr_t)a | (uintptr_t)inter | (uintptr_t)out) & align) == 0;
    if (vec)
      za::ntt_twiddle_kernel<true><<<grid, za::TW_TB, 0,
                                     (cudaStream_t)stream>>>(
          (const uint32_t*)a, (const uint32_t*)inter, (uint32_t*)out, B, R,
          C);
    else
      za::ntt_twiddle_kernel<false><<<grid, za::TW_TB, 0,
                                      (cudaStream_t)stream>>>(
          (const uint32_t*)a, (const uint32_t*)inter, (uint32_t*)out, B, R,
          C);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
