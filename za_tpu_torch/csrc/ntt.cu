// The NTT over Fr: three kernels of the four-step transform
// (engine/ntt.py fourstep_core) and of the radix-2 one below it.
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
// block owns one segment of m rows x PREFIX_LANES lanes in dynamic shared
// memory (limb planes, (8, m, PREFIX_LANES)); it loads row
// bitrev_S(seg m + i) into slot i, so the reference's separate gather is
// the load, runs the log2(m) stages with a barrier between them, and
// writes rows seg m + i back.  Eight lanes of 4-byte limbs make each
// row's load and store one 32-byte sector per plane.  Twiddles are read
// as tw[j S / 2h] from the (L2-resident) table: the reference's
// repeat-each-twiddle-L-times tiles were a Mosaic layout workaround.
// Bound: operations, (S / m)(m / 2 log2(m) - (m - 1)) L multiplications
// per transform (the butterflies whose twiddle is not w^0 = 1; 256
// 32-bit multiply-adds each) against 64 B per value moved.
//
// ntt_twiddle_fr replaces XLA code of the reference's four-step
// (ntt_rns.py _fourstep_core: mont_mul_rns by the inter-factor twiddles,
// then swapaxes): out[b, c, r] = a[b, r, c] * inter[r, c], through a
// 32 x 32 shared-memory tile (one padding word per row, so the
// transposed reads hit 32 banks) so that the reads and the writes of
// every limb plane are coalesced.  Bound: bytes, one multiplication per
// 96 B moved.
//
// ntt_stage_fr replaces one stage of the reference's XLA stage loop
// (ntt_rns.py _ntt_core, _sub_ntt_axis1): one thread per butterfly, in
// place.  It runs the stages above m_fuse of a sub-NTT, and every stage
// of the radix-2 transform of domains below the four-step's minimum
// (L = 1).  Bound: bytes, 64 B per butterfly for one multiplication.

#include "field.cuh"

namespace za {

// lanes of one prefix block; engine/ntt.py's PREFIX_LANES, held equal
// to it by a test
constexpr int PREFIX_LANES = 8;
constexpr int PREFIX_TB = 512;   // threads of one prefix block, at most
constexpr int TT = 32;           // edge of a twiddle-transpose tile
constexpr int TT_ROWS = 8;       // thread rows of a transpose block

__device__ __forceinline__ unsigned bitrev(unsigned i, int bits) {
  return bits ? __brev(i) >> (32 - bits) : 0u;
}

__device__ __forceinline__ void butterfly(Fr& u, Fr& v, const Fr& w) {
  const Fr vt = mul(v, w);
  v = sub(u, vt);
  u = add(u, vt);
}

__global__ void ntt_stage_kernel(uint32_t* __restrict__ x,
                                 const uint32_t* __restrict__ tw, int B,
                                 int S, int L, int h) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t per = (size_t)(S / 2) * L;  // butterflies per transform
  if (t >= (size_t)B * per) return;
  const size_t b = t / per, r = t - b * per;
  const size_t k = r / L, l = r - k * L;
  const size_t g = k / h, j = k - g * h;
  const size_t i0 = (b * S + g * 2 * h + j) * L + l;
  const size_t i1 = i0 + (size_t)h * L;
  const size_t plane = (size_t)B * S * L;
  Fr u, v, w;
  load(u, x, plane, i0);
  load(v, x, plane, i1);
  load(w, tw, S / 2, j * (S / 2 / h));
  butterfly(u, v, w);
  store(x, plane, i0, u);
  store(x, plane, i1, v);
}

__global__ void __launch_bounds__(PREFIX_TB)
ntt_prefix_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                  const uint32_t* __restrict__ tw, int B, int S, int L,
                  int m, int log_s) {
  extern __shared__ uint32_t sm[];  // (8, m, PREFIX_LANES)
  const int tile = m * PREFIX_LANES;
  const int seg = blockIdx.y;
  const size_t plane = (size_t)B * S * L;
  const size_t col0 = (size_t)blockIdx.z * S * L
                      + (size_t)blockIdx.x * PREFIX_LANES;
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    const int i = e / PREFIX_LANES, l = e % PREFIX_LANES;
    const size_t src = col0 + (size_t)bitrev(seg * m + i, log_s) * L + l;
#pragma unroll
    for (int q = 0; q < 8; ++q) sm[q * tile + e] = x[q * plane + src];
  }
  __syncthreads();
  for (int h = 1; h < m; h <<= 1) {
    const int step = S / (2 * h);
    for (int p = threadIdx.x; p < tile / 2; p += blockDim.x) {
      const int l = p % PREFIX_LANES, k = p / PREFIX_LANES;
      const int g = k / h, j = k - g * h;
      const int e0 = (2 * h * g + j) * PREFIX_LANES + l;
      const int e1 = e0 + h * PREFIX_LANES;
      Fr u, v, w;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        u.v[q] = sm[q * tile + e0];
        v.v[q] = sm[q * tile + e1];
      }
      load(w, tw, S / 2, (size_t)j * step);
      butterfly(u, v, w);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        sm[q * tile + e0] = u.v[q];
        sm[q * tile + e1] = v.v[q];
      }
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    const int i = e / PREFIX_LANES, l = e % PREFIX_LANES;
    const size_t dst = col0 + (size_t)(seg * m + i) * L + l;
#pragma unroll
    for (int q = 0; q < 8; ++q) y[q * plane + dst] = sm[q * tile + e];
  }
}

__global__ void __launch_bounds__(TT * TT_ROWS)
ntt_twiddle_kernel(const uint32_t* __restrict__ a,
                   const uint32_t* __restrict__ inter,
                   uint32_t* __restrict__ out, int B, int R, int C) {
  __shared__ uint32_t tile[8][TT][TT + 1];
  const int c0 = blockIdx.x * TT, r0 = blockIdx.y * TT;
  const size_t rc = (size_t)R * C;
  const size_t plane = (size_t)B * rc;
  const size_t base = (size_t)blockIdx.z * rc;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int i = ty; i < TT; i += TT_ROWS) {
    const int r = r0 + i, c = c0 + tx;
    if (r < R && c < C) {
      const size_t idx = (size_t)r * C + c;
      Fr v, w;
      load(v, a, plane, base + idx);
      load(w, inter, rc, idx);
      v = mul(v, w);
#pragma unroll
      for (int q = 0; q < 8; ++q) tile[q][i][tx] = v.v[q];
    }
  }
  __syncthreads();
  for (int i = ty; i < TT; i += TT_ROWS) {
    const int c = c0 + i, r = r0 + tx;
    if (r < R && c < C) {
      const size_t dst = base + (size_t)c * R + r;
#pragma unroll
      for (int q = 0; q < 8; ++q) out[q * plane + dst] = tile[q][tx][i];
    }
  }
}

inline bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

}  // namespace za

extern "C" {

// x: (8, B, S, L) int32 in place; tw: (8, S/2) int32; h: the stage's half
int ntt_stage_fr(void* x, const void* tw, int B, int S, int L, int h,
                 void* stream) {
  if (!za::pow2(S) || !za::pow2(h) || h >= S || L < 1 || B < 0)
    return (int)cudaErrorInvalidValue;
  const long total = (long)B * (S / 2) * L;
  if (total > 0) {
    const int tb = 128;
    za::ntt_stage_kernel<<<(unsigned)((total + tb - 1) / tb), tb, 0,
                           (cudaStream_t)stream>>>(
        (uint32_t*)x, (const uint32_t*)tw, B, S, L, h);
  }
  return (int)cudaGetLastError();
}

// x -> y: (8, B, S, L) int32, natural order along S in; out, the rows
// bit-reversed along S and DIT stages 2..m applied.  tw: (8, S/2).
// m: a power of two, 2 <= m <= S; L a multiple of PREFIX_LANES.
int ntt_prefix_fr(const void* x, void* y, const void* tw, int B, int S,
                  int L, int m, void* stream) {
  if (!za::pow2(S) || !za::pow2(m) || m < 2 || m > S || L < 1
      || L % za::PREFIX_LANES != 0 || B < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  const int smem = 8 * m * za::PREFIX_LANES * (int)sizeof(uint32_t);
  cudaError_t rc = cudaFuncSetAttribute(
      za::ntt_prefix_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (rc != cudaSuccess) {
    cudaGetLastError();  // clear it, or the next launch reports it
    return (int)rc;
  }
  const int butterflies = m * za::PREFIX_LANES / 2;
  const int tb = butterflies < za::PREFIX_TB ? butterflies : za::PREFIX_TB;
  const dim3 grid((unsigned)(L / za::PREFIX_LANES), (unsigned)(S / m),
                  (unsigned)B);
  za::ntt_prefix_kernel<<<grid, tb, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (uint32_t*)y, (const uint32_t*)tw, B, S, L, m,
      __builtin_ctz((unsigned)S));
  return (int)cudaGetLastError();
}

// a: (8, B, R, C) int32; inter: (8, R, C) -> out: (8, B, C, R),
// out[b, c, r] = a[b, r, c] * inter[r, c]
int ntt_twiddle_fr(const void* a, const void* inter, void* out, int B,
                   int R, int C, void* stream) {
  if (B < 0 || R < 0 || C < 0) return (int)cudaErrorInvalidValue;
  if ((long)B * R * C > 0) {
    const dim3 grid((unsigned)((C + za::TT - 1) / za::TT),
                    (unsigned)((R + za::TT - 1) / za::TT), (unsigned)B);
    za::ntt_twiddle_kernel<<<grid, dim3(za::TT, za::TT_ROWS), 0,
                             (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)inter, (uint32_t*)out, B, R, C);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
