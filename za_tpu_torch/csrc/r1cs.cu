// The R1CS sparse matvec over Fr: the Az, Bz and Cz legs of h(x) in one
// launch (engine/r1cs.py matvec).
//
// r1cs_matvec_fr replaces XLA code of the reference
// (za_tpu/engine/engine.py _matvec_rns_jit: channel products by the
// gathered witness, jax.ops.segment_sum over the rows, a channel fold and
// a bound-reset product).  The three matrices are one CSR over 3 m output
// rows (leg k's rows at k m .. k m + rows_k, the rest empty); its
// coefficients are c R^2 mod r, so one Montgomery product with the plain
// witness word z gives c z in Montgomery form, and the output is the
// l32 (8, 3, m) leg buffer that the NTTs take, canonical.  Rows sum by
// modular adds, so any order gives the same value.  The witness comes as
// uploaded, (16, nv) 16-bit plain limbs in int32: the kernel packs each
// pair of limbs into a word as it loads them, so nothing runs before it.
//
// Work split: one thread per row for rows of at most MV_WARP_ROW entries
// (the multiplier chain has one or two); the longer rows of a warp's 32
// rows are then taken by the whole warp one after another, each lane
// summing every 32nd entry, the lanes joined by a shuffle tree.
// Bound: bytes, 36 B per entry (coefficient and column) plus the row
// offsets, the witness read once (64 B a variable) and the legs written
// once, against one product per entry.  At the 2^17 chain it runs within
// twice its bound (NVIDIA H100 80GB HBM3, 700 W; device time from
// tools/torch_hpipe_sweep.py), so its design stays; what holds it is the
// three memory round trips of an entry (offsets, column, witness).

#include "field.cuh"

namespace za {

constexpr int MV_TB = 256;        // threads of one block
constexpr int MV_WARP_ROW = 16;   // longer rows go to one warp

__device__ __forceinline__ Fr mv_term(const uint32_t* __restrict__ coeffs,
                                      size_t nnz, const int* __restrict__ cols,
                                      const uint32_t* __restrict__ z,
                                      size_t nv, int k) {
  Fr c, x;
  load(c, coeffs, nnz, (size_t)k);
  const size_t j = (size_t)cols[k];
#pragma unroll
  for (int q = 0; q < 8; ++q)   // two 16-bit witness limbs a word
    x.v[q] = (z[(2 * q) * nv + j] & 0xffffu) | (z[(2 * q + 1) * nv + j] << 16);
  return mul(c, x);
}

__global__ void __launch_bounds__(MV_TB)
r1cs_matvec_kernel(const int* __restrict__ row_ptr,
                   const int* __restrict__ cols,
                   const uint32_t* __restrict__ coeffs, int nnz,
                   const uint32_t* __restrict__ z, int nv,
                   uint32_t* __restrict__ out, int rows) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  int beg = 0, end = 0;
  if (r < rows) {
    beg = row_ptr[r];
    end = row_ptr[r + 1];
  }
  const bool wide = r < rows && end - beg > MV_WARP_ROW;
  if (r < rows && !wide) {
    Fr acc = zero<Fr>();
    for (int k = beg; k < end; ++k)
      acc = add(acc, mv_term(coeffs, nnz, cols, z, nv, k));
    store(out, (size_t)rows, (size_t)r, acc);
  }
  // the warp's wide rows, one at a time, every lane on each
  unsigned todo = __ballot_sync(0xffffffffu, wide);
  while (todo) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1;
    const int b = __shfl_sync(0xffffffffu, beg, src);
    const int e = __shfl_sync(0xffffffffu, end, src);
    Fr acc = zero<Fr>();
    for (int k = b + lane; k < e; k += 32)
      acc = add(acc, mv_term(coeffs, nnz, cols, z, nv, k));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      Fr o;
#pragma unroll
      for (int q = 0; q < 8; ++q)
        o.v[q] = __shfl_down_sync(0xffffffffu, acc.v[q], off);
      acc = add(acc, o);
    }
    if (lane == 0) store(out, (size_t)rows, (size_t)(r - lane + src), acc);
  }
}

}  // namespace za

extern "C" {

// row_ptr: (rows + 1,) int32; cols: (nnz,) int32; coeffs: (8, nnz) int32
// holding c R^2 mod r; z: (16, nv) int32 16-bit plain limbs of the
// witness -> out: (8, rows) int32 Montgomery row sums, every row written.
int r1cs_matvec_fr(const void* row_ptr, const void* cols, const void* coeffs,
                   int nnz, const void* z, int nv, void* out, int rows,
                   void* stream) {
  if (rows < 0 || nnz < 0 || nv < 0) return (int)cudaErrorInvalidValue;
  if (rows > 0) {
    const unsigned blocks = (unsigned)((rows + za::MV_TB - 1) / za::MV_TB);
    za::r1cs_matvec_kernel<<<blocks, za::MV_TB, 0, (cudaStream_t)stream>>>(
        (const int*)row_ptr, (const int*)cols, (const uint32_t*)coeffs, nnz,
        (const uint32_t*)z, nv, (uint32_t*)out, rows);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
