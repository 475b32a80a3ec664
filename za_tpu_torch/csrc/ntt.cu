// One radix-2 decimation-in-time stage of the NTT over Fr, in place.
//
// Replaces the stage loop of the reference's XLA NTT
// (za_tpu/engine/ntt_rns.py _ntt_core; the fused Pallas prefix
// pallas_ntt.sub_ntt_fused is off by default there and is not ported
// here).  x holds B transforms of n canonical Montgomery values, limb
// planes (8, B, n), already in bit-reversed order; tw holds the n/2
// twiddles w^k.  A stage of half-length h pairs i = 2h * g + j with
// i + h and sets (u, v) -> (u + w^(j n / 2h) v, u - w^(j n / 2h) v).
// One thread per butterfly, one launch per stage (log2 n per transform).
//
// Bound: bytes.  A stage reads and writes every value once (64 B per
// butterfly plus a twiddle) for one field multiplication (256 32-bit
// multiply-adds), below the card's ~5 multiply-adds per byte; the
// design keeps each butterfly's operands in registers and leaves the
// multi-stage shared-memory NTT to a later change.

#include "field.cuh"

namespace za {

__global__ void ntt_stage_kernel(uint32_t* __restrict__ x,
                                 const uint32_t* __restrict__ tw, int B,
                                 int n, int h) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t half_n = (size_t)n / 2;
  if (t >= (size_t)B * half_n) return;
  const size_t b = t / half_n, k = t - b * half_n;
  const size_t g = k / h, j = k - g * h;
  const size_t i0 = b * n + g * 2 * h + j, i1 = i0 + h;
  const size_t plane = (size_t)B * n;
  Fr u, v, w;
  load(u, x, plane, i0);
  load(v, x, plane, i1);
  load(w, tw, half_n, j * (half_n / h));
  v = mul(v, w);
  store(x, plane, i0, add(u, v));
  store(x, plane, i1, sub(u, v));
}

}  // namespace za

extern "C" {

// x: (8, B, n) int32 in place; tw: (8, n/2) int32; h: the stage's half
int ntt_stage_fr(void* x, const void* tw, int B, int n, int h,
                 void* stream) {
  const long total = (long)B * (n / 2);
  if (total > 0) {
    const int tb = 128;
    za::ntt_stage_kernel<<<(unsigned)((total + tb - 1) / tb), tb, 0,
                           (cudaStream_t)stream>>>(
        (uint32_t*)x, (const uint32_t*)tw, B, n, h);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
