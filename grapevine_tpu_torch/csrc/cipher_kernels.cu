// Fused ChaCha keystream + XOR over bucket rows, hand-written for Hopper
// (sm_90a).
//
// gv_cipher_rows (cipher_rows_kernel) replaces the TPU kernel
//   grapevine_tpu/oblivious/pallas_cipher.py:cipher_rows_pallas
//   (_cipher_kernel): (pidx, pval) ^= keystream(bucket, epoch) over R
//   contiguous rows, into fresh outputs (encrypt == decrypt). Rows whose
//   epoch is (0, 0) (never-written buckets) are copied unchanged.
//
// What bounds it on an H100: device-memory bytes. Each row is read once
// and written once ((z + z*v) words each way, plus its bucket id and
// epoch); ChaCha8 costs ~26 int32 operations a row word, which the card
// retires faster than its memory moves the word. So the design keeps the
// keystream off device memory entirely: one warp per row (eight rows per
// CTA), each lane building its ChaCha blocks in registers and XORing
// word j of every block -- 32 consecutive row words across the warp, so
// loads and stores coalesce straight from the j-major layout with no
// shared-memory staging (chacha.cuh:gv_warp_row). The only branch that
// depends on data is on the row's epoch, a public nonce.
#include <cuda_runtime.h>
#include <stdint.h>

#include "chacha.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerCta = kThreads / 32;

__global__ void __launch_bounds__(kThreads) cipher_rows_kernel(
    const uint32_t* __restrict__ key, const uint32_t* __restrict__ bucket,
    const uint32_t* __restrict__ epoch, const uint32_t* __restrict__ pidx,
    const uint32_t* __restrict__ pval, uint32_t* __restrict__ out_idx,
    uint32_t* __restrict__ out_val, int64_t rows, int z, int zv, int rounds) {
  const int64_t r = (int64_t)blockIdx.x * kRowsPerCta + (threadIdx.x >> 5);
  if (r >= rows) return;  // whole warps only
  uint32_t k[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) k[i] = __ldg(key + i);
  const uint32_t e_lo = epoch[2 * r];
  const uint32_t e_hi = epoch[2 * r + 1];
  gv_warp_row(k, bucket[r], e_lo, e_hi, rounds, (e_lo | e_hi) != 0u,
              pidx + r * z, pval + r * zv, out_idx + r * z, out_val + r * zv,
              z, z + zv);
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 = launched).
int gv_cipher_rows(const void* key, const void* bucket, const void* epoch,
                   const void* pidx, const void* pval, void* out_idx,
                   void* out_val, int64_t rows, int z, int zv, int rounds,
                   void* stream) {
  if (rows == 0) return 0;
  const unsigned ctas = (unsigned)((rows + kRowsPerCta - 1) / kRowsPerCta);
  cipher_rows_kernel<<<ctas, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)key, (const uint32_t*)bucket, (const uint32_t*)epoch,
      (const uint32_t*)pidx, (const uint32_t*)pval, (uint32_t*)out_idx,
      (uint32_t*)out_val, rows, z, zv, rounds);
  return (int)cudaGetLastError();
}

}  // extern "C"
