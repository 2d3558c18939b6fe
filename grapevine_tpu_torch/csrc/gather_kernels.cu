// Fused path-row gather+decrypt for the Path-ORAM bucket trees,
// hand-written for Hopper (sm_90a). Two designs of the contract, one per
// TPU kernel they replace (the write-back mirror, encrypt+scatter, is in
// scatter_kernels.cu):
//
// gv_gather_decrypt_rows_tiled (gather_tiled_kernel) replaces
//   grapevine_tpu/oblivious/pallas_gather.py:gather_decrypt_rows_tiled
//   (_gather_tiled_kernel), and gv_gather_decrypt_rows
//   (gather_rows_kernel) replaces pallas_gather.py:gather_decrypt_rows
//   (_gather_kernel): fetch the rows at public bucket ids flat_b from
//   (tree_idx, tree_val, nonces) and return them decrypted.
//
// What bounds them on an H100: device-memory bytes. Each row moves
// (z + z*v) words in and out once; ChaCha8 costs ~26 int32 operations a
// row word, which the card retires faster than its memory moves the
// word, so the bytes decide (PERF.md has the measured times beside both
// bounds). Both designs keep every extra byte off device memory: the
// keystream never touches it, and the row's ciphertext is read once.
// - gather_tiled_kernel: one CTA per row builds that row's 16*nb
//   keystream words in shared memory (one thread per ChaCha block,
//   j-major placement, conflict-free stores) and then streams the row
//   through once, coalesced, in 16-byte vectors where the layout allows.
// - gather_rows_kernel: one WARP per row, eight rows per CTA, no shared
//   memory: each lane keeps its ChaCha blocks in registers and, word j of
//   every block being 32 consecutive row words across the warp, loads
//   and stores coalesce straight from the j-major layout
//   (chacha.cuh:gv_warp_row).
//
// Obliviousness: every global address depends only on flat_b, which is
// public (the round's transcript), as in the Pallas kernels. The only
// branch is on the row's public nonce (epoch 0 marks a never-written
// bucket whose keystream is the identity).
#include <cuda_runtime.h>
#include <stdint.h>

#include "chacha.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerCta = kThreads / 32;  // one-row kernels: a warp a row

// Keystream of one row into shared memory: ks[j * nb + c] = word j of
// block c. Threads take blocks c = tid, tid + blockDim, ...
__device__ __forceinline__ void row_keystream_smem(
    const uint32_t* __restrict__ key, uint32_t bucket, uint32_t e_lo,
    uint32_t e_hi, int rounds, int nb, uint32_t* ks) {
  uint32_t k[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) k[i] = __ldg(key + i);
  for (int c = threadIdx.x; c < nb; c += blockDim.x) {
    uint32_t out[16];
    gv_chacha_block(k, (uint32_t)c, bucket, e_lo, e_hi, rounds, out);
#pragma unroll
    for (int j = 0; j < 16; ++j) ks[j * nb + c] = out[j];
  }
}

// dst[m] = src[m] ^ (xor ? ks[m] : 0) for m in [0, n): 16-byte vectors
// when `vec` (n % 4 == 0 and every pointer 16-byte aligned), else words.
__device__ __forceinline__ void stream_row(
    const uint32_t* __restrict__ src, uint32_t* __restrict__ dst,
    const uint32_t* ks, bool xor_ks, int n, bool vec) {
  if (vec) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    const uint4* k4 = reinterpret_cast<const uint4*>(ks);
    for (int q = threadIdx.x; q < n / 4; q += blockDim.x) {
      uint4 x = s4[q];
      if (xor_ks) {
        const uint4 y = k4[q];
        x.x ^= y.x; x.y ^= y.y; x.z ^= y.z; x.w ^= y.w;
      }
      d4[q] = x;
    }
  } else {
    for (int m = threadIdx.x; m < n; m += blockDim.x) {
      dst[m] = src[m] ^ (xor_ks ? ks[m] : 0u);
    }
  }
}

__global__ void __launch_bounds__(kThreads) gather_tiled_kernel(
    const uint32_t* __restrict__ key, const uint32_t* __restrict__ tree_idx,
    const uint32_t* __restrict__ tree_val, const uint32_t* __restrict__ nonces,
    const int32_t* __restrict__ flat_b, uint32_t* __restrict__ out_idx,
    uint32_t* __restrict__ out_val, int z, int zv, int rounds, bool vec) {
  extern __shared__ __align__(16) uint32_t ks[];
  const int64_t r = blockIdx.x;
  const int64_t row = flat_b[r];
  const uint32_t e_lo = nonces[2 * row];
  const uint32_t e_hi = nonces[2 * row + 1];
  const int nb = (z + zv + 15) / 16;
  // uniform across the CTA: the nonce is one value per row
  const bool written = rounds > 0 && (e_lo | e_hi) != 0u;
  if (written) {
    row_keystream_smem(key, (uint32_t)row, e_lo, e_hi, rounds, nb, ks);
    __syncthreads();
  }
  stream_row(tree_idx + row * z, out_idx + r * z, ks, written, z, false);
  stream_row(tree_val + row * zv, out_val + r * zv, ks + z, written, zv, vec);
}

// One warp per row: row r = CTA * kRowsPerCta + warp.
__global__ void __launch_bounds__(kThreads) gather_rows_kernel(
    const uint32_t* __restrict__ key, const uint32_t* __restrict__ tree_idx,
    const uint32_t* __restrict__ tree_val, const uint32_t* __restrict__ nonces,
    const int32_t* __restrict__ flat_b, uint32_t* __restrict__ out_idx,
    uint32_t* __restrict__ out_val, int64_t rows, int z, int zv, int rounds) {
  const int64_t r = (int64_t)blockIdx.x * kRowsPerCta + (threadIdx.x >> 5);
  if (r >= rows) return;  // whole warps only
  uint32_t k[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) k[i] = __ldg(key + i);
  const int64_t row = flat_b[r];
  const uint32_t e_lo = nonces[2 * row];
  const uint32_t e_hi = nonces[2 * row + 1];
  const bool written = rounds > 0 && (e_lo | e_hi) != 0u;
  gv_warp_row(k, (uint32_t)row, e_lo, e_hi, rounds, written,
              tree_idx + row * z, tree_val + row * zv, out_idx + r * z,
              out_val + r * zv, z, z + zv);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

int smem_bytes(int z, int zv) { return 16 * ((z + zv + 15) / 16) * 4; }

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

unsigned row_ctas(int64_t rows) {
  return (unsigned)((rows + kRowsPerCta - 1) / kRowsPerCta);
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 = launched).
int gv_gather_decrypt_rows_tiled(const void* key, const void* tree_idx,
                      const void* tree_val, const void* nonces,
                      const void* flat_b, void* out_idx, void* out_val,
                      int64_t rows, int z, int zv, int rounds, void* stream) {
  if (rows == 0) return 0;
  const int smem = smem_bytes(z, zv);
  cudaError_t err = allow_smem(gather_tiled_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  // (z % 4 == 0) keeps ks + z 16-byte aligned for the vector path
  const bool vec = (z % 4 == 0) && (zv % 4 == 0) && aligned16(tree_val) &&
                   aligned16(out_val);
  gather_tiled_kernel<<<(unsigned)rows, kThreads, smem,
                          (cudaStream_t)stream>>>(
      (const uint32_t*)key, (const uint32_t*)tree_idx,
      (const uint32_t*)tree_val, (const uint32_t*)nonces,
      (const int32_t*)flat_b, (uint32_t*)out_idx, (uint32_t*)out_val, z, zv,
      rounds, vec);
  return (int)cudaGetLastError();
}

int gv_gather_decrypt_rows(const void* key, const void* tree_idx,
                           const void* tree_val, const void* nonces,
                           const void* flat_b, void* out_idx, void* out_val,
                           int64_t rows, int z, int zv, int rounds,
                           void* stream) {
  if (rows == 0) return 0;
  gather_rows_kernel<<<row_ctas(rows), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)key, (const uint32_t*)tree_idx,
      (const uint32_t*)tree_val, (const uint32_t*)nonces,
      (const int32_t*)flat_b, (uint32_t*)out_idx, (uint32_t*)out_val, rows, z,
      zv, rounds);
  return (int)cudaGetLastError();
}

}  // extern "C"
