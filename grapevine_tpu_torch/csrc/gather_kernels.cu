// Fused path-row gather+decrypt for the Path-ORAM bucket trees,
// hand-written for Hopper (sm_90a). Two designs of the contract, one per
// TPU kernel they replace (the write-back mirror, encrypt+scatter, is in
// scatter_kernels.cu):
//
// gv_gather_decrypt_rows_tiled (gather_tiled_kernel) replaces
//   grapevine_tpu/oblivious/pallas_gather.py:gather_decrypt_rows_tiled
//   (_gather_tiled_kernel), and gv_gather_decrypt_rows
//   (ring_kernel<128, 1, kGather>) replaces
//   pallas_gather.py:gather_decrypt_rows (_gather_kernel): fetch the rows
//   at public bucket ids flat_b from (tree_idx, tree_val, nonces) and
//   return them decrypted, into fresh outputs (rounds 0: a plain gather).
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
// - the ring (row_ring.cuh) in its gather direction, one row a step as
//   one Pallas grid step: persistent CTAs of 128 threads load tree row
//   flat_b[r] into a shared-memory ring with a TMA bulk copy, XOR in the
//   keystream under (flat_b[r], nonces[flat_b[r]]) with the row's ChaCha
//   blocks spread over the CTA, and bulk-store it to output row r, so
//   the keystream of one step overlaps the copies of its neighbours. A
//   row wider than about 77 KB does not fit the ring three times; its
//   launch is refused and the wrapper raises.
//
// Obliviousness: every global address depends only on flat_b, which is
// public (the round's transcript), and on r, as in the Pallas kernels.
// The only branch is on the row's public nonce (epoch 0 marks a
// never-written bucket whose keystream is the identity).
#include <cuda_runtime.h>
#include <stdint.h>

#include "chacha.cuh"
#include "row_ring.cuh"

namespace {

constexpr int kThreads = 256;

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

int smem_bytes(int z, int zv) { return 16 * ((z + zv + 15) / 16) * 4; }

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace

thread_local int gv_copy_path = -1;

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
  err = cudaGetLastError();
  if (err == cudaSuccess) gv_copy_path = vec ? 1 : 0;
  return (int)err;
}

int gv_gather_decrypt_rows(const void* key, const void* tree_idx,
                           const void* tree_val, const void* nonces,
                           const void* flat_b, void* out_idx, void* out_val,
                           int64_t rows, int z, int zv, int rounds,
                           void* stream) {
  RingArgs a{};
  a.key = (const uint32_t*)key;
  a.src_idx = (const uint32_t*)tree_idx;
  a.src_val = (const uint32_t*)tree_val;
  a.dst_idx = (uint32_t*)out_idx;
  a.dst_val = (uint32_t*)out_val;
  a.flat_b = (const int32_t*)flat_b;
  a.nonces = (uint32_t*)nonces;
  return ring_launch<kRowThreads, 1, kGather>(a, rows, z, zv, rounds, stream);
}

// out[4] = {grid, rows per step, dynamic shared memory bytes a CTA, CTAs
// an SM} of gv_gather_decrypt_rows's launch at these shapes.
int gv_gather_launch_config(int64_t rows, int z, int zv, int* out) {
  return ring_launch_config<kRowThreads, 1, kGather>(rows, z, zv, out);
}

// 1 if the calling thread's latest launch (any kernel of this library)
// moved 16-byte vectors, 0 if 4-byte words, -1 if it launched none.
int gv_last_copy_path(void) { return gv_copy_path; }

}  // extern "C"
