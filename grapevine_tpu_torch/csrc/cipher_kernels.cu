// Fused ChaCha keystream + XOR over bucket rows, hand-written for Hopper
// (sm_90a).
//
// gv_cipher_rows (ring_kernel<256, 8, kCipher>) replaces the TPU kernel
//   grapevine_tpu/oblivious/pallas_cipher.py:cipher_rows_pallas
//   (_cipher_kernel): (pidx, pval) ^ keystream(bucket[r], epoch[r]) over
//   R contiguous rows, into fresh outputs (encrypt == decrypt); the
//   inputs are never written (pallas_cipher.py:89-98). Rows whose epoch
//   is (0, 0) (never-written buckets) are copied unchanged.
//
// What bounds it on an H100: device-memory bytes, each row read once and
// written once ((z + z*v) words each way, plus its bucket id and epoch).
// The design is the row ring (row_ring.cuh) in its cipher direction, up
// to 8 rows a step: persistent CTAs stream row r through a shared-memory
// ring of TMA bulk copies (the word path where a plane is not 16-byte
// aligned or not a 16-byte multiple), and the step's (row, ChaCha block)
// pairs are spread over all 256 threads, so the keystream of one step
// overlaps the loads of the next and the stores of the last. A row wider
// than about 77 KB does not fit the ring three times; its launch is
// refused and the wrapper raises.
//
// Obliviousness: every global address depends only on r. The only branch
// that depends on data is on the row's epoch, a public nonce.
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_ring.cuh"

namespace {

RingArgs cipher_args(const void* key, const void* bucket, const void* epoch,
                     const void* pidx, const void* pval, void* out_idx,
                     void* out_val) {
  RingArgs a{};
  a.key = (const uint32_t*)key;
  a.src_idx = (const uint32_t*)pidx;
  a.src_val = (const uint32_t*)pval;
  a.dst_idx = (uint32_t*)out_idx;
  a.dst_val = (uint32_t*)out_val;
  a.epoch = (const uint32_t*)epoch;
  a.bucket = (const uint32_t*)bucket;
  return a;
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 = launched).
int gv_cipher_rows(const void* key, const void* bucket, const void* epoch,
                   const void* pidx, const void* pval, void* out_idx,
                   void* out_val, int64_t rows, int z, int zv, int rounds,
                   void* stream) {
  return ring_launch<256, kTileRows, kCipher>(
      cipher_args(key, bucket, epoch, pidx, pval, out_idx, out_val), rows, z,
      zv, rounds, stream);
}

// out[4] = {grid, rows per step, dynamic shared memory bytes a CTA, CTAs
// an SM} of gv_cipher_rows's launch at these shapes.
int gv_cipher_launch_config(int64_t rows, int z, int zv, int* out) {
  return ring_launch_config<256, kTileRows, kCipher>(rows, z, zv, out);
}

}  // extern "C"
