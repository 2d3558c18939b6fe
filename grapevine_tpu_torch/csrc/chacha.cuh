// ChaCha block for the at-rest bucket cipher: the ONE copy of the core
// that every CUDA kernel of the port includes, so the gather, scatter
// and cipher kernels cannot drift apart.
//
// Replaces the in-kernel core of the TPU kernels,
// grapevine_tpu/oblivious/pallas_cipher.py:keystream_tile. State layout
// (the reference's oblivious/bucket_cipher.py):
//   [sigma(4) | key(8) | ctr = block index in the row | bucket |
//    epoch_lo | epoch_hi], `rounds` rounds, then the RFC 7539
// feed-forward. Rows use the j-major word order: word m of a row is
// state word m / nb of block m % nb, with nb = ceil(row_words / 16).
#pragma once
#include <stdint.h>

#define GV_HD __host__ __device__ __forceinline__

GV_HD uint32_t gv_rotl32(uint32_t x, int n) {
  return (x << n) | (x >> (32 - n));
}

#define GV_QR(a, b, c, d)                     \
  do {                                        \
    s[a] += s[b]; s[d] = gv_rotl32(s[d] ^ s[a], 16); \
    s[c] += s[d]; s[b] = gv_rotl32(s[b] ^ s[c], 12); \
    s[a] += s[b]; s[d] = gv_rotl32(s[d] ^ s[a], 8);  \
    s[c] += s[d]; s[b] = gv_rotl32(s[b] ^ s[c], 7);  \
  } while (0)

// One keystream block: out[j] = state word j after `rounds` rounds plus
// the input state. The caller places out[j] at row word j * nb + ctr.
GV_HD void gv_chacha_block(const uint32_t key[8], uint32_t ctr,
                           uint32_t bucket, uint32_t epoch_lo,
                           uint32_t epoch_hi, int rounds, uint32_t out[16]) {
  uint32_t init[16] = {0x61707865u, 0x3320646Eu, 0x79622D32u, 0x6B206574u,
                       key[0], key[1], key[2], key[3],
                       key[4], key[5], key[6], key[7],
                       ctr, bucket, epoch_lo, epoch_hi};
  uint32_t s[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i] = init[i];
  for (int r = 0; r < rounds; r += 2) {
    GV_QR(0, 4, 8, 12);
    GV_QR(1, 5, 9, 13);
    GV_QR(2, 6, 10, 14);
    GV_QR(3, 7, 11, 15);
    GV_QR(0, 5, 10, 15);
    GV_QR(1, 6, 11, 12);
    GV_QR(2, 7, 8, 13);
    GV_QR(3, 4, 9, 14);
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i] = s[i] + init[i];
}

#undef GV_QR

#ifdef __CUDACC__
// One WARP ciphers one row, with no shared memory: lane l computes
// ChaCha blocks c = l, l + 32, ... in registers and XORs word j of
// block c into row word m = j * nb + c. For each j the 32 lanes touch
// 32 consecutive row words, so the j-major layout makes every load and
// store coalesce with no staging. A row is split over two planes: words
// [0, z) live in *_idx, words [z, n_words) in *_val. `xor_ks` false
// copies the row unchanged (a never-written bucket, epoch (0, 0)); it
// is one value per row, so the branch is uniform across the warp.
__device__ __forceinline__ void gv_warp_row(
    const uint32_t key[8], uint32_t bucket, uint32_t epoch_lo,
    uint32_t epoch_hi, int rounds, bool xor_ks,
    const uint32_t* __restrict__ src_idx, const uint32_t* __restrict__ src_val,
    uint32_t* __restrict__ dst_idx, uint32_t* __restrict__ dst_val, int z,
    int n_words) {
  const int lane = threadIdx.x & 31;
  const int nb = (n_words + 15) / 16;
  for (int c0 = 0; c0 < nb; c0 += 32) {
    const int c = c0 + lane;
    uint32_t ks[16];
    if (xor_ks && c < nb) {
      gv_chacha_block(key, (uint32_t)c, bucket, epoch_lo, epoch_hi, rounds,
                      ks);
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) ks[j] = 0u;
    }
    if (c < nb) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int m = j * nb + c;
        if (m < z) {
          dst_idx[m] = src_idx[m] ^ ks[j];
        } else if (m < n_words) {
          dst_val[m - z] = src_val[m - z] ^ ks[j];
        }
      }
    }
  }
}
#endif
