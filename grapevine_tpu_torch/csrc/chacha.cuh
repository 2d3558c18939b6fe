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
