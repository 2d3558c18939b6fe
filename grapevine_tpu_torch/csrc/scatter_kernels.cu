// Fused encrypt+scatter write-back for the Path-ORAM bucket trees,
// hand-written for Hopper (sm_90a). One kernel body, two launches:
//
// gv_scatter_encrypt_rows_tiled (ring_kernel<256, 8, kScatter>) replaces
//   grapevine_tpu/oblivious/pallas_gather.py:scatter_encrypt_rows_tiled
//   (_scatter_tiled_kernel): up to 8 rows a step, the Pallas tile;
// gv_scatter_encrypt_rows (ring_kernel<128, 1, kScatter>) replaces
//   pallas_gather.py:scatter_encrypt_rows (_scatter_kernel): one row a
//   step, as one Pallas grid step.
// Both encrypt plaintext rows under (target bucket, write epoch) and
// write them into the trees in place, committing the nonce row in the
// same pass. A row whose owner flag is false is skipped whole: no
// keystream, no load, no store, no nonce. The reference's contract says
// such rows must not write (pallas_gather.py:366, :450); its kernels send
// them to the junk bucket n_padded - 1 only because a Pallas grid step
// always writes its out block, and that row is never read. So these
// kernels write only owned targets, and the junk bucket keeps its bytes.
//
// What bounds them, and the design: the row ring (row_ring.cuh), in its
// scatter direction — device-memory bytes, one read of each owned
// plaintext row and one write of its ciphertext, streamed by persistent
// CTAs through a shared-memory ring of TMA bulk copies with the
// keystream computed in between. A non-owner costs a one-byte read. A
// row wider than about 77 KB does not fit the ring three times; its
// launch is refused and the wrapper raises.
//
// Obliviousness: every global address depends only on flat_b and owner,
// which are public (the round's transcript and its bucket-owner map, or
// the flush's window ledger), as in the Pallas kernels.
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_ring.cuh"

namespace {

RingArgs scatter_args(const void* key, void* tree_idx, void* tree_val,
                      void* nonces, const void* flat_b, const void* owner,
                      const void* epoch, const void* new_pidx,
                      const void* new_pval) {
  RingArgs a{};
  a.key = (const uint32_t*)key;
  a.src_idx = (const uint32_t*)new_pidx;
  a.src_val = (const uint32_t*)new_pval;
  a.dst_idx = (uint32_t*)tree_idx;
  a.dst_val = (uint32_t*)tree_val;
  a.flat_b = (const int32_t*)flat_b;
  a.owner = (const uint8_t*)owner;
  a.epoch = (const uint32_t*)epoch;
  a.nonces = (uint32_t*)nonces;
  return a;
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 = launched). n_padded
// (the trees' row count) is part of the interface; no row past the
// owned targets is addressed.
int gv_scatter_encrypt_rows_tiled(const void* key, void* tree_idx,
                                  void* tree_val, void* nonces,
                                  const void* flat_b, const void* owner,
                                  const void* epoch, const void* new_pidx,
                                  const void* new_pval, int64_t rows,
                                  int64_t n_padded, int z, int zv, int rounds,
                                  void* stream) {
  (void)n_padded;
  return ring_launch<256, kTileRows, kScatter>(
      scatter_args(key, tree_idx, tree_val, nonces, flat_b, owner, epoch,
                   new_pidx, new_pval),
      rows, z, zv, rounds, stream);
}

int gv_scatter_encrypt_rows(const void* key, void* tree_idx, void* tree_val,
                            void* nonces, const void* flat_b,
                            const void* owner, const void* epoch,
                            const void* new_pidx, const void* new_pval,
                            int64_t rows, int64_t n_padded, int z, int zv,
                            int rounds, void* stream) {
  (void)n_padded;
  return ring_launch<kRowThreads, 1, kScatter>(
      scatter_args(key, tree_idx, tree_val, nonces, flat_b, owner, epoch,
                   new_pidx, new_pval),
      rows, z, zv, rounds, stream);
}

// out[4] = {grid, rows per step, dynamic shared memory bytes a CTA, CTAs
// an SM} of the launch at these shapes; `tiled` picks the launch.
int gv_scatter_launch_config(int tiled, int64_t rows, int z, int zv,
                             int* out) {
  return tiled ? ring_launch_config<256, kTileRows, kScatter>(rows, z, zv, out)
               : ring_launch_config<kRowThreads, 1, kScatter>(rows, z, zv, out);
}

}  // extern "C"
