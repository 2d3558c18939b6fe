// Fused encrypt+scatter write-back for the Path-ORAM bucket trees,
// hand-written for Hopper (sm_90a). One kernel body, two launches:
//
// gv_scatter_encrypt_rows_tiled (scatter_kernel<256, 8>) replaces
//   grapevine_tpu/oblivious/pallas_gather.py:scatter_encrypt_rows_tiled
//   (_scatter_tiled_kernel): up to 8 rows a step, the Pallas tile;
// gv_scatter_encrypt_rows (scatter_kernel<128, 1>) replaces
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
// What bounds them on an H100: device-memory bytes, one read of each
// owned plaintext row and one write of its ciphertext. ChaCha8 costs ~26
// int32 operations a row word, which the card retires faster than its
// memory moves the word, but not by much (the ops bound is ~60% of the
// bytes bound), so the keystream has to overlap the streaming:
// - persistent CTAs (a grid of the card's SMs times the CTAs that fit on
//   one) walk the rows r = blockIdx.x + k * gridDim.x; a non-owner costs
//   a one-byte read;
// - each step's owned rows go through shared memory in a ring of
//   kStages buffers: a 1-D TMA bulk copy (cp.async.bulk) loads the
//   plaintext row and completes on an mbarrier, the CTA XORs the
//   keystream into it in place, and a second bulk copy stores the
//   ciphertext to the tree. The ring keeps the loads of the next step
//   and the stores of the last ones in flight while this step computes;
// - every thread takes ChaCha blocks in the ChaCha phase: the step's
//   (row, block) pairs are spread over the CTA, so 8 records rows (65
//   blocks each) fill a 256-thread step; one warp, the producer, also
//   finds the next step's owned rows and issues its copies;
// - rows whose planes are not 16-byte multiples (small geometries) take
//   a word path through the same ring, loaded and stored by the threads.
// A row must fit kStages times in an SM's 227 KB of shared memory (rows
// up to ~75 KB at 3 stages; the widest production row, a mailbox
// bucket, is 24 KB); a wider row's launch is refused and the wrapper
// raises.
//
// Obliviousness: every global address depends only on flat_b and owner,
// which are public (the round's transcript and its bucket-owner map, or
// the flush's window ledger), as in the Pallas kernels.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <utility>

#include "chacha.cuh"

namespace {

// The ring's depth, B6's rows a step and B5's CTA size. A sweep of
// stages 2/3/4 x rows 2/4/8 x B5 threads 128/256 on an H100 found no
// variant faster by more than run-to-run noise (PERF.md §6).
constexpr int kStages = 3;
static_assert(kStages >= 2, "the ring needs a stage loading and one computing");
constexpr int kTileRows = 8;     // B6 (pallas_gather.py:372)
constexpr int kRowThreads = 128;  // B5
// shared memory a CTA's ring may take: half of an SM's 227 KB, so at
// least two CTAs share an SM
constexpr int kRingBytes = 112 * 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Spin until the phase with parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA 1-D bulk copy global -> shared, completing `bytes` on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// TMA 1-D bulk copy shared -> global, in this thread's open bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::
                   "l"(reinterpret_cast<uint64_t>(dst)),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Wait until at most N of this thread's bulk groups still read shared
// memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Order this thread's generic-proxy shared-memory writes before later
// async-proxy (TMA) accesses.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Producer warp: the next (at most t) owned rows of this CTA's sequence
// r = blockIdx.x + k * gridDim.x, from k = cursor, into src (row) and
// dst (target bucket). Returns their count; every lane gets the same
// count and cursor. A warp ballots 32 candidates at a time.
__device__ __forceinline__ int next_owned(const uint8_t* __restrict__ owner,
                                          const int32_t* __restrict__ flat_b,
                                          int64_t rows, int64_t& cursor, int t,
                                          int64_t* src, int64_t* dst) {
  const int lane = threadIdx.x & 31;
  const int64_t g = blockIdx.x, grid = gridDim.x;
  int n = 0;
  while (n < t && g + cursor * grid < rows) {
    const int64_t r = g + (cursor + lane) * grid;
    const bool in = r < rows;
    // both reads at once: flat_b is public, read for non-owners too
    const int32_t b = in ? flat_b[r] : 0;
    const bool own = in && owner[r] != 0;
    const unsigned m = __ballot_sync(0xffffffffu, own);
    const int rank = __popc(m & ((1u << lane) - 1u));
    const int take = min(__popc(m), t - n);
    if (own && rank < take) {
      src[n + rank] = r;
      dst[n + rank] = b;
    }
    if (take < __popc(m)) {
      // resume just past the last row taken
      cursor += __ffs(__ballot_sync(0xffffffffu, own && rank == take - 1));
    } else {
      cursor += 32;
    }
    n += take;
  }
  return n;
}

// kThreads threads a CTA; a step holds at most kMaxRows owned rows
// (t at run time, from the shared memory a row takes).
template <int kThreads, int kMaxRows>
__global__ void __launch_bounds__(kThreads) scatter_kernel(
    const uint32_t* __restrict__ key, uint32_t* __restrict__ tree_idx,
    uint32_t* __restrict__ tree_val, uint32_t* __restrict__ nonces,
    const int32_t* __restrict__ flat_b, const uint8_t* __restrict__ owner,
    const uint32_t* __restrict__ epoch, const uint32_t* __restrict__ new_pidx,
    const uint32_t* __restrict__ new_pval, int64_t rows, int z, int zv,
    int rounds, int t, bool bulk) {
  extern __shared__ __align__(16) uint32_t ring[];  // [kStages][t][wp]
  __shared__ int64_t s_src[kStages][kMaxRows];
  __shared__ int64_t s_dst[kStages][kMaxRows];
  __shared__ int s_cnt[kStages];
  __shared__ __align__(8) uint64_t s_full[kStages];

  const int w = z + zv;
  const int wp = (w + 3) & ~3;  // row slots stay 16-byte aligned
  const int nb = (w + 15) / 16;
  const uint32_t e_lo = epoch[0];
  const uint32_t e_hi = epoch[1];
  // epoch (0, 0): the identity keystream, as bucket_cipher.row_keystream
  const bool xor_ks = (e_lo | e_hi) != 0u;
  uint32_t k[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) k[i] = __ldg(key + i);
  // the last warp produces: it has the fewest ChaCha pairs in a step
  const bool producer = (threadIdx.x >> 5) == kThreads / 32 - 1;
  const bool issuer = threadIdx.x == kThreads - 32;
  int64_t cursor = 0;

  // Producer: find stage s's rows and start their loads. The buffer
  // was last read by the stores of the step kStages back; this thread
  // committed them, and at most kStages - 2 later groups may be open.
  auto fill = [&](int s) {
    const int n = next_owned(owner, flat_b, rows, cursor, t, s_src[s], s_dst[s]);
    __syncwarp();
    if (issuer) {
      s_cnt[s] = n;
      if (bulk && n > 0) {
        bulk_wait_read<kStages - 2>();
        mbar_expect_tx(&s_full[s], (uint32_t)(n * w * 4));
        for (int j = 0; j < n; ++j) {
          uint32_t* row = ring + (s * t + j) * wp;
          bulk_load(row, new_pidx + s_src[s][j] * z, z * 4, &s_full[s]);
          bulk_load(row + z, new_pval + s_src[s][j] * zv, zv * 4, &s_full[s]);
        }
      }
    }
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&s_full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (producer) fill(0);
  __syncthreads();

  for (int i = 0;; ++i) {
    const int s = i % kStages;
    const int n = s_cnt[s];  // uniform: written before the last barrier
    if (n == 0) break;
    if (producer) fill((i + 1) % kStages);
    uint32_t* stage = ring + s * t * wp;
    if (bulk) {
      mbar_wait(&s_full[s], (uint32_t)((i / kStages) & 1));
    } else {
      for (int q = threadIdx.x; q < n * w; q += kThreads) {
        const int j = q / w, m = q - j * w;
        const int64_t r = s_src[s][j];
        stage[j * wp + m] = m < z ? new_pidx[r * z + m] : new_pval[r * zv + (m - z)];
      }
      __syncthreads();
    }
    if (xor_ks) {
      // (row j, ChaCha block c) pairs over every thread; word jj of
      // block c is row word jj * nb + c (j-major), so a warp's lanes
      // touch consecutive words: conflict-free
      for (int p = threadIdx.x; p < n * nb; p += kThreads) {
        const int j = p / nb, c = p - j * nb;
        uint32_t ks[16];
        gv_chacha_block(k, (uint32_t)c, (uint32_t)s_dst[s][j], e_lo, e_hi,
                        rounds, ks);
        uint32_t* row = stage + j * wp;
#pragma unroll
        for (int jj = 0; jj < 16; ++jj) {
          const int m = jj * nb + c;
          if (m < w) row[m] ^= ks[jj];
        }
      }
    }
    if (bulk) fence_proxy_async();
    __syncthreads();
    if (bulk) {
      if (issuer) {
        for (int j = 0; j < n; ++j) {
          const int64_t b = s_dst[s][j];
          const uint32_t* row = stage + j * wp;
          bulk_store(tree_idx + b * z, row, z * 4);
          bulk_store(tree_val + b * zv, row + z, zv * 4);
        }
        bulk_commit();
      }
    } else {
      for (int q = threadIdx.x; q < n * w; q += kThreads) {
        const int j = q / w, m = q - j * w;
        const int64_t b = s_dst[s][j];
        const uint32_t x = stage[j * wp + m];
        if (m < z) {
          tree_idx[b * z + m] = x;
        } else {
          tree_val[b * zv + (m - z)] = x;
        }
      }
    }
    if (threadIdx.x < n) {
      const int64_t b = s_dst[s][threadIdx.x];
      nonces[2 * b] = e_lo;
      nonces[2 * b + 1] = e_hi;
    }
    __syncthreads();
  }
  // the ring is this CTA's shared memory: no store may outlive it
  if (bulk && issuer) bulk_wait_all();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

struct Plan {
  int grid, rows_per_step, smem_bytes, ctas_per_sm;
};

// What a launch at one row width needs, apart from the row count.
struct Fit {
  int rows_per_step, smem_bytes, ctas_per_sm, sms;
};

// Rows per step from the ring's budget, and the CTAs that fit on an SM
// (occupancy from registers, shared memory and threads). The kernel's
// dynamic shared memory limit is raised to the most the device allows,
// the same for every row width, so one width's fit never refuses
// another's launch.
template <int kThreads, int kMaxRows>
cudaError_t fit(int dev, int row_bytes, Fit* f) {
  auto kernel = scatter_kernel<kThreads, kMaxRows>;
  const int t = std::max(1, std::min(kMaxRows, kRingBytes / (kStages * row_bytes)));
  const int smem = kStages * t * row_bytes;
  int optin = 0, sms = 0, per_sm = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (smem + (int)attr.sharedSizeBytes > optin) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin - (int)attr.sharedSizeBytes);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm == 0) return cudaErrorInvalidConfiguration;
  *f = Fit{t, smem, per_sm, sms};
  return cudaSuccess;
}

// The launch: the fit, found once per (device, row width) and kept, then
// as many CTAs as fit on the card at once, never more than there are rows.
template <int kThreads, int kMaxRows>
cudaError_t plan(int64_t rows, int z, int zv, Plan* p) {
  static std::mutex mu;
  static std::map<std::pair<int, int>, Fit> fits;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const int row_bytes = 4 * ((z + zv + 3) & ~3);
  Fit f;
  {
    std::lock_guard<std::mutex> lock(mu);
    const auto it = fits.find({dev, row_bytes});
    if (it != fits.end()) {
      f = it->second;
    } else {
      err = fit<kThreads, kMaxRows>(dev, row_bytes, &f);
      if (err != cudaSuccess) return err;
      fits.emplace(std::make_pair(dev, row_bytes), f);
    }
  }
  const int64_t grid = std::min<int64_t>((int64_t)f.ctas_per_sm * f.sms, rows);
  *p = Plan{(int)std::max<int64_t>(grid, 1), f.rows_per_step, f.smem_bytes,
            f.ctas_per_sm};
  return cudaSuccess;
}

template <int kThreads, int kMaxRows>
int launch(const void* key, void* tree_idx, void* tree_val, void* nonces,
           const void* flat_b, const void* owner, const void* epoch,
           const void* new_pidx, const void* new_pval, int64_t rows, int z,
           int zv, int rounds, void* stream) {
  if (rows == 0) return 0;
  Plan p;
  cudaError_t err = plan<kThreads, kMaxRows>(rows, z, zv, &p);
  if (err != cudaSuccess) return (int)err;
  // bulk copies move 16-byte multiples between 16-byte-aligned addresses
  const bool bulk = (z % 4 == 0) && (zv % 4 == 0) && aligned16(tree_idx) &&
                    aligned16(tree_val) && aligned16(new_pidx) &&
                    aligned16(new_pval);
  scatter_kernel<kThreads, kMaxRows>
      <<<p.grid, kThreads, p.smem_bytes, (cudaStream_t)stream>>>(
          (const uint32_t*)key, (uint32_t*)tree_idx, (uint32_t*)tree_val,
          (uint32_t*)nonces, (const int32_t*)flat_b, (const uint8_t*)owner,
          (const uint32_t*)epoch, (const uint32_t*)new_pidx,
          (const uint32_t*)new_pval, rows, z, zv, rounds, p.rows_per_step,
          bulk);
  return (int)cudaGetLastError();
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
  return launch<256, kTileRows>(key, tree_idx, tree_val, nonces, flat_b, owner, epoch,
                        new_pidx, new_pval, rows, z, zv, rounds, stream);
}

int gv_scatter_encrypt_rows(const void* key, void* tree_idx, void* tree_val,
                            void* nonces, const void* flat_b,
                            const void* owner, const void* epoch,
                            const void* new_pidx, const void* new_pval,
                            int64_t rows, int64_t n_padded, int z, int zv,
                            int rounds, void* stream) {
  (void)n_padded;
  return launch<kRowThreads, 1>(key, tree_idx, tree_val, nonces, flat_b, owner, epoch,
                        new_pidx, new_pval, rows, z, zv, rounds, stream);
}

// out[4] = {grid, rows per step, dynamic shared memory bytes a CTA, CTAs
// an SM} of the launch at these shapes; `tiled` picks the kernel.
int gv_scatter_launch_config(int tiled, int64_t rows, int z, int zv,
                             int* out) {
  Plan p;
  const cudaError_t err = tiled ? plan<256, kTileRows>(rows, z, zv, &p)
                                : plan<kRowThreads, 1>(rows, z, zv, &p);
  if (err != cudaSuccess) return (int)err;
  out[0] = p.grid;
  out[1] = p.rows_per_step;
  out[2] = p.smem_bytes;
  out[3] = p.ctas_per_sm;
  return 0;
}

}  // extern "C"
