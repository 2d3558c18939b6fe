// The row ring: one kernel body that streams whole bucket rows through
// shared memory and XORs their ChaCha keystream in on the way,
// hand-written for Hopper (sm_90a). It is templated over a direction:
//
//   direction  source row          destination row     keystream (bucket, epoch)
//   kScatter   plaintext row r     tree row flat_b[r]  flat_b[r], the launch's epoch
//   kGather    tree row flat_b[r]  output row r        flat_b[r], nonces[flat_b[r]]
//   kCipher    input row r         output row r        bucket[r], epoch[r]
//
// Four launches use it: B5 and B6 (scatter_kernels.cu), B3
// (gather_kernels.cu) and B2 (cipher_kernels.cu); each file's note names
// the TPU kernel it replaces. The scatter takes owned rows only
// (owner[r]) and commits each target's nonce; the gather and the cipher
// take every row and write fresh outputs, never their inputs. Epoch
// (0, 0) is the identity keystream (a never-written bucket, as
// bucket_cipher.row_keystream), and a gather at rounds 0 is a plain
// gather, so it takes epoch (0, 0) for every row.
//
// What bounds all of them on an H100: device-memory bytes, one read of
// each source row and one write of each destination row. ChaCha8 costs
// ~26 int32 operations a row word, which the card retires faster than
// its memory moves the word, but not by much (the ops bound is ~60% of
// the bytes bound), so the keystream has to overlap the streaming:
// - persistent CTAs (a grid of the card's SMs times the CTAs that fit on
//   one) walk the rows r = blockIdx.x + k * gridDim.x; for the scatter a
//   non-owner costs a one-byte read;
// - each step's rows go through shared memory in a ring of kStages
//   buffers: a 1-D TMA bulk copy (cp.async.bulk) loads the source row
//   and completes on an mbarrier, the CTA XORs the keystream into it in
//   place, and a second bulk copy stores it to its destination. The
//   ring keeps the loads of the next step and the stores of the last
//   ones in flight while this step computes;
// - every thread takes ChaCha blocks in the ChaCha phase: the step's
//   (row, block) pairs are spread over the CTA, so 8 records rows (65
//   blocks each) fill a 256-thread step; one warp, the producer, also
//   finds the next step's rows and issues its copies. Each stage keeps
//   its rows' (bucket, epoch) beside their source and destination, and
//   the pairs of a row whose epoch is (0, 0) are skipped;
// - rows whose planes are not 16-byte multiples, or whose planes do not
//   start 16-byte aligned, take a word path through the same ring,
//   loaded and stored by the threads.
// A row must fit kStages times in an SM's 227 KB (232,448 bytes) of
// shared memory beside the kernel's static shared memory (under 1 KB):
// rows up to about 77 KB (19,300 words) at 3 stages. The widest
// production row, a mailbox bucket, is 6,084 words (24,336 bytes). A
// wider row's launch is refused (cudaErrorInvalidConfiguration) and the
// wrapper raises.
//
// Obliviousness: every global address depends only on r, on flat_b and
// owner, which are public (the round's transcript and its bucket-owner
// map, or the flush's window ledger), and on the public nonces, as in
// the Pallas kernels. The only branch that depends on data is on a
// row's public epoch.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <utility>

#include "chacha.cuh"

// The copy path the calling thread's latest launch took: 1 for 16-byte
// vectors (TMA bulk copies in a ring launch), 0 for 4-byte words, -1
// before any launch. Each launch sets it from its own choice; read with
// gv_last_copy_path. Defined in gather_kernels.cu.
extern thread_local int gv_copy_path;

namespace {

constexpr int kScatter = 0;
constexpr int kGather = 1;
constexpr int kCipher = 2;

// The ring's depth, the tiled launches' rows a step (B6, B2) and the
// one-row launches' CTA size (B5, B3). A sweep of stages 2/3/4 x rows
// 2/4/8 x B5 threads 128/256 on an H100 found no variant faster by more
// than run-to-run noise (PERF.md §6).
constexpr int kStages = 3;
static_assert(kStages >= 2, "the ring needs a stage loading and one computing");
constexpr int kTileRows = 8;      // B6's Pallas tile (pallas_gather.py:372)
constexpr int kRowThreads = 128;  // one row a step: one Pallas grid step
// shared memory a CTA's ring may take: half of an SM's 227 KB, so at
// least two CTAs share an SM
constexpr int kRingBytes = 112 * 1024;

// A launch's planes. Rows are split over two planes: words [0, z) of a
// row live in *_idx (row stride z), words [z, z + zv) in *_val (stride
// zv). Fields a direction does not read are null.
struct RingArgs {
  const uint32_t* key;      // [8]
  const uint32_t* src_idx;  // scatter: plaintext; gather: tree; cipher: input
  const uint32_t* src_val;
  uint32_t* dst_idx;        // scatter: tree; gather, cipher: fresh output
  uint32_t* dst_val;
  const int32_t* flat_b;    // scatter: target buckets; gather: source rows
  const uint8_t* owner;     // scatter: [R] owner flags
  const uint32_t* epoch;    // scatter: [2] the write epoch; cipher: [R, 2]
  uint32_t* nonces;         // [n, 2]: scatter writes them, gather reads them
  const uint32_t* bucket;   // cipher: [R] keystream buckets
};

// One row of a step: where it comes from and goes to, and its keystream.
struct RowJob {
  int64_t src, dst;
  uint32_t bucket, e_lo, e_hi;
};

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

// Scatter's producer warp: the next (at most t) owned rows of this CTA's
// sequence r = blockIdx.x + k * gridDim.x, from k = cursor, into jobs,
// each under the launch's epoch (e_lo, e_hi). Returns their count; every
// lane gets the same count and cursor. A warp ballots 32 candidates at a
// time.
__device__ __forceinline__ int next_owned(const RingArgs& a, int64_t rows,
                                          uint32_t e_lo, uint32_t e_hi,
                                          int64_t& cursor, int t,
                                          RowJob* jobs) {
  const int lane = threadIdx.x & 31;
  const int64_t g = blockIdx.x, grid = gridDim.x;
  int n = 0;
  while (n < t && g + cursor * grid < rows) {
    const int64_t r = g + (cursor + lane) * grid;
    const bool in = r < rows;
    // both reads at once: flat_b is public, read for non-owners too
    const int32_t b = in ? a.flat_b[r] : 0;
    const bool own = in && a.owner[r] != 0;
    const unsigned m = __ballot_sync(0xffffffffu, own);
    const int rank = __popc(m & ((1u << lane) - 1u));
    const int take = min(__popc(m), t - n);
    if (own && rank < take) {
      jobs[n + rank] = RowJob{r, b, (uint32_t)b, e_lo, e_hi};
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

// Gather's and cipher's producer warp: the next (at most t) rows of this
// CTA's sequence, every row in order, no ballot: lane j < t takes the
// j-th. Returns their count, the same in every lane.
template <int kDir>
__device__ __forceinline__ int next_rows(const RingArgs& a, int64_t rows,
                                         int rounds, int64_t& cursor, int t,
                                         RowJob* jobs) {
  const int lane = threadIdx.x & 31;
  const int64_t g = blockIdx.x, grid = gridDim.x;
  const int64_t left = (rows - g + grid - 1) / grid - cursor;
  const int n = left <= 0 ? 0 : (left < t ? (int)left : t);
  if (lane < n) {
    const int64_t r = g + (cursor + lane) * grid;
    if constexpr (kDir == kGather) {
      const int64_t b = a.flat_b[r];
      const uint32_t lo = rounds > 0 ? a.nonces[2 * b] : 0u;
      const uint32_t hi = rounds > 0 ? a.nonces[2 * b + 1] : 0u;
      jobs[lane] = RowJob{b, r, (uint32_t)b, lo, hi};
    } else {
      jobs[lane] = RowJob{r, r, a.bucket[r], a.epoch[2 * r], a.epoch[2 * r + 1]};
    }
  }
  cursor += n;
  return n;
}

// kCta threads a CTA; a step holds at most kMaxRows rows (t at run time,
// from the shared memory a row takes).
template <int kCta, int kMaxRows, int kDir>
__global__ void __launch_bounds__(kCta) ring_kernel(RingArgs a, int64_t rows,
                                                    int z, int zv, int rounds,
                                                    int t, bool bulk) {
  extern __shared__ __align__(16) uint32_t ring[];  // [kStages][t][wp]
  __shared__ RowJob s_job[kStages][kMaxRows];
  __shared__ int s_cnt[kStages];
  __shared__ __align__(8) uint64_t s_full[kStages];

  const int w = z + zv;
  const int wp = (w + 3) & ~3;  // row slots stay 16-byte aligned
  const int nb = (w + 15) / 16;
  uint32_t k[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) k[i] = __ldg(a.key + i);
  // the scatter's one epoch, read once (the producer's steps wait on it)
  const uint32_t e_lo = kDir == kScatter ? __ldg(a.epoch) : 0u;
  const uint32_t e_hi = kDir == kScatter ? __ldg(a.epoch + 1) : 0u;
  // the last warp produces: it has the fewest ChaCha pairs in a step
  const bool producer = (threadIdx.x >> 5) == kCta / 32 - 1;
  const bool issuer = threadIdx.x == kCta - 32;
  int64_t cursor = 0;

  // Producer: find stage s's rows and start their loads. The buffer
  // was last read by the stores of the step kStages back; this thread
  // committed them, and at most kStages - 2 later groups may be open.
  auto fill = [&](int s) {
    int n;
    if constexpr (kDir == kScatter) {
      n = next_owned(a, rows, e_lo, e_hi, cursor, t, s_job[s]);
    } else {
      n = next_rows<kDir>(a, rows, rounds, cursor, t, s_job[s]);
    }
    __syncwarp();
    if (issuer) {
      s_cnt[s] = n;
      if (bulk && n > 0) {
        bulk_wait_read<kStages - 2>();
        mbar_expect_tx(&s_full[s], (uint32_t)(n * w * 4));
        for (int j = 0; j < n; ++j) {
          uint32_t* row = ring + (s * t + j) * wp;
          const int64_t src = s_job[s][j].src;
          bulk_load(row, a.src_idx + src * z, z * 4, &s_full[s]);
          bulk_load(row + z, a.src_val + src * zv, zv * 4, &s_full[s]);
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
      for (int q = threadIdx.x; q < n * w; q += kCta) {
        const int j = q / w, m = q - j * w;
        const int64_t r = s_job[s][j].src;
        stage[j * wp + m] = m < z ? a.src_idx[r * z + m] : a.src_val[r * zv + (m - z)];
      }
      __syncthreads();
    }
    // (row j, ChaCha block c) pairs over every thread; word jj of block c
    // is row word jj * nb + c (j-major), so a warp's lanes touch
    // consecutive words: conflict-free
    for (int p = threadIdx.x; p < n * nb; p += kCta) {
      const int j = p / nb, c = p - j * nb;
      const RowJob& job = s_job[s][j];
      if ((job.e_lo | job.e_hi) == 0u) continue;  // identity keystream
      uint32_t ks[16];
      gv_chacha_block(k, (uint32_t)c, job.bucket, job.e_lo, job.e_hi, rounds, ks);
      uint32_t* row = stage + j * wp;
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const int m = jj * nb + c;
        if (m < w) row[m] ^= ks[jj];
      }
    }
    if (bulk) fence_proxy_async();
    __syncthreads();
    if (bulk) {
      if (issuer) {
        for (int j = 0; j < n; ++j) {
          const int64_t d = s_job[s][j].dst;
          const uint32_t* row = stage + j * wp;
          bulk_store(a.dst_idx + d * z, row, z * 4);
          bulk_store(a.dst_val + d * zv, row + z, zv * 4);
        }
        bulk_commit();
      }
    } else {
      for (int q = threadIdx.x; q < n * w; q += kCta) {
        const int j = q / w, m = q - j * w;
        const int64_t d = s_job[s][j].dst;
        const uint32_t x = stage[j * wp + m];
        if (m < z) {
          a.dst_idx[d * z + m] = x;
        } else {
          a.dst_val[d * zv + (m - z)] = x;
        }
      }
    }
    if constexpr (kDir == kScatter) {
      if (threadIdx.x < n) {
        const RowJob& job = s_job[s][threadIdx.x];
        a.nonces[2 * job.dst] = job.e_lo;
        a.nonces[2 * job.dst + 1] = job.e_hi;
      }
    }
    __syncthreads();
  }
  // the ring is this CTA's shared memory: no store may outlive it
  if (bulk && issuer) bulk_wait_all();
}

inline bool aligned16(const void* p) {
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
template <int kCta, int kMaxRows, int kDir>
cudaError_t fit(int dev, int row_bytes, Fit* f) {
  auto kernel = ring_kernel<kCta, kMaxRows, kDir>;
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
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kCta, smem);
  if (err != cudaSuccess) return err;
  if (per_sm == 0) return cudaErrorInvalidConfiguration;
  *f = Fit{t, smem, per_sm, sms};
  return cudaSuccess;
}

// The launch: the fit, found once per (device, row width) and kept, then
// as many CTAs as fit on the card at once, never more than there are rows.
template <int kCta, int kMaxRows, int kDir>
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
      err = fit<kCta, kMaxRows, kDir>(dev, row_bytes, &f);
      if (err != cudaSuccess) return err;
      fits.emplace(std::make_pair(dev, row_bytes), f);
    }
  }
  const int64_t grid = std::min<int64_t>((int64_t)f.ctas_per_sm * f.sms, rows);
  *p = Plan{(int)std::max<int64_t>(grid, 1), f.rows_per_step, f.smem_bytes,
            f.ctas_per_sm};
  return cudaSuccess;
}

// Returns the cudaError_t of the launch (0 = launched).
template <int kCta, int kMaxRows, int kDir>
int ring_launch(const RingArgs& a, int64_t rows, int z, int zv, int rounds,
                void* stream) {
  if (rows == 0) return 0;
  Plan p;
  cudaError_t err = plan<kCta, kMaxRows, kDir>(rows, z, zv, &p);
  if (err != cudaSuccess) return (int)err;
  // bulk copies move 16-byte multiples between 16-byte-aligned addresses
  const bool bulk = (z % 4 == 0) && (zv % 4 == 0) && aligned16(a.src_idx) &&
                    aligned16(a.src_val) && aligned16(a.dst_idx) &&
                    aligned16(a.dst_val);
  ring_kernel<kCta, kMaxRows, kDir>
      <<<p.grid, kCta, p.smem_bytes, (cudaStream_t)stream>>>(
          a, rows, z, zv, rounds, p.rows_per_step, bulk);
  err = cudaGetLastError();
  if (err == cudaSuccess) gv_copy_path = bulk ? 1 : 0;
  return (int)err;
}

// out[4] = {grid, rows per step, dynamic shared memory bytes a CTA, CTAs
// an SM} of the launch at these shapes; returns the cudaError_t.
template <int kCta, int kMaxRows, int kDir>
int ring_launch_config(int64_t rows, int z, int zv, int* out) {
  Plan p;
  const cudaError_t err = plan<kCta, kMaxRows, kDir>(rows, z, zv, &p);
  if (err != cudaSuccess) return (int)err;
  out[0] = p.grid;
  out[1] = p.rows_per_step;
  out[2] = p.smem_bytes;
  out[3] = p.ctas_per_sm;
  return 0;
}

}  // namespace
