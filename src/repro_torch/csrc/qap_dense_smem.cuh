// One dense QAP instance staged in shared memory, for K1 (qap_delta.cu)
// and K4 (qap_sa_step.cu); then the single rows the L2 branches stage.
//
// A block copies one instance's C and M -- only these two, no transposes
// -- from global memory into dynamic shared memory: row r of each at word
// r * stride, stride = N | 1 (N + 1 at the even bucket orders).  An odd
// stride keeps the three reads of the swap delta free of bank conflicts
// beyond the permutation's own collisions:
//   - a column C[k, a] over lanes k: bank (k * stride + a) mod 32, 32
//     distinct banks for 32 consecutive k because the stride is odd;
//   - a gather M[u, p[i]] over lanes i: one row, bank p[i] mod 32;
//   - a column gather M[p[i], v]: bank (p[i] * stride + v) mod 32, a
//     bijection of p[i] mod 32, as spread as the row gather.
// With stride N the last read would put all 32 lanes of a warp in one bank
// at N = 128.
//
// The copy is cp.async, 4 bytes a lane (the odd stride rules out 16-byte
// destinations), warps over rows and lanes over columns so that each
// warp's source reads are coalesced; one cp.async.wait_all and one
// __syncthreads, then the block reads only shared memory.
//
// The threshold, here and nowhere else: the shared-memory branch takes
// order N when C, M and one warp's chain state (K4's p and best_p, 2N
// ints) fit the 227 KB a block may have on an H100 (kSmemBlockLimit,
// granted with cudaFuncSetAttribute): N <= kSmemMaxN = 169, which covers
// every order the engine solves densely (buckets 32/64/128, multilevel
// coarse solves at 64 and below).  Above it the launchers take their L2
// branch, which stages single rows (row_slot_words below): K1 and K2 (and
// K5, which scores its children with K2's tile kernel) by cp.async from
// many warps at once; K4, one warp a chain, the four rows of M and M^T a
// candidate gathers from by bulk copy, its rows of C read in place after
// an L1 prefetch.
#pragma once

#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <type_traits>

namespace repro_torch {

constexpr int kSmemBlockLimit = 232448;  // 227 KB, an H100 block's most
constexpr int kSmemMaxN = 169;
// Lane-iterations over an order up to kSmemMaxN: the kernels take the
// count as a template argument, so that a lane's loop over i is unrolled
// and its loads issue together.
constexpr int kSmemMaxIters = (kSmemMaxN + 31) / 32;

__host__ __device__ constexpr int smem_stride(int n) { return n | 1; }

__host__ __device__ constexpr size_t smem_instance_bytes(int n) {
  return 2 * static_cast<size_t>(n) * smem_stride(n) * sizeof(float);
}

static_assert(smem_instance_bytes(kSmemMaxN) + 2 * kSmemMaxN * sizeof(int) <=
                  static_cast<size_t>(kSmemBlockLimit),
              "C, M and one chain's state fit at kSmemMaxN");
static_assert(smem_instance_bytes(kSmemMaxN + 1) >
                  static_cast<size_t>(kSmemBlockLimit),
              "kSmemMaxN is the largest order that fits");

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

// Stage C and M (each (n, n), contiguous) into c and m at the padded
// stride; every thread of the block calls it.
__device__ __forceinline__ void stage_instance(float* c, float* m,
                                               const float* C, const float* M,
                                               int n) {
  const int s = smem_stride(n);
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (int r = threadIdx.x >> 5; r < n; r += warps) {
    const float* cr = C + static_cast<size_t>(r) * n;
    const float* mr = M + static_cast<size_t>(r) * n;
    for (int j = lane; j < n; j += 32) {
      cp_async4(c + r * s + j, cr + j);
      cp_async4(m + r * s + j, mr + j);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// Rows staged by the L2 branches of K1 and K2 (orders above kSmemMaxN),
// which copy single rows -- of C, C^T, M, M^T or a permutation -- rather
// than whole instances.  A row keeps its source's position within 16
// bytes (row_shift words), so that all but its ragged head and tail move
// by 16-byte cp.async (cp.async.cg: through L2, not L1); a slot of
// row_slot_words(n) words holds any row of n words, and element i of a
// row staged from src lies at slot[row_shift(src) + i].
__host__ __device__ constexpr int row_slot_words(int n) {
  return (n + 6) & ~3;  // n + 3 rounded up to a multiple of 4
}

__device__ __forceinline__ int row_shift(const void* src) {
  return static_cast<int>((reinterpret_cast<size_t>(src) >> 2) & 3);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most kPending of the calling thread's committed groups
// are in flight.  Other threads' copies are visible after their own wait
// and a barrier (__syncwarp or __syncthreads).
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Issue the copies of an n-word row (floats or ints) from src into the
// 16-byte-aligned slot; thread `rank` of a group of `count` takes every
// count-th 16-byte chunk and every count-th word of the head and tail.
template <typename T>
__device__ __forceinline__ void stage_row(T* slot, const T* src, int n,
                                          int rank, int count) {
  static_assert(sizeof(T) == 4, "rows of 4-byte words");
  const int shift = row_shift(src);
  T* dst = slot + shift;
  const int head = min(n, (4 - shift) & 3);
  const int chunks = (n - head) >> 2;
  const int tail = head + 4 * chunks;
  for (int c = rank; c < chunks; c += count) {
    cp_async16(dst + head + 4 * c, src + head + 4 * c);
  }
  for (int e = rank; e < head + n - tail; e += count) {
    const int i = e < head ? e : tail + e - head;
    cp_async4(dst + i, src + i);
  }
}

// The same row layout by Hopper's bulk copy (cp.async.bulk, the TMA's
// one-dimensional form), for a warp that stages rows alone: one thread
// copies the 16-byte-aligned span that holds the row -- from src rounded
// down to 16 bytes to its end rounded up, at most row_slot_words(n) words,
// never past the 16-byte granule of the row's last word -- so that element
// i lies at slot[row_shift(src) + i], as stage_row leaves it; completion
// is counted in bytes on an mbarrier in shared memory.  stage_row issues
// a cp.async for every 16 bytes of the row; this, one instruction for the
// row (K4's one warp a chain measured the difference: PERF.md).
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ const void* bulk_row_src(const void* src) {
  return reinterpret_cast<const void*>(reinterpret_cast<size_t>(src) &
                                       ~static_cast<size_t>(15));
}

__device__ __forceinline__ unsigned bulk_row_bytes(const void* src, int n) {
  const size_t s = reinterpret_cast<size_t>(src);
  return static_cast<unsigned>(((s + 4 * static_cast<size_t>(n) + 15) &
                                ~static_cast<size_t>(15)) -
                               (s & ~static_cast<size_t>(15)));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Orders this thread's earlier shared-memory accesses (and an mbarrier's
// init) before its later bulk copies, which run in the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Arrive on `bar` and add `bytes` to the transfers its phase waits for.
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Arrive on `bar` (release: this thread's earlier writes are seen by a
// thread that observes the phase complete).
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// Host side: the current device's SM count (queried once per device and
// library), and the full 227 KB granted to `kernel` once per device (bit
// d of `granted`).
inline cudaError_t smem_launch_setup(const void* kernel,
                                     std::atomic<unsigned long long>& granted,
                                     int& sms) {
  static std::atomic<int> sm_counts[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  sms = sm_counts[dev & 63].load(std::memory_order_relaxed);
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    sm_counts[dev & 63].store(sms, std::memory_order_relaxed);
  }
  const unsigned long long bit = 1ull << (dev & 63);
  if (granted.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBlockLimit);
  if (err == cudaSuccess) granted.fetch_or(bit);
  return err;
}

// f(std::integral_constant<int, I>{}) for I = ceil(n / 32) lane-iterations,
// 1 <= I <= kSmemMaxIters; f returns a cudaError_t.
template <typename F>
cudaError_t with_iters(int n, F&& f) {
  switch ((n + 31) / 32) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    default: return cudaErrorInvalidValue;
  }
}
static_assert(kSmemMaxIters == 6, "with_iters covers every order it takes");

// Makes `device` current for a launch and restores the caller's device.
class DeviceGuard {
 public:
  explicit DeviceGuard(int device) : device_(device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != device_) err_ = cudaSetDevice(device_);
  }
  ~DeviceGuard() {
    if (prev_ >= 0 && prev_ != device_) cudaSetDevice(prev_);
  }
  cudaError_t error() const { return err_; }

 private:
  int device_;
  int prev_ = -1;
  cudaError_t err_;
};

}  // namespace repro_torch
