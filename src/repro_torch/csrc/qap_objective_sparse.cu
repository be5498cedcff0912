// K6: batched sparse QAP objective on Hopper.
//
// Replaces the TPU kernel repro/kernels/qap_sparse.py
// qap_objective_sparse_pallas_batch (body _objective_sparse_kernel).
// perms (B, P, N) -> (B, P) f32 over ELL flows (cols/vals (N, D), padding
// entries of value 0 with in-range column ids):
//
//   F(p) = sum_r sum_d vals[r, d] * M[p[r], p[cols[r, d]]]
//
// The leaves and M are shared ((N, D), (N, N)) or instance-batched
// ((B0, N, D), (B0, N, N)) with B0 dividing B: permutation q = b * P + j
// reads instance q / perms_per_inst, perms_per_inst = B * P / B0.
//
// The TPU kernel ran one program per (permutation, row), streamed the row
// M[p[r], :] by a scalar-prefetched index map, and reduced the per-row
// partial sums outside the kernel.  Here one thread-block cluster of G
// blocks scores one permutation, the whole (B, P) batch in one launch of
// B * P * G blocks.  G and the grid come from the host
// (kernels/qap_sparse.py objective_sparse_launch): G = SMs / (B * P),
// between 1 and 16, so the engine's 1 or 4 permutations get 16 blocks
// each and a wide batch one.  Block g of a cluster takes the rows
// [g N / G, (g + 1) N / G) and walks their entries flat: thread t takes
// entries e = e0 + t, e0 + t + 512, ..., row r = e / D, so the loads of
// cols and vals are coalesced and every lane works whatever D is.  Each
// term is a chain of three gathers, cols[e], then p[cols[e]] (and p[r]),
// then M[p[r], p[cols[e]]]; a thread issues the first load of each of
// its next kTerms entries, then the second of each, then the third,
// before it sums, so its chains are in flight together.  Entries past the
// range are predicated off: no load, no add.  The permutation is read
// through L1.
//
// The sum has a fixed order, so a result is the same bits on every call:
// each thread adds its entries in order, the block by block_sum
// (csrc/qap_objective.cuh), then rank 0 of the cluster adds the G block
// sums in rank order from its own shared memory, where each block stored
// its sum over distributed shared memory.  No atomics, no second pass.
// On integer-valued instances every partial sum is exact, so F equals the
// plain version bit for bit.
//
// What bounds it on an H100: the launch, and how many SMs share the
// gathers.  At N = 4096, D = 6 one permutation reads 24 576 ELL entries
// (196 KB) and as many scattered entries of M (64 MB, larger than the 50
// MB L2), each its own 32-byte sector: 0.8 MB, some 0.25 us at 3.35 TB/s.
// One block of 512 threads walked 48 entries a thread and took 0.018 ms
// (the kernel this replaces); the time fell with every block added to a
// permutation's cluster up to 16 (3 entries a thread, 0.005 ms), and at
// the coarsest level (N = 128, under one entry a thread) it takes 0.0037
// ms: the launch, three dependent loads and the cluster barrier are most
// of what is left (chip_kernels.py --k6 times cluster sizes 4, 8, 16).
//
// Where p lives was measured: through L1 (this kernel), each block's
// rows' slice staged in shared memory, 1/G of it a block read over
// distributed shared memory, or all of it a block (chip_kernels.py --k6
// builds each from this source, K6_STAGE_EDITS).  L1 was the fastest or
// within 0.0002 ms of it at the route's shapes, and takes every order.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>

#include "qap_dense_smem.cuh"
#include "qap_objective.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kTerms = 4;        // entries a thread has in flight
constexpr int kMaxCluster = 16;  // the largest cluster an H100 schedules

// The cluster barrier in two halves: arrive, then wait for every thread of
// every block of the cluster to have arrived.  relaxed: no memory order
// (used to learn that the other blocks have started); release/acquire
// (the default): writes before the arrive are seen after the wait.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads)
qap_objective_sparse_kernel(const int* __restrict__ cols,
                            const float* __restrict__ vals,
                            const float* __restrict__ M,
                            const int* __restrict__ perms,
                            float* __restrict__ out, int N, int D,
                            long long perms_per_inst) {
  __shared__ float red[kThreads / 32];
  __shared__ float part[kMaxCluster];  // rank 0: the blocks' sums
  cg::cluster_group cluster = cg::this_cluster();
  const int G = static_cast<int>(cluster.num_blocks());
  const int g = static_cast<int>(cluster.block_rank());
  cluster_arrive_relaxed();  // waited on before rank 0's memory is written
  const long long q = blockIdx.x / G;
  const long long inst = q / perms_per_inst;
  const int* p = perms + static_cast<size_t>(q) * N;
  const size_t ell = static_cast<size_t>(inst) * N * D;
  const int* c = cols + ell;
  const float* w = vals + ell;
  const float* m = M + static_cast<size_t>(inst) * N * N;
  const int r0 = static_cast<int>(static_cast<long long>(g) * N / G);
  const int r1 = static_cast<int>(static_cast<long long>(g + 1) * N / G);
  const int e0 = r0 * D, e1 = r1 * D;

  auto pget = [&](int i) { return __ldg(p + i); };

  // The thread's entries, kTerms a round: e = base + k * kThreads for
  // k < live.  An entry past the range issues no load and adds nothing.
  float acc = 0.f;
  for (int base = e0 + static_cast<int>(threadIdx.x); base < e1;
       base += kThreads * kTerms) {
    const int live = (e1 - 1 - base) / kThreads + 1;
    int col[kTerms], row[kTerms];
    float wt[kTerms];
#pragma unroll
    for (int k = 0; k < kTerms; ++k) {
      const int e = base + k * kThreads;
      col[k] = k < live ? __ldg(c + e) : 0;
      wt[k] = k < live ? __ldg(w + e) : 0.f;
      row[k] = e / D;
    }
    int pr[kTerms], pc[kTerms];
#pragma unroll
    for (int k = 0; k < kTerms; ++k) {
      pr[k] = k < live ? pget(row[k]) : 0;
      pc[k] = k < live ? pget(col[k]) : 0;
    }
    float mv[kTerms];
#pragma unroll
    for (int k = 0; k < kTerms; ++k) {
      mv[k] = k < live ? __ldg(m + static_cast<size_t>(pr[k]) * N + pc[k])
                       : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kTerms; ++k) {
      if (k < live) acc += wt[k] * mv[k];
    }
  }
  const float f = repro_torch::block_sum<kThreads>(acc, red);

  cluster_wait();  // every block has started: rank 0's shared memory exists
  if (threadIdx.x == 0) *cluster.map_shared_rank(part + g, 0) = f;
  cluster_arrive();  // the sums stored
  cluster_wait();
  if (g == 0 && threadIdx.x == 0) {
    float total = part[0];
    for (int i = 1; i < G; ++i) total += part[i];
    out[q] = total;
  }
}

}  // namespace

// grid = B * P * cluster blocks, cluster (G) blocks per permutation,
// 1 <= cluster <= 16 and cluster <= N; above 8 the kernel is allowed the
// non-portable cluster size first (once per device).  A cluster of one
// block is launched without the cluster attribute (every block is its own
// cluster then), which measured cheaper per launch.
extern "C" int qap_objective_sparse_launch(const int* cols, const float* vals,
                                           const float* M, const int* perms,
                                           float* out, long long grid,
                                           int cluster, int N, int D,
                                           long long perms_per_inst,
                                           int device, void* stream) {
  if (cluster < 1 || cluster > kMaxCluster || cluster > N ||
      grid % cluster != 0 || grid > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  repro_torch::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  cudaError_t err;
  static std::atomic<unsigned long long> allowed{0};  // bit d: device d
  const unsigned long long bit = 1ull << (device & 63);
  if (cluster > 8 && !(allowed.load(std::memory_order_relaxed) & bit)) {
    err = cudaFuncSetAttribute(qap_objective_sparse_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed.fetch_or(bit);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;  // one block: the implicit cluster
  err = cudaLaunchKernelEx(&cfg, qap_objective_sparse_kernel, cols, vals, M,
                           perms, out, N, D, perms_per_inst);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
