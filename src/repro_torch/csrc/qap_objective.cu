// K2: batched QAP objective on Hopper.
//
// Replaces the TPU kernel repro/kernels/qap_objective.py
// qap_objective_pallas_batch (body _objective_kernel).  perms (B, P, N)
// -> (B, P) f32, F = sum_{k,l} C[k,l] * M[p[k], p[l]].  C and M are shared
// (N, N) or instance-batched (B0, N, N) with B0 dividing B: perms row b
// belongs to instance b / (B / B0), so permutation q = b * P + j reads the
// matrices of instance q / perms_per_inst, perms_per_inst = B * P / B0,
// and the permutations of one instance are contiguous.
//
// The TPU kernel built a one-hot P and ran P @ M @ P^T on the MXU, with
// permutations padded to 128 by an identity tail.  That is a systolic
// array's trick; here M[p[k], p[l]] is gathered directly, the ragged edge
// is masked, and no tensor core is used (csrc/qap_objective.cuh and
// csrc/qap_objective_tiles.cuh hold the arithmetic of the two branches,
// shared with the fused GA step K5).
//
// Two branches, chosen on the host by the order (qap_dense_smem.cuh):
//
// * Shared memory, N <= kSmemMaxN (every dense bucket of the engine).  A
//   block takes one instance and a contiguous slice of its permutations,
//   stages C and M into shared memory once (cp.async at the odd row
//   stride), then scores its permutations one warp each
//   (warp_objective): each permutation's terms are read from shared
//   memory, not from L2.  The split: floor(SMs / B0) blocks of 16 warps
//   per instance (at least one, at most one per permutation), so a GA
//   generation of the 128 bucket's wave (32 instances x 32 children) is
//   128 blocks, one per SM, each staging its 132 KB once and scoring 8
//   permutations, and the 64 and 32 buckets' 3-request waves spread over
//   as many blocks as they have permutations (up to 132).  Warps without
//   a permutation still speed the staging (16 warps measured faster than
//   8 at the 128 bucket and than 4 at the 3-request waves).
//
// * L2, orders above kSmemMaxN (the engine's exact-size requests of
//   170-255 processes, Table 1's tai175/343/729, sparse_scale's dense
//   baseline at 4096).  The grid runs over (instance, group of G
//   permutations, tile of R rows of C).  A block stages its G
//   permutation rows in shared memory; warp w takes the tile's rows w,
//   w + warps, ... in order, and for each stages C[k, :] and the G rows
//   M[p_g[k], :] into one of its own slot sets by 16-byte cp.async (two
//   sets: the next row's land while this one is summed), reads C[k, l]
//   once for all G permutations and gathers M[p_g[k], p_g[l]] from
//   shared memory, lanes over l.  Each permutation's tile sum (lanes by a
//   butterfly, then warps in order) goes to a workspace, and a second
//   small kernel adds a permutation's tiles in tile order (the tile
//   kernel is csrc/qap_objective_tiles.cuh; K5's L2 branch runs it too).
//   The warps, sets and R = 4 rows a warp are chosen on the host from N
//   alone, G (2, or 1 for an instance's single permutation or orders from
//   11,618) from the batch, in one function (kernels/qap_objective.py
//   l2_tiling): a permutation's F then depends on N alone -- not on the
//   batch, the SM count or which block finishes first -- and 8 x 4096
//   runs 1024 blocks.  At most 4 warps a block, so that two or three
//   blocks share an SM at Table 1's orders; warps with their own slots
//   and no block barrier between rows measured 1.5-2.2x faster at Table
//   1's shapes than blocks of 8 warps staging each row together, and 4
//   warps with two sets 1.3x faster than 8 at tai729.  Any order whose
//   permutation fits 48 KB.
//
// What bounds it on an H100: memory, and at the engine's shapes the
// launch.  A GA generation of a 32-instance 128-bucket wave scores 1024
// children: C and M of 32 instances are 4.2 MB of unique bytes (1.3 us at
// 3.35 TB/s) against 34 MFLOP (0.5 us at the f32 peak).  The
// shared-memory branch reads each instance from L2 four times and then
// only shared memory, where the gathers through the permutation land on
// random banks: it is bound by shared-memory wavefronts (some 4.5 per row
// and 32 columns).  The L2 branch moves every permutation's N rows of M
// (N^2 words a permutation: 544 MB through L2 for Table 1's 4 x 64 on
// tai729, whose instance L2 holds) and C once a group; at 8 x 4096 the
// instance (134 MB) is past L2, so about 0.6 GB comes from HBM, some
// 0.18 ms at 3.35 TB/s.
#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <cstddef>

#include "qap_dense_smem.cuh"
#include "qap_objective.cuh"
#include "qap_objective_tiles.cuh"

namespace {

using repro_torch::smem_stride;

constexpr int kSmemWarps = 16;   // shared-memory branch
constexpr int kSumThreads = 128;

// One flag word per instantiation of the shared-memory kernel and of the
// tile kernel (G = 1, 2).
std::atomic<unsigned long long> g_smem_granted[repro_torch::kSmemMaxIters + 1];
std::atomic<unsigned long long> g_l2_granted[repro_torch::kTileMaxGroup];

template <int ITERS>
__global__ void __launch_bounds__(kSmemWarps * 32)
qap_objective_smem_kernel(const float* __restrict__ C,
                          const float* __restrict__ M,
                          const int* __restrict__ perms,
                          float* __restrict__ out, int N,
                          long long perms_per_inst, int blocks_per_inst) {
  extern __shared__ float smem[];
  const int s = smem_stride(N);
  float* c = smem;
  float* m = smem + static_cast<size_t>(N) * s;
  const int inst = blockIdx.x / blocks_per_inst;
  const int part = blockIdx.x - inst * blocks_per_inst;
  const size_t nn = static_cast<size_t>(N) * N;
  repro_torch::stage_instance(c, m, C + inst * nn, M + inst * nn, N);

  const long long chunk =
      (perms_per_inst + blocks_per_inst - 1) / blocks_per_inst;
  const long long first = inst * perms_per_inst + part * chunk;
  const long long end = min(first + chunk, (inst + 1) * perms_per_inst);
  const int lane = threadIdx.x & 31;
  for (long long q = first + (threadIdx.x >> 5); q < end;
       q += blockDim.x >> 5) {
    const int* prow = perms + static_cast<size_t>(q) * N;
    int pl[ITERS];
#pragma unroll
    for (int j = 0; j < ITERS; ++j) {
      const int l = lane + 32 * j;
      pl[j] = l < N ? prow[l] : 0;
    }
    const float f = repro_torch::warp_objective<ITERS>(c, m, s, pl, N);
    if (lane == 0) out[q] = f;
  }
}

// out[q] = permutation q's tile sums added in tile order.
__global__ void __launch_bounds__(kSumThreads)
qap_objective_tile_sum_kernel(const float* __restrict__ partial,
                              float* __restrict__ out, long long total,
                              int tiles) {
  const long long q =
      static_cast<long long>(blockIdx.x) * kSumThreads + threadIdx.x;
  if (q >= total) return;
  out[q] = repro_torch::tile_total(partial + q * tiles, tiles);
}

}  // namespace

// partial: total x ceil(N / tile_rows) floats of workspace, read only
// above kSmemMaxN; group, warps, sets and tile_rows: the L2 branch's
// tiling for order N (kernels/qap_objective.py l2_tiling).
extern "C" int qap_objective_launch(const float* C, const float* M,
                                    const int* perms, float* out,
                                    float* partial, long long total, int N,
                                    long long perms_per_inst, int group,
                                    int warps, int sets, int tile_rows,
                                    int device, void* stream) {
  repro_torch::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= repro_torch::kSmemMaxN) {
    const long long b0 = total / perms_per_inst;
    return static_cast<int>(repro_torch::with_iters(N, [&](auto iters) {
      constexpr int I = decltype(iters)::value;
      int sms = 0;
      const cudaError_t err = repro_torch::smem_launch_setup(
          reinterpret_cast<const void*>(qap_objective_smem_kernel<I>),
          g_smem_granted[I], sms);
      if (err != cudaSuccess) return err;
      // Spread each instance over floor(SMs / B0) blocks, one permutation
      // at least each, so that the card's SMs all stage and score.
      const int per = static_cast<int>(std::max(
          1LL, std::min(static_cast<long long>(sms) / b0, perms_per_inst)));
      qap_objective_smem_kernel<I>
          <<<static_cast<unsigned>(b0 * per), kSmemWarps * 32,
             repro_torch::smem_instance_bytes(N), st>>>(
              C, M, perms, out, N, perms_per_inst, per);
      return cudaGetLastError();
    }));
  }
  if (partial == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = repro_torch::launch_objective_tiles(
      C, M, perms, partial, total, N, perms_per_inst, group, warps, sets,
      tile_rows, st, g_l2_granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (N + tile_rows - 1) / tile_rows;
  qap_objective_tile_sum_kernel<<<static_cast<unsigned>(
                                      (total + kSumThreads - 1) / kSumThreads),
                                  kSumThreads, 0, st>>>(partial, out, total,
                                                        tiles);
  return static_cast<int>(cudaGetLastError());
}
