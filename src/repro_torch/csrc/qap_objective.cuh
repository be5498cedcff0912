// The QAP objective of one permutation, as device code shared by the
// kernels that score permutations: K2 (csrc/qap_objective.cu) and the
// fused GA step K5 (csrc/qap_ga_step.cu), which scores its children with
// the same arithmetic on both of its branches.  Its fixed-order
// reduction, block_sum, also ends the sparse objective K6
// (csrc/qap_objective_sparse.cu).
//
//   F(p) = sum_k sum_l C[k, l] * M[p[k], p[l]]
//
// Two forms, one for each branch of K2 and K5:
//
// * warp_objective (shared-memory branches): one warp scores one
//   permutation from an instance staged in shared memory
//   (csrc/qap_dense_smem.cuh, rows at the odd stride s).  Lane i holds its
//   columns' targets p[i + 32 j] in registers; for each row k (its target
//   p[k] passed by a shuffle) it reads C[k, i + 32 j] (consecutive words,
//   no bank conflict) and gathers M[p[k], p[i + 32 j]] from one row of M,
//   whose banks follow p[i + 32 j] mod 32 (some 3.5 wavefronts a gather
//   for a random permutation).  The row loop is unrolled by 8, so that a
//   warp has some 32 independent loads in flight (K2 measured much faster
//   so at the 128 bucket, with only 8 permutations an SM, than without
//   unrolling).  Each lane keeps one partial sum per j, adds them in j
//   order, and the lanes meet in a xor butterfly: every lane returns the
//   same total.
// * qap_objective_tile_kernel (L2 branches, orders above kSmemMaxN;
//   csrc/qap_objective_tiles.cuh): a block takes a group of permutations
//   and a tile of rows of C from L2, and a permutation's tiles are added
//   in tile order.
//
// Both run in a fixed order for a given N, so the result is
// deterministic; the ragged edge past N is masked by the loop bounds, not
// padded.  On integer-valued instances every partial sum is an exact
// integer in f32, so both forms equal the plain PyTorch version (and each
// other) bit for bit.  No tensor cores: TF32 would round integers above
// 2^11.
#pragma once

#include <cstddef>

namespace repro_torch {

// The sum of every thread's acc over the block, in a fixed order: the
// lanes of each warp by a butterfly, then the warps in warp order.  red:
// kThreads / 32 floats of shared memory.  Every thread returns the total.
// Contains __syncthreads(): call it from every thread of the block.
template <int kThreads>
__device__ __forceinline__ float block_sum(float acc, float* red) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) red[warp] = acc;
  __syncthreads();
  float total = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) total += red[w];
  __syncthreads();  // every thread has read red before it is reused
  return total;
}

// One warp's objective over a staged instance: c and m rows at stride s;
// pl[j] = p[lane + 32 j] (anything past N), ITERS = ceil(N / 32).  Every
// lane of the warp must call it; every lane returns the total.
template <int ITERS>
__device__ __forceinline__ float warp_objective(const float* c, const float* m,
                                                int s, const int (&pl)[ITERS],
                                                int N) {
  const int lane = threadIdx.x & 31;
  float acc[ITERS];
#pragma unroll
  for (int j = 0; j < ITERS; ++j) acc[j] = 0.f;
#pragma unroll
  for (int kb = 0; kb < ITERS; ++kb) {
    const int rows = min(32, N - 32 * kb);
#pragma unroll 8
    for (int t = 0; t < rows; ++t) {
      const int pk = __shfl_sync(0xffffffffu, pl[kb], t);
      const float* crow = c + (32 * kb + t) * s;
      const float* mrow = m + pk * s;
#pragma unroll
      for (int j = 0; j < ITERS; ++j) {
        if (lane + 32 * j < N) acc[j] += crow[lane + 32 * j] * mrow[pl[j]];
      }
    }
  }
  float total = acc[0];
#pragma unroll
  for (int j = 1; j < ITERS; ++j) total += acc[j];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    total += __shfl_xor_sync(0xffffffffu, total, off);
  }
  return total;
}

}  // namespace repro_torch
