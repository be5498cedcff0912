// The QAP objective of one permutation, as a block-wide device function:
// the arithmetic of kernel K2 (csrc/qap_objective.cu), shared with the
// fused GA step K5 (csrc/qap_ga_step.cu), which scores each child with it.
// Its fixed-order reduction, block_sum, also ends the sparse objective K6
// (csrc/qap_objective_sparse.cu).
//
//   F(p) = sum_k sum_l C[k, l] * M[p[k], p[l]]
//
// Warp w takes rows k = w, w + warps, ...; lane i takes columns l = i,
// i + 32, ... of each, so a warp reads the row C[k, :] coalesced and
// gathers M[p[k], p[.]] from one row of M (L1/L2).  The ragged edge past N
// is masked by the loop bounds, not padded.  Each thread sums its terms in
// that order, the lanes of a warp by a butterfly, then the warps in warp
// order: a fixed order for a given N, so the result is deterministic.  On
// integer-valued instances every partial sum is an exact integer in f32,
// so F equals the plain PyTorch version's bit for bit.  No tensor cores:
// TF32 would round integers above 2^11.
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

// p: the permutation (shared memory or global); red: kThreads / 32
// floats of shared memory.  Every thread returns the total.  Contains
// __syncthreads(): call it from every thread of the block.
template <int kThreads>
__device__ __forceinline__ float block_objective(const float* __restrict__ c,
                                                 const float* __restrict__ m,
                                                 const int* p, int N,
                                                 float* red) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float acc = 0.f;
  for (int k = warp; k < N; k += kWarps) {
    const float* crow = c + static_cast<size_t>(k) * N;
    const float* mrow = m + static_cast<size_t>(p[k]) * N;
    for (int l = lane; l < N; l += 32) acc += crow[l] * mrow[p[l]];
  }
  return block_sum<kThreads>(acc, red);
}

}  // namespace repro_torch
