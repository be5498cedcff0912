// K2: batched QAP objective on Hopper.
//
// Replaces the TPU kernel repro/kernels/qap_objective.py
// qap_objective_pallas_batch (body _objective_kernel).  perms (B, P, N)
// -> (B, P) f32, F = sum_{k,l} C[k,l] * M[p[k], p[l]].  C and M are shared
// (N, N) or instance-batched (B0, N, N) with B0 dividing B: perms row b
// belongs to instance b / (B / B0), so permutation q = b * P + j reads the
// matrices of instance q / perms_per_inst, perms_per_inst = B * P / B0.
//
// The TPU kernel built a one-hot P and ran P @ M @ P^T on the MXU, with
// permutations padded to 128 by an identity tail.  That is a systolic
// array's trick; here M[p[k], p[l]] is gathered directly, the ragged edge
// is masked, and no tensor core is used (csrc/qap_objective.cuh holds the
// arithmetic, shared with the fused GA step K5).
//
// Layout: one block of 128 threads per permutation.  The block loads its
// permutation into shared memory (N ints), then each warp walks rows of C
// coalesced and gathers through the permutation from one row of M.
//
// What bounds it on an H100: memory, and at the engine's shapes the
// launch.  A GA generation of a 32-instance 128-bucket wave scores 1024
// children: C and M of 32 instances are 4.2 MB of unique bytes (1.3 us at
// 3.35 TB/s) against 34 MFLOP (0.5 us at the f32 peak).  Each block
// re-reads its instance's C and M (128 KB) from L2, which holds the whole
// wave's matrices; the design keeps one launch per generation for the
// whole wave and reads each row of C coalesced.  Staging M in shared
// memory, or scoring several permutations per block against one staged
// C, is later work.
#include <cuda_runtime.h>

#include <cstddef>

#include "qap_objective.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
qap_objective_kernel(const float* __restrict__ C, const float* __restrict__ M,
                     const int* __restrict__ perms, float* __restrict__ out,
                     int N, long long perms_per_inst) {
  extern __shared__ int p[];
  __shared__ float red[kThreads / 32];
  const long long q = blockIdx.x;
  const size_t base = static_cast<size_t>(q / perms_per_inst) * N * N;
  const int* prow = perms + static_cast<size_t>(q) * N;
  for (int i = threadIdx.x; i < N; i += kThreads) p[i] = prow[i];
  __syncthreads();
  const float f =
      repro_torch::block_objective<kThreads>(C + base, M + base, p, N, red);
  if (threadIdx.x == 0) out[q] = f;
}

}  // namespace

extern "C" int qap_objective_launch(const float* C, const float* M,
                                    const int* perms, float* out,
                                    long long total, int N,
                                    long long perms_per_inst, void* stream) {
  qap_objective_kernel<<<static_cast<unsigned>(total), kThreads,
                         N * sizeof(int), static_cast<cudaStream_t>(stream)>>>(
      C, M, perms, out, N, perms_per_inst);
  return static_cast<int>(cudaGetLastError());
}
