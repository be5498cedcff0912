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
// partial sums outside the kernel.  Here one block of 512 threads scores
// one permutation.  The block stages the permutation in shared memory (16
// KB at N = 4096; read from global memory when it would not fit in the
// default 48 KB).  The N x D entries of the ELL block are walked flat:
// thread t takes entries e = t, t + 512, ..., row r = e / D, so the loads
// of cols and vals are coalesced and every lane works whatever D is (a
// layout of one warp per row and one lane per entry left 26 of 32 lanes
// idle at the finest level's D = 6, and measured slower than the plain
// version).  Each term is a chained gather: cols[r, d], then p[.] from
// shared memory, then M[p[r], p[.]] from L2 or device memory; the loop is
// unrolled so that several chains are in flight per thread.  The ragged
// edge past N x D is masked by the loop bound.  Each thread sums its
// entries in order and the block sums in the fixed order of block_sum
// (csrc/qap_objective.cuh), so on integer-valued instances F equals the
// plain version bit for bit.
//
// What bounds it on an H100: latency.  At N = 4096, D = 6 one
// permutation touches 4096 x 6 entries (196 KB of ELL) and as many
// scattered 4-byte reads of M (64 MB, larger than the 50 MB L2), some
// 0.1 us of bytes at 3.35 TB/s; the engine scores 1 to 4 permutations
// per launch, so a launch fills 1 to 4 of the 132 SMs and waits on
// dependent loads.  The design keeps one launch for the whole batch;
// several blocks per permutation, with a second pass for the sum, are
// later work.
#include <cuda_runtime.h>

#include <cstddef>

#include "qap_objective.cuh"

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
qap_objective_sparse_kernel(const int* __restrict__ cols,
                            const float* __restrict__ vals,
                            const float* __restrict__ M,
                            const int* __restrict__ perms,
                            float* __restrict__ out, int N, int D,
                            long long perms_per_inst, int staged) {
  extern __shared__ int sp[];
  __shared__ float red[kThreads / 32];
  const long long q = blockIdx.x;
  const long long inst = q / perms_per_inst;
  const int* prow = perms + static_cast<size_t>(q) * N;
  const int* p = prow;
  if (staged) {  // uniform over the block
    for (int i = threadIdx.x; i < N; i += kThreads) sp[i] = prow[i];
    __syncthreads();
    p = sp;
  }
  const size_t ell = static_cast<size_t>(inst) * N * D;
  const int* c = cols + ell;
  const float* w = vals + ell;
  const float* m = M + static_cast<size_t>(inst) * N * N;
  const int total = N * D;
  float acc = 0.f;
#pragma unroll 4
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int r = e / D;
    acc += w[e] * m[static_cast<size_t>(p[r]) * N + p[c[e]]];
  }
  const float f = repro_torch::block_sum<kThreads>(acc, red);
  if (threadIdx.x == 0) out[q] = f;
}

}  // namespace

extern "C" int qap_objective_sparse_launch(const int* cols, const float* vals,
                                           const float* M, const int* perms,
                                           float* out, long long total, int N,
                                           int D, long long perms_per_inst,
                                           int staged, void* stream) {
  const size_t smem = staged ? static_cast<size_t>(N) * sizeof(int) : 0;
  qap_objective_sparse_kernel<<<static_cast<unsigned>(total), kThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      cols, vals, M, perms, out, N, D, perms_per_inst, staged);
  return static_cast<int>(cudaGetLastError());
}
