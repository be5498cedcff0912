// K1: batched O(N) QAP swap deltas on Hopper.
//
// Replaces the TPU kernel repro/kernels/qap_delta.py qap_delta_pallas_batch
// (body _delta_kernel).  B permutations x K candidate swaps -> (B, K) f32:
//
//   d = sum_{k != a,b} (C[k,a]-C[k,b]) * (M[p[k],v]-M[p[k],u])     (col)
//     + sum_{l != a,b} (C[a,l]-C[b,l]) * (M[v,p[l]]-M[u,p[l]])     (row)
//     + (C[a,a]-C[b,b])*(M[v,v]-M[u,u]) + C[a,b]*(M[v,u]-M[u,v])
//       + C[b,a]*(M[u,v]-M[v,u])                                  (corner)
//
// with u = p[a], v = p[b].  C and M are shared (N, N) or instance-batched
// (B0, N, N); permutation row r belongs to instance r / rows_per_inst.
//
// Layout: one warp per candidate, eight candidates per block.  The warp
// walks the contiguous rows C[a,:], C[b,:], C^T[a,:], C^T[b,:] (the
// caller passes C^T and M^T, computed once per solve, so a column of C is
// a row of C^T) and gathers M[u,p[.]], M[v,p[.]], M^T[u,p[.]],
// M^T[v,p[.]] through the permutation row; lanes past N are masked rather
// than padded.  col and row are reduced separately with shuffles, then
// lane 0 adds the corner terms in the reference's order.
//
// What bounds it on an H100: memory.  A wave of 32 instances at the 128
// bucket holds 32 x 4 matrices x 64 KB = 8.4 MB of unique bytes, about
// 2.5 us at 3.35 TB/s, against some 13 MFLOP (512 chains x 25
// candidates x 128 x 8), far below the f32 peak.  Every candidate of one
// chain re-reads rows of the same instance, so after the first touch the
// reads hit the 50 MB L2, and at these sizes the launch itself (a few us)
// is the real cost.  The design keeps the launch count to one per
// event-loop round and per polish round (the whole wave in one grid);
// fusing rounds, or replaying them as a CUDA graph, is later work.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void qap_delta_kernel(const float* __restrict__ C,
                                 const float* __restrict__ CT,
                                 const float* __restrict__ M,
                                 const float* __restrict__ MT,
                                 const int* __restrict__ p,
                                 const int* __restrict__ pairs,
                                 float* __restrict__ out, int B, int K, int N,
                                 int rows_per_inst) {
  const int lane = threadIdx.x & 31;
  const long long q =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (q >= static_cast<long long>(B) * K) return;  // whole warp exits together
  const int r = static_cast<int>(q / K);
  const size_t nn = static_cast<size_t>(N) * N;
  const size_t base = static_cast<size_t>(r / rows_per_inst) * nn;
  const float* c = C + base;
  const float* ct = CT + base;
  const float* m = M + base;
  const float* mt = MT + base;
  const int* prow = p + static_cast<size_t>(r) * N;
  const int a = pairs[2 * q];
  const int b = pairs[2 * q + 1];
  const int u = prow[a];
  const int v = prow[b];
  const float* ca = c + static_cast<size_t>(a) * N;
  const float* cb = c + static_cast<size_t>(b) * N;
  const float* cta = ct + static_cast<size_t>(a) * N;
  const float* ctb = ct + static_cast<size_t>(b) * N;
  const float* mu = m + static_cast<size_t>(u) * N;
  const float* mv = m + static_cast<size_t>(v) * N;
  const float* mtu = mt + static_cast<size_t>(u) * N;
  const float* mtv = mt + static_cast<size_t>(v) * N;

  float col = 0.f, row = 0.f;
  for (int i = lane; i < N; i += 32) {
    if (i == a || i == b) continue;
    const int pi = prow[i];
    col += (cta[i] - ctb[i]) * (mtv[pi] - mtu[pi]);
    row += (ca[i] - cb[i]) * (mv[pi] - mu[pi]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    col += __shfl_xor_sync(0xffffffffu, col, off);
    row += __shfl_xor_sync(0xffffffffu, row, off);
  }
  if (lane == 0) {
    const float muu = m[static_cast<size_t>(u) * N + u];
    const float mvv = m[static_cast<size_t>(v) * N + v];
    const float muv = m[static_cast<size_t>(u) * N + v];
    const float mvu = m[static_cast<size_t>(v) * N + u];
    const float corner = (ca[a] - cb[b]) * (mvv - muu) + ca[b] * (mvu - muv) +
                         cb[a] * (muv - mvu);
    out[q] = col + row + corner;
  }
}

}  // namespace

extern "C" int qap_delta_launch(const float* C, const float* CT,
                                const float* M, const float* MT, const int* p,
                                const int* pairs, float* out, int B, int K,
                                int N, int rows_per_inst, void* stream) {
  const long long total = static_cast<long long>(B) * K;
  const unsigned blocks =
      static_cast<unsigned>((total + kWarpsPerBlock - 1) / kWarpsPerBlock);
  qap_delta_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      C, CT, M, MT, p, pairs, out, B, K, N, rows_per_inst);
  return static_cast<int>(cudaGetLastError());
}
