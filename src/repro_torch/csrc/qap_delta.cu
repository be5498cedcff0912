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
// (B0, N, N); permutation row r belongs to instance r / rows_per_inst, so
// the candidates q = r * K + k of one instance are contiguous.
//
// Two branches, chosen on the host by the order (qap_dense_smem.cuh):
//
// * Shared memory, N <= kSmemMaxN (every dense bucket of the engine).  A
//   block takes one instance and a contiguous slice of its candidates,
//   stages C and M into shared memory with cp.async at an odd row stride
//   (no transposes: a column of C is a conflict-free strided read there),
//   then gives one warp to each candidate of its slice in turn.  Lanes
//   take i = lane + 32 j, the loop over j unrolled (the kernel is
//   instantiated per ceil(N / 32)) so that a lane's loads issue together;
//   the permutation row is read from global memory, where L1 keeps it for
//   the K candidates of a chain; a xor butterfly sums col and row, and
//   lane 0 adds the corner terms read from shared memory.  The split:
//   floor(SMs / B0) blocks of 32 warps per instance (at least one, at most
//   one per candidate), so a wave of 32 instances at the 128 bucket is
//   128 blocks, one per SM, each staging its 132 KB once and scoring 100
//   candidates (event round, 512 x 25) or 64 (polish, 32 x 256), and the
//   64 and 32 buckets' 3-request waves spread over 132 blocks, whose
//   staging then runs in parallel.
//
// * L2, larger orders.  One warp per candidate, eight to a block; the warp
//   walks the contiguous rows C[a,:], C[b,:], C^T[a,:], C^T[b,:] (the
//   caller passes C^T and M^T, made once per solve) and gathers M[u,p[.]],
//   M[v,p[.]], M^T[u,p[.]], M^T[v,p[.]] through the permutation row.
//
// Both branches compute each lane's partial sums in the same order, the
// same butterfly and the same corner expression, so they agree with each
// other bit for bit on any input, and with the plain version on
// integer-valued instances (whose sums are exact in any order).
//
// What bounds it on an H100: the bytes are C and M once per instance (4.2
// MB for a 32-instance wave at the 128 bucket, 1.3 us at 3.35 TB/s); the
// operations (8 per candidate and i) are far below the f32 peak.  The L2
// branch moves 4 KB per candidate through L2 (52 MB per event round); the
// shared-memory branch stages 17 MB and then reads shared memory, where
// the four gathers through p land on random banks (some 3.5 wavefronts
// each against 1 for the four reads of C), so it is bound by shared-memory
// wavefronts, and both branches take about the same device time at the
// 128 bucket.  At these sizes the launch and the wrapper's issue cost are
// a large part of a call.
#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <cstddef>

#include "qap_dense_smem.cuh"

namespace {

using repro_torch::smem_stride;

constexpr int kWarpsPerBlock = 8;  // L2 branch
constexpr int kSmemWarps = 32;     // shared-memory branch

// One flag word per instantiation of the shared-memory kernel.
std::atomic<unsigned long long> g_smem_granted[repro_torch::kSmemMaxIters + 1];

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

template <int ITERS>
__global__ void __launch_bounds__(kSmemWarps * 32)
qap_delta_smem_kernel(const float* __restrict__ C, const float* __restrict__ M,
                      const int* __restrict__ p, const int* __restrict__ pairs,
                      float* __restrict__ out, int K, int N, int rows_per_inst,
                      int blocks_per_inst) {
  extern __shared__ float smem[];
  const int s = smem_stride(N);
  float* c = smem;
  float* m = smem + static_cast<size_t>(N) * s;
  const int inst = blockIdx.x / blocks_per_inst;
  const int part = blockIdx.x - inst * blocks_per_inst;
  const size_t nn = static_cast<size_t>(N) * N;
  repro_torch::stage_instance(c, m, C + inst * nn, M + inst * nn, N);

  const long long per_inst = static_cast<long long>(rows_per_inst) * K;
  const long long chunk = (per_inst + blocks_per_inst - 1) / blocks_per_inst;
  const long long first = inst * per_inst + part * chunk;
  const long long end = min(first + chunk, (inst + 1) * per_inst);
  const int lane = threadIdx.x & 31;
  for (long long q = first + (threadIdx.x >> 5); q < end; q += kSmemWarps) {
    const int* prow = p + static_cast<size_t>(q / K) * N;
    const int2 ab = reinterpret_cast<const int2*>(pairs)[q];
    const int a = ab.x, b = ab.y;
    int pi[ITERS];  // p[i] for this lane's i = lane + 32 j
#pragma unroll
    for (int j = 0; j < ITERS; ++j) {
      const int i = lane + 32 * j;
      pi[j] = i < N ? prow[i] : 0;
    }
    const int u = prow[a];
    const int v = prow[b];
    const float* ca = c + a * s;
    const float* cb = c + b * s;
    const float* mu = m + u * s;
    const float* mv = m + v * s;
    float col = 0.f, row = 0.f;
#pragma unroll
    for (int j = 0; j < ITERS; ++j) {
      const int i = lane + 32 * j;
      if (i < N && i != a && i != b) {
        const float* ci = c + i * s;
        const float* mp = m + pi[j] * s;
        col += (ci[a] - ci[b]) * (mp[v] - mp[u]);
        row += (ca[i] - cb[i]) * (mv[pi[j]] - mu[pi[j]]);
      }
    }
    col = warp_sum(col);
    row = warp_sum(row);
    if (lane == 0) {
      const float corner = (ca[a] - cb[b]) * (mv[v] - mu[u]) +
                           ca[b] * (mv[u] - mu[v]) + cb[a] * (mu[v] - mv[u]);
      out[q] = col + row + corner;
    }
  }
}

__global__ void qap_delta_l2_kernel(const float* __restrict__ C,
                                    const float* __restrict__ CT,
                                    const float* __restrict__ M,
                                    const float* __restrict__ MT,
                                    const int* __restrict__ p,
                                    const int* __restrict__ pairs,
                                    float* __restrict__ out, int B, int K,
                                    int N, int rows_per_inst) {
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
  col = warp_sum(col);
  row = warp_sum(row);
  if (lane == 0) {
    const float corner = (ca[a] - cb[b]) * (mv[v] - mu[u]) +
                         ca[b] * (mv[u] - mu[v]) + cb[a] * (mu[v] - mv[u]);
    out[q] = col + row + corner;
  }
}

}  // namespace

extern "C" int qap_delta_smem_max_n() { return repro_torch::kSmemMaxN; }

// CT and MT are read only above kSmemMaxN and may be null below it.
extern "C" int qap_delta_launch(const float* C, const float* CT,
                                const float* M, const float* MT, const int* p,
                                const int* pairs, float* out, int B, int K,
                                int N, int rows_per_inst, int device,
                                void* stream) {
  repro_torch::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= repro_torch::kSmemMaxN) {
    const int b0 = B / rows_per_inst;
    const long long per_inst = static_cast<long long>(rows_per_inst) * K;
    return static_cast<int>(repro_torch::with_iters(N, [&](auto iters) {
      constexpr int I = decltype(iters)::value;
      int sms = 0;
      const cudaError_t err = repro_torch::smem_launch_setup(
          reinterpret_cast<const void*>(qap_delta_smem_kernel<I>),
          g_smem_granted[I], sms);
      if (err != cudaSuccess) return err;
      // Spread each instance over floor(SMs / B0) blocks, one candidate
      // at least each: a small wave's blocks then stage in parallel.
      const int per = static_cast<int>(std::max(
          1LL, std::min(static_cast<long long>(sms / b0), per_inst)));
      qap_delta_smem_kernel<I>
          <<<static_cast<unsigned>(b0) * per, kSmemWarps * 32,
             repro_torch::smem_instance_bytes(N), st>>>(
              C, M, p, pairs, out, K, N, rows_per_inst, per);
      return cudaGetLastError();
    }));
  }
  if (CT == nullptr || MT == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long total = static_cast<long long>(B) * K;
  const unsigned blocks =
      static_cast<unsigned>((total + kWarpsPerBlock - 1) / kWarpsPerBlock);
  qap_delta_l2_kernel<<<blocks, kWarpsPerBlock * 32, 0, st>>>(
      C, CT, M, MT, p, pairs, out, B, K, N, rows_per_inst);
  return static_cast<int>(cudaGetLastError());
}
