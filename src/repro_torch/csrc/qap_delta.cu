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
// * L2, orders above kSmemMaxN (the engine's exact-size requests of
//   170-255 processes, Table 1's tai175/343/729; the caller passes C^T
//   and M^T, made once per solve, so that every row a candidate reads is
//   contiguous).  A block takes one permutation row and a contiguous
//   slice of its candidates: floor(SMs / B) blocks a row, at least one
//   and at most one a candidate, so that Table 1's 32 x 50 and the
//   polish's 1 x 256 each fill 128 SMs.  The block stages its
//   permutation row in shared memory once; warp w takes candidates w,
//   w + warps, ... of the slice, and stages the four rows each one
//   gathers from -- M[u], M[v], M^T[u], M^T[v] -- into a set of its own
//   row slots by 16-byte cp.async (a row keeps its place within 16
//   bytes, so only its ragged head and tail move a word at a time); the
//   rows C[a], C[b], C^T[a], C^T[b] are read in place, coalesced (lane i
//   reads word i + 32 j: the lane partition that keeps the two branches'
//   bits equal rules out wider loads).  With two sets the next
//   candidate's rows land while this one is summed.  The gathers
//   M[u, p[i]] then hit shared-memory banks (some 3.5 wavefronts each)
//   instead of up to 32 L1 lines of a row of global memory.  The warps a
//   block and the sets a warp are decided on the host by one function
//   (kernels/qap_delta.py l2_plan): 16 warps with two sets up to order
//   445, one set and up to 16 warps above (more warps measured faster
//   than two sets at tai729), and, for orders where not even one warp's
//   one set fits (N >= 11,618), the same kernel reading its rows in
//   place through L1 and L2, counted apart ("qap_delta/l2_unstaged").
//
// Both branches compute each lane's partial sums in the same order, the
// same butterfly and the same corner expression, so they agree with each
// other bit for bit on any input, and with the plain version on
// integer-valued instances (whose sums are exact in any order).
//
// What bounds it on an H100: the bytes are C and M once per instance (4.2
// MB for a 32-instance wave at the 128 bucket, 1.3 us at 3.35 TB/s); the
// operations (8 per candidate and i) are far below the f32 peak.  The
// shared-memory branch stages 17 MB and then reads shared memory, where
// the four gathers through p land on random banks (some 3.5 wavefronts
// each against 1 for the four reads of C), so it is bound by shared-memory
// wavefronts.  The L2 branch moves eight rows a candidate from L2 (37 MB
// for Table 1's 1600 candidates on tai729: a few microseconds at L2
// rates, against 1.3 us for C and M once from HBM).  At these sizes the
// launch and the wrapper's issue cost are a large part of a call.
#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <cstddef>

#include "qap_delta.cuh"
#include "qap_dense_smem.cuh"

namespace {

using repro_torch::CandidateRows;
using repro_torch::candidate_rows;
using repro_torch::delta_from_rows;
using repro_torch::kFirstStaged;
using repro_torch::kRowsPerCandidate;
using repro_torch::kStagedM;
using repro_torch::smem_stride;
using repro_torch::warp_sum;

constexpr int kSmemWarps = 32;  // shared-memory branch
constexpr int kL2MaxWarps = 16;  // L2 branch

// One flag word per instantiation of the shared-memory kernel, one for
// the staged L2 kernel.
std::atomic<unsigned long long> g_smem_granted[repro_torch::kSmemMaxIters + 1];
std::atomic<unsigned long long> g_l2_granted;

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

// Shared memory of a staged L2 block: the permutation row's slot and
// `sets` sets of the kStagedM row slots for each of its warps.
constexpr size_t l2_block_bytes(int n, int warps, int sets) {
  return sizeof(float) * repro_torch::row_slot_words(n) *
         (1 + static_cast<size_t>(warps) * sets * kStagedM);
}

// L2 branch.  Block = (permutation row, contiguous slice of its K
// candidates); warp w takes candidates first + w, first + w + warps, ...
// kStaged: the block stages its permutation row once, and each warp
// stages the four rows of M its candidate gathers from into one of its
// `sets` slot sets (two: the next candidate's rows land while this one
// is summed); the rows of C are read in place, coalesced.  !kStaged
// (orders whose one set does not fit): every row and p read in place,
// through L1 and L2.
template <bool kStaged>
__global__ void __launch_bounds__(kL2MaxWarps * 32)
qap_delta_l2_kernel(const float* __restrict__ C, const float* __restrict__ CT,
                    const float* __restrict__ M, const float* __restrict__ MT,
                    const int* __restrict__ p, const int* __restrict__ pairs,
                    float* __restrict__ out, int K, int N, int rows_per_inst,
                    int blocks_per_row, int sets) {
  extern __shared__ __align__(16) float rows_smem[];
  const int r = blockIdx.x / blocks_per_row;
  const int part = blockIdx.x - r * blocks_per_row;
  const int chunk = (K + blocks_per_row - 1) / blocks_per_row;
  const int end = min(K, (part + 1) * chunk);
  const int warps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t base =
      static_cast<size_t>(r / rows_per_inst) * static_cast<size_t>(N) * N;
  const float *c = C + base, *ct = CT + base, *m = M + base, *mt = MT + base;
  const int* prow = p + static_cast<size_t>(r) * N;
  const int2* ab = reinterpret_cast<const int2*>(pairs) +
                   static_cast<size_t>(r) * K;
  float* dst = out + static_cast<size_t>(r) * K;
  int k = part * chunk + (threadIdx.x >> 5);

  if (!kStaged) {
    for (; k < end; k += warps) {
      const int a = ab[k].x, b = ab[k].y, u = prow[a], v = prow[b];
      const CandidateRows g = candidate_rows(c, ct, m, mt, a, b, u, v, N);
      const float d = delta_from_rows(g.r, prow, a, b, u, v, N);
      if (lane == 0) dst[k] = d;
    }
    return;
  }

  const int w = repro_torch::row_slot_words(N);
  int* ps = reinterpret_cast<int*>(rows_smem);
  repro_torch::stage_row(ps, prow, N, threadIdx.x, blockDim.x);
  repro_torch::cp_async_commit();
  repro_torch::cp_async_wait<0>();
  __syncthreads();
  const int* pr = ps + repro_torch::row_shift(prow);
  float* mine = rows_smem + w + (threadIdx.x >> 5) * sets * kStagedM * w;
  auto issue = [&](int kk, int set) {
    const int a = ab[kk].x, b = ab[kk].y;
    const CandidateRows g =
        candidate_rows(c, ct, m, mt, a, b, pr[a], pr[b], N);
    float* s = mine + set * kStagedM * w;
#pragma unroll
    for (int j = 0; j < kStagedM; ++j) {
      repro_torch::stage_row(s + j * w, g.r[kFirstStaged + j], N, lane, 32);
    }
    repro_torch::cp_async_commit();
  };
  if (k >= end) return;  // no block barrier follows
  int set = 0;
  issue(k, 0);
  for (; k < end; k += warps) {
    const bool more = k + warps < end;
    if (sets > 1 && more) {
      issue(k + warps, set ^ 1);
      repro_torch::cp_async_wait<1>();
    } else {
      repro_torch::cp_async_wait<0>();
    }
    __syncwarp();
    const int a = ab[k].x, b = ab[k].y, u = pr[a], v = pr[b];
    const CandidateRows g = candidate_rows(c, ct, m, mt, a, b, u, v, N);
    const float* s = mine + set * kStagedM * w;
    const float* x[kRowsPerCandidate];
#pragma unroll
    for (int j = 0; j < kRowsPerCandidate; ++j) {
      x[j] = j < kFirstStaged ? g.r[j]
                              : s + (j - kFirstStaged) * w +
                                    repro_torch::row_shift(g.r[j]);
    }
    const float d = delta_from_rows(x, pr, a, b, u, v, N);
    if (lane == 0) dst[k] = d;
    __syncwarp();  // every lane has read the set before it is refilled
    if (sets > 1) {
      set ^= 1;
    } else if (more) {
      issue(k + warps, 0);
    }
  }
}

}  // namespace

extern "C" int qap_delta_smem_max_n() { return repro_torch::kSmemMaxN; }

// CT and MT are read only above kSmemMaxN and may be null below it.
// l2_warps and l2_sets: the L2 branch's plan for order N
// (kernels/qap_delta.py l2_plan): warps a block and row sets a warp, 0
// for the kernel that reads its rows in place.
extern "C" int qap_delta_launch(const float* C, const float* CT,
                                const float* M, const float* MT, const int* p,
                                const int* pairs, float* out, int B, int K,
                                int N, int rows_per_inst, int l2_warps,
                                int l2_sets, int device, void* stream) {
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
  if (CT == nullptr || MT == nullptr || l2_warps < 1 ||
      l2_warps > kL2MaxWarps || l2_sets < 0 || l2_sets > 2 ||
      (l2_sets > 0 && l2_block_bytes(N, l2_warps, l2_sets) >
                          static_cast<size_t>(repro_torch::kSmemBlockLimit))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (l2_sets == 0) {
    // One warp a candidate, l2_warps to a block, rows read in place.
    const int per = (K + l2_warps - 1) / l2_warps;
    qap_delta_l2_kernel<false>
        <<<static_cast<unsigned>(B) * per, l2_warps * 32, 0, st>>>(
            C, CT, M, MT, p, pairs, out, K, N, rows_per_inst, per, 0);
    return static_cast<int>(cudaGetLastError());
  }
  int sms = 0;
  const cudaError_t err = repro_torch::smem_launch_setup(
      reinterpret_cast<const void*>(qap_delta_l2_kernel<true>), g_l2_granted,
      sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Spread each permutation row over floor(SMs / B) blocks (at least
  // one, at most one a candidate) and give a block no more warps than
  // its slice has candidates: Table 1's 32 x 50 is 128 blocks of 13
  // candidates, the polish's 1 x 256 128 blocks of 2.
  const int per0 = std::max(1, std::min(sms / B, K));
  const int chunk = (K + per0 - 1) / per0;
  const int per = (K + chunk - 1) / chunk;
  const int warps = std::min(l2_warps, chunk);
  qap_delta_l2_kernel<true>
      <<<static_cast<unsigned>(B) * per, warps * 32,
         l2_block_bytes(N, warps, l2_sets), st>>>(
          C, CT, M, MT, p, pairs, out, K, N, rows_per_inst, per, l2_sets);
  return static_cast<int>(cudaGetLastError());
}
