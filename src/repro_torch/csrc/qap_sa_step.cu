// K4: one whole SA temperature step per chain, fused, on Hopper.
//
// Replaces the TPU kernel repro/kernels/qap_sa_step.py
// qap_sa_step_pallas_batch (body _sa_step_kernel).  For each chain: draw
// max_neighbors candidate swaps and Metropolis uniforms from the Threefry
// counter stream (csrc/threefry.cuh, kernel K3), then scan them in order:
// the O(N) swap delta of K1, accept if d < 0 or u < exp(-d / max(T,
// 1e-9)) while fewer than max_success swaps landed, and track the best
// permutation seen.  Returns (p, f, best_p, best_f); cooling stays with
// the caller.  Rejected candidates never change the state, so this scan
// gives the same result as the acceptance-event loop of the plain version
// (repro_torch/kernels/qap_sa_step.py) on integer-valued instances.
//
// Two branches, chosen on the host by the order (qap_dense_smem.cuh):
//
// * Shared memory, N <= kSmemMaxN: one warp per chain.  The chains of one
//   instance share a block, which stages the instance's C and M once
//   (cp.async, odd row stride, no transposes); each warp keeps its chain's
//   p and best_p in its own slice of shared memory behind them, and each
//   lane also holds its own entries p[lane + 32 j] in registers for the
//   delta loop (unrolled: the kernel is instantiated per ceil(N / 32)).
//   Lanes draw 32 candidates at a time (lane t draws candidate base + t)
//   and hand them out by shuffles; each candidate's delta is lanes over i,
//   a xor butterfly and the corner terms from shared memory.  A butterfly
//   leaves the bitwise same sum in every lane (IEEE addition commutes), so
//   every lane takes the same accept decision; the loop has no block
//   barrier, only __syncwarp around lane 0's swap.  The split: at most
//   floor(SMs / (2 B0)) blocks per instance, each with ceil(chains /
//   blocks) warps (within the shared memory left after the instance), so a
//   wave of 32 instances x 16 chains at the 128 bucket is 64 blocks of 8
//   warps: two chains on each of an SM's four schedulers, which hide each
//   other's latency, and half the staging of one block per SM.  Warps past
//   an instance's last chain exit after staging.
//
// * L2, larger orders (up to the fused steps' 768 cap and beyond): one
//   128-thread block per chain.  C, C^T, M and M^T stay in global memory
//   and L2; the chain's p, best_p and its candidate stream sit in shared
//   memory; each candidate's delta is a block reduction in a fixed order
//   (warp butterflies, then the warp sums in warp order), so every thread
//   holds the same d without a broadcast.
//
// What bounds it on an H100: the bytes are C and M once per instance plus
// the chains' state (4.2 MB + 1 MB for 512 chains at the 128 bucket, 1.6
// us at 3.35 TB/s); the time is the longest chain's sequence of up to K
// candidates, each some 250 dependent instructions of one warp (4
// unrolled shared-memory iterations, 2 x 5 shuffles, a division and an
// expf).  The shared-memory branch takes every read of a candidate from
// shared memory and has no block barrier; the L2 branch makes three
// dependent L2 round trips and several block barriers per candidate.
// Scoring several candidates per round against the current state (the
// event loop's trick) measured slower: the warp is bound by the
// instructions it issues, not by their latency.
#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <cstddef>
#include <cstdint>

#include "qap_dense_smem.cuh"
#include "threefry.cuh"

namespace {

using repro_torch::smem_stride;

constexpr int kThreads = 128;  // L2 branch
constexpr int kWarps = kThreads / 32;
constexpr int kSmemMaxWarps = 16;  // shared-memory branch: chains per block
constexpr unsigned kFull = 0xffffffffu;

// One flag word per instantiation of the shared-memory kernel.
std::atomic<unsigned long long> g_smem_granted[repro_torch::kSmemMaxIters + 1];
std::atomic<unsigned long long> g_l2_granted{0};

// One chain's p and best_p on the shared-memory branch.
size_t chain_state_bytes(int n) {
  return 2 * static_cast<size_t>(n) * sizeof(int);
}

// p, best_p, the K candidates and the reduction slots on the L2 branch.
size_t l2_smem_bytes(int n, int k) {
  const size_t words = 2 * static_cast<size_t>(n) +
                       3 * static_cast<size_t>(k) + 2 * kWarps;
  return words * sizeof(int);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_xor_sync(kFull, x, off);
  }
  return x;
}

template <int ITERS>
__global__ void __launch_bounds__(kSmemMaxWarps * 32)
qap_sa_step_smem_kernel(const float* __restrict__ C,
                        const float* __restrict__ M,
                        const int* __restrict__ p_in,
                        const float* __restrict__ f_in,
                        const int* __restrict__ bp_in,
                        const float* __restrict__ bf_in,
                        const float* __restrict__ temp,
                        const long long* __restrict__ keys,
                        const int* __restrict__ n_valid,
                        int* __restrict__ p_out, float* __restrict__ f_out,
                        int* __restrict__ bp_out, float* __restrict__ bf_out,
                        int N, int rows_per_inst, int K, int max_success,
                        int blocks_per_inst) {
  extern __shared__ float smem[];
  const int s = smem_stride(N);
  float* c = smem;
  float* m = smem + static_cast<size_t>(N) * s;
  const int inst = blockIdx.x / blocks_per_inst;
  const int warp = threadIdx.x >> 5;
  const int chain =
      (blockIdx.x - inst * blocks_per_inst) * (blockDim.x >> 5) + warp;
  const size_t nn = static_cast<size_t>(N) * N;
  repro_torch::stage_instance(c, m, C + inst * nn, M + inst * nn, N);
  if (chain >= rows_per_inst) return;  // whole warp; no block barrier follows

  const int lane = threadIdx.x & 31;
  int* p = reinterpret_cast<int*>(m + static_cast<size_t>(N) * s) +
           static_cast<size_t>(warp) * 2 * N;
  int* bp = p + N;
  const int r = inst * rows_per_inst + chain;
  const size_t row0 = static_cast<size_t>(r) * N;
  int pr[ITERS];  // this lane's p[i], i = lane + 32 j, kept beside p
#pragma unroll
  for (int j = 0; j < ITERS; ++j) {
    const int i = lane + 32 * j;
    pr[j] = 0;
    if (i < N) {
      pr[j] = p_in[row0 + i];
      p[i] = pr[j];
      bp[i] = bp_in[row0 + i];
    }
  }
  __syncwarp();

  // uint32 key words held in int64: the low 32 bits are the word.
  const uint32_t k0 = static_cast<uint32_t>(keys[2 * r]);
  const uint32_t k1 = static_cast<uint32_t>(keys[2 * r + 1]);
  const int nv = n_valid[r];
  float f = f_in[r];
  float bf = bf_in[r];
  const float tsafe = fmaxf(temp[r], 1e-9f);
  int successes = 0;
  for (int base = 0; base < K && successes < max_success; base += 32) {
    int la = 0, lb = 0;
    float lu = 0.f;
    if (base + lane < K) {
      repro_torch::sa_draw(k0, k1, static_cast<uint32_t>(base + lane), nv, la,
                           lb, lu);
    }
    const int count = min(32, K - base);
    for (int t = 0; t < count && successes < max_success; ++t) {
      const int a = __shfl_sync(kFull, la, t);
      const int b = __shfl_sync(kFull, lb, t);
      const float ut = __shfl_sync(kFull, lu, t);
      const int u = p[a], v = p[b];
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
          const float* mp = m + pr[j] * s;
          col += (ci[a] - ci[b]) * (mp[v] - mp[u]);
          row += (ca[i] - cb[i]) * (mv[pr[j]] - mu[pr[j]]);
        }
      }
      col = warp_sum(col);
      row = warp_sum(row);
      const float corner = (ca[a] - cb[b]) * (mv[v] - mu[u]) +
                           ca[b] * (mv[u] - mu[v]) + cb[a] * (mu[v] - mv[u]);
      const float d = col + row + corner;
      if ((d < 0.f) || (ut < expf(-d / tsafe))) {  // the same in every lane
        __syncwarp();  // every lane has read p[a] and p[b]
        if (lane == 0) {
          p[a] = v;
          p[b] = u;
        }
#pragma unroll
        for (int j = 0; j < ITERS; ++j) {
          const int i = lane + 32 * j;
          pr[j] = i == a ? v : (i == b ? u : pr[j]);
        }
        __syncwarp();
        f = f + d;
        ++successes;
        if (f < bf) {
          bf = f;
#pragma unroll
          for (int j = 0; j < ITERS; ++j) {
            const int i = lane + 32 * j;
            if (i < N) bp[i] = pr[j];
          }
        }
      }
    }
  }

  __syncwarp();
#pragma unroll
  for (int j = 0; j < ITERS; ++j) {
    const int i = lane + 32 * j;
    if (i < N) {
      p_out[row0 + i] = pr[j];
      bp_out[row0 + i] = bp[i];
    }
  }
  if (lane == 0) {
    f_out[r] = f;
    bf_out[r] = bf;
  }
}

// Block-wide sum of two values in a fixed order; every thread gets both
// totals.  `red` holds 2 * kWarps floats.
__device__ __forceinline__ void block_sum2(float& x, float& y, float* red) {
  x = warp_sum(x);
  y = warp_sum(y);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[warp] = x;
    red[kWarps + warp] = y;
  }
  __syncthreads();
  x = red[0];
  y = red[kWarps];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    x += red[w];
    y += red[kWarps + w];
  }
}

__global__ void __launch_bounds__(kThreads)
qap_sa_step_l2_kernel(const float* __restrict__ C,
                      const float* __restrict__ CT,
                      const float* __restrict__ M,
                      const float* __restrict__ MT,
                      const int* __restrict__ p_in,
                      const float* __restrict__ f_in,
                      const int* __restrict__ bp_in,
                      const float* __restrict__ bf_in,
                      const float* __restrict__ temp,
                      const long long* __restrict__ keys,
                      const int* __restrict__ n_valid, int* __restrict__ p_out,
                      float* __restrict__ f_out, int* __restrict__ bp_out,
                      float* __restrict__ bf_out, int N, int rows_per_inst,
                      int K, int max_success) {
  extern __shared__ float smem[];
  int* p = reinterpret_cast<int*>(smem);
  int* bp = p + N;
  int* da = bp + N;
  int* db = da + K;
  float* du = reinterpret_cast<float*>(db + K);
  float* red = du + K;

  const int r = blockIdx.x;
  const size_t nn = static_cast<size_t>(N) * N;
  const size_t base = static_cast<size_t>(r / rows_per_inst) * nn;
  const float* c = C + base;
  const float* ct = CT + base;
  const float* m = M + base;
  const float* mt = MT + base;
  const size_t row0 = static_cast<size_t>(r) * N;

  for (int i = threadIdx.x; i < N; i += kThreads) {
    p[i] = p_in[row0 + i];
    bp[i] = bp_in[row0 + i];
  }
  const uint32_t k0 = static_cast<uint32_t>(keys[2 * r]);
  const uint32_t k1 = static_cast<uint32_t>(keys[2 * r + 1]);
  const int nv = n_valid[r];
  for (int t = threadIdx.x; t < K; t += kThreads) {
    repro_torch::sa_draw(k0, k1, static_cast<uint32_t>(t), nv, da[t], db[t],
                         du[t]);
  }
  __syncthreads();

  float f = f_in[r];
  float bf = bf_in[r];
  const float tsafe = fmaxf(temp[r], 1e-9f);
  int successes = 0;
  for (int t = 0; t < K && successes < max_success; ++t) {
    const int a = da[t], b = db[t];
    const int u = p[a], v = p[b];
    const float* ca = c + static_cast<size_t>(a) * N;
    const float* cb = c + static_cast<size_t>(b) * N;
    const float* cta = ct + static_cast<size_t>(a) * N;
    const float* ctb = ct + static_cast<size_t>(b) * N;
    const float* mu = m + static_cast<size_t>(u) * N;
    const float* mv = m + static_cast<size_t>(v) * N;
    const float* mtu = mt + static_cast<size_t>(u) * N;
    const float* mtv = mt + static_cast<size_t>(v) * N;
    float col = 0.f, row = 0.f;
    for (int i = threadIdx.x; i < N; i += kThreads) {
      if (i == a || i == b) continue;
      const int pi = p[i];
      col += (cta[i] - ctb[i]) * (mtv[pi] - mtu[pi]);
      row += (ca[i] - cb[i]) * (mv[pi] - mu[pi]);
    }
    block_sum2(col, row, red);  // its barrier also ends every read of p
    const float muu = mu[u], mvv = mv[v], muv = mu[v], mvu = mv[u];
    const float corner = (ca[a] - cb[b]) * (mvv - muu) + ca[b] * (mvu - muv) +
                         cb[a] * (muv - mvu);
    const float d = col + row + corner;
    const bool accept = (d < 0.f) || (du[t] < expf(-d / tsafe));
    __syncthreads();  // every thread has read red before it is reused
    if (accept) {
      if (threadIdx.x == 0) {
        p[a] = v;
        p[b] = u;
      }
      f = f + d;
      ++successes;
      if (f < bf) {
        bf = f;
        __syncthreads();
        for (int i = threadIdx.x; i < N; i += kThreads) bp[i] = p[i];
      }
      __syncthreads();
    }
  }

  for (int i = threadIdx.x; i < N; i += kThreads) {
    p_out[row0 + i] = p[i];
    bp_out[row0 + i] = bp[i];
  }
  if (threadIdx.x == 0) {
    f_out[r] = f;
    bf_out[r] = bf;
  }
}

}  // namespace

// Dynamic shared memory of the branch that takes order N with K
// candidates (at one chain per block on the shared-memory branch), or -1
// where no branch takes it: the L2 branch's state past 227 KB.
extern "C" long long qap_sa_step_smem_bytes(int N, int K) {
  const size_t need =
      N <= repro_torch::kSmemMaxN
          ? repro_torch::smem_instance_bytes(N) + chain_state_bytes(N)
          : l2_smem_bytes(N, K);
  return need > static_cast<size_t>(repro_torch::kSmemBlockLimit)
             ? -1
             : static_cast<long long>(need);
}

// CT and MT are read only above kSmemMaxN and may be null below it; keys
// are the uint32 words held in int64.
extern "C" int qap_sa_step_launch(const float* C, const float* CT,
                                  const float* M, const float* MT,
                                  const int* p_in, const float* f_in,
                                  const int* bp_in, const float* bf_in,
                                  const float* temp, const long long* keys,
                                  const int* n_valid, int* p_out, float* f_out,
                                  int* bp_out, float* bf_out, int B, int N,
                                  int rows_per_inst, int K, int max_success,
                                  int device, void* stream) {
  if (qap_sa_step_smem_bytes(N, K) < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  repro_torch::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int sms = 0;
  if (N <= repro_torch::kSmemMaxN) {
    return static_cast<int>(repro_torch::with_iters(N, [&](auto iters) {
      constexpr int I = decltype(iters)::value;
      const cudaError_t err = repro_torch::smem_launch_setup(
          reinterpret_cast<const void*>(qap_sa_step_smem_kernel<I>),
          g_smem_granted[I], sms);
      if (err != cudaSuccess) return err;
      const int b0 = B / rows_per_inst;
      const size_t inst_bytes = repro_torch::smem_instance_bytes(N);
      const int fit = static_cast<int>(
          (repro_torch::kSmemBlockLimit - inst_bytes) / chain_state_bytes(N));
      // At most half an SM per instance: two chains on each of an SM's
      // four schedulers hide each other's latency, and half the blocks
      // stage half the bytes.
      const int spread = std::max(1, sms / (2 * b0));
      const int want = (rows_per_inst + spread - 1) / spread;
      const int warps = std::max(1, std::min({want, fit, kSmemMaxWarps}));
      const int per = (rows_per_inst + warps - 1) / warps;
      qap_sa_step_smem_kernel<I>
          <<<static_cast<unsigned>(b0) * per, warps * 32,
             inst_bytes + warps * chain_state_bytes(N), st>>>(
              C, M, p_in, f_in, bp_in, bf_in, temp, keys, n_valid, p_out,
              f_out, bp_out, bf_out, N, rows_per_inst, K, max_success, per);
      return cudaGetLastError();
    }));
  }
  if (CT == nullptr || MT == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = repro_torch::smem_launch_setup(
      reinterpret_cast<const void*>(qap_sa_step_l2_kernel), g_l2_granted, sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  qap_sa_step_l2_kernel<<<B, kThreads, l2_smem_bytes(N, K), st>>>(
      C, CT, M, MT, p_in, f_in, bp_in, bf_in, temp, keys, n_valid, p_out,
      f_out, bp_out, bf_out, N, rows_per_inst, K, max_success);
  return static_cast<int>(cudaGetLastError());
}
