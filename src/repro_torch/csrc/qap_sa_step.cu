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
// Layout: one block per chain.  The TPU kernel kept C, C^T, M and M^T
// resident in VMEM (4 n_pad^2 floats), which cannot fit in 227 KB of
// shared memory from n ~ 120 up.  Here the four matrices stay in global
// memory and L2 -- 4 x 64 KB per instance at the 128 bucket, 8 MB for a
// 32-instance wave, well inside the 50 MB L2 -- and only the chain's p
// and best_p (2N ints) and its candidate stream (K pairs and uniforms)
// sit in shared memory.  The candidate loop is sequential inside the
// block; each candidate's delta is a block reduction in a fixed order
// (warp butterflies, then the warp sums in warp order), so every thread
// holds the same d and takes the same accept decision without a
// broadcast.
//
// What bounds it on an H100: memory traffic, L2 after the first touch.
// Each candidate reads 8 rows of N floats (4 KB at N = 128); a 512-chain
// step of 25 candidates moves about 52 MB through L2 against 8.4 MB of
// unique bytes in device memory, and a block's sequential dependency
// (the next candidate scores against the state this one left) keeps
// per-block parallelism to N threads.  The design answers the bound with
// one launch per temperature step for the whole wave and no round trips
// of the state through device memory between candidates; overlapping the
// next candidate's row loads (cp.async) is later work.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// Block-wide sum of two values in a fixed order; every thread gets both
// totals.  `red` holds 2 * kWarps floats.
__device__ __forceinline__ void block_sum2(float& x, float& y, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
    y += __shfl_xor_sync(0xffffffffu, y, off);
  }
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
qap_sa_step_kernel(const float* __restrict__ C, const float* __restrict__ CT,
                   const float* __restrict__ M, const float* __restrict__ MT,
                   const int* __restrict__ p_in, const float* __restrict__ f_in,
                   const int* __restrict__ bp_in,
                   const float* __restrict__ bf_in,
                   const float* __restrict__ temp,
                   const uint32_t* __restrict__ keys,
                   const int* __restrict__ n_valid, int* __restrict__ p_out,
                   float* __restrict__ f_out, int* __restrict__ bp_out,
                   float* __restrict__ bf_out, int N, int rows_per_inst,
                   int K, int max_success) {
  extern __shared__ unsigned char smem_raw[];
  int* p = reinterpret_cast<int*>(smem_raw);
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
  const uint32_t k0 = keys[2 * r], k1 = keys[2 * r + 1];
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

extern "C" int qap_sa_step_smem_bytes(int N, int K) {
  return static_cast<int>((2 * N + 3 * K + 2 * kWarps) * sizeof(int));
}

extern "C" int qap_sa_step_launch(const float* C, const float* CT,
                                  const float* M, const float* MT,
                                  const int* p_in, const float* f_in,
                                  const int* bp_in, const float* bf_in,
                                  const float* temp, const uint32_t* keys,
                                  const int* n_valid, int* p_out, float* f_out,
                                  int* bp_out, float* bf_out, int B, int N,
                                  int rows_per_inst, int K, int max_success,
                                  void* stream) {
  const int smem = qap_sa_step_smem_bytes(N, K);
  qap_sa_step_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      C, CT, M, MT, p_in, f_in, bp_in, bf_in, temp, keys, n_valid, p_out,
      f_out, bp_out, bf_out, N, rows_per_inst, K, max_success);
  return static_cast<int>(cudaGetLastError());
}
