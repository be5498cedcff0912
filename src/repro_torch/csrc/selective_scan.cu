// K8: the Mamba selective scan on Hopper.
//
// Replaces the TPU kernel repro/kernels/selective_scan.py
// selective_scan_pallas (body _scan_kernel).  u, dt (B, S, D), a (D, N),
// b, c (B, S, N), all f32 -> y (B, S, D) f32 and h_last (B, D, N) f32:
//
//   h_t = exp(dt_t * a) * h_{t-1} + (dt_t * u_t) * b_t,   h_0 = 0
//   y_t = sum_n h_t[n] * c_t[n]
//   h_last = h_S
//
// The TPU kernel carried the (512, N) state in VMEM scratch across a
// sequential grid axis of 128-step sequence chunks, asserted D % 512 and
// S % 128, and dropped the final state.  Blocks on Hopper run in no
// order, so the sequence is a loop inside the block instead, and the
// card's B x D x N independent recurrences (524 k at Jamba's prefill) fill
// it without splitting the sequence:
//
//   - N over lanes.  A group of G = kLanes = 2 lanes owns one (batch
//     row, channel d); each lane keeps N / G states of h and of a[d, :] in
//     registers for the whole sequence.  A block of 32 G threads covers 32
//     consecutive channels of one batch row, so the grid is
//     (ceil(D / 32), B): 1024 blocks at the prefill's shape, G times the
//     warps of one thread per channel.  Two lanes of eight states issue
//     the fewest instructions per state at Jamba's d_state of 16; 4 and 8
//     lanes were slower on an H100 (PERF.md).
//   - y by a reduce-scatter.  The group scans G steps, each lane holding
//     its partial sums of the G y_t, then halves them across the group in
//     log2 G shuffle rounds (G - 1 shuffles) so that lane g ends with the
//     whole y of step g and stores it; a butterfly per step would take
//     G log2 G.  A ragged chunk's last steps use the butterfly.
//   - Every operand staged.  The block copies the u and dt tiles (32 steps
//     x 32 channels) and b and c (32 steps x N) of the next chunk into
//     shared memory with cp.async while it scans the current one, two
//     buffers of 12 KB at N = 16; no step waits on device memory.  The
//     copies are 16 bytes where D % 4 == 0 and the inputs are 16-byte
//     aligned (the prefill's case), else 4 bytes: the copy's own index
//     arithmetic is a cost every thread pays.
//
// The ragged edge (D not a multiple of 32, S not a multiple of 32) is
// masked; any S and D are taken.  The final state is in registers at the
// end and is written to h_last, which the prefill hands to decode.
//
// Numerics: built with -fmad=false and accurate expf, each product and
// sum of h rounded on its own in the order of the plain PyTorch version
// (kernels/selective_scan.py selective_scan_plain): dA = dt * a, exp;
// bx = (dt * u) * b; h = a_bar * h + bx.  So h, and h_last, equal the
// plain version's bit for bit; y sums its N products in another order
// (in order within a lane, then across the group), within 2e-4 of its
// largest magnitude of the plain version's in-order sum.
//
// What bounds it on an H100: at Jamba's full width in the serving prefill
// (B = 4, S = 512, D = 8192, N = 16) the kernel must read u and dt and
// write y, 3 x 67 MB, plus a, b, c and h_last (about 3 MB): some 0.061 ms
// at 3.35 TB/s.  Its 268 M accurate expf are each one special-function
// op (16 a clock per SM: 0.064 ms at 1.98 GHz) plus seven f32 ops of
// range reduction and a shift; with the update, the sum and the step's
// share of loads and shuffles, a state's step is some 17 instructions (12
// of them f32) at G = 2, 4.6 G in all: about 0.135 ms at one warp
// instruction a clock per scheduler and 1.98 GHz.  Instruction issue,
// not bytes, is the floor of this design.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "qap_dense_smem.cuh"

namespace {

constexpr int kChannels = 32;  // consecutive channels d of a block
constexpr int kChunk = 32;     // time steps staged per buffer
constexpr int kLanes = 2;      // lanes G a channel

template <int N>
struct __align__(16) Stage {
  float u[kChunk][kChannels];
  float dt[kChunk][kChannels];
  float b[kChunk][N];
  float c[kChunk][N];
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// Copy W floats (4: one 16-byte copy, 1: one 4-byte copy).
template <int W>
__device__ __forceinline__ void copy(float* dst, const float* src) {
  if constexpr (W == 4) {
    cp_async16(dst, src);
  } else {
    repro_torch::cp_async4(dst, src);
  }
}

// Copy the operands of steps [t0, t0 + steps) into st, W floats a copy
// (W = 4 needs D % 4 == 0 and 16-byte aligned inputs); every thread of the
// block calls it, and it commits one cp.async group.
template <int N, int W>
__device__ __forceinline__ void stage_chunk(
    Stage<N>& st, const float* __restrict__ u, const float* __restrict__ dt,
    const float* __restrict__ b, const float* __restrict__ c, size_t first,
    int t0, int steps, int d0, int D) {
  constexpr int per_step = kChannels / W;
  for (int i = threadIdx.x; i < steps * per_step; i += blockDim.x) {
    const int t = i / per_step;
    const int k = i % per_step * W;
    if (d0 + k < D) {
      const size_t off = (first + t0 + t) * D + d0 + k;
      copy<W>(&st.u[t][k], u + off);
      copy<W>(&st.dt[t][k], dt + off);
    }
  }
  const size_t bc = (first + t0) * N;
  for (int i = threadIdx.x * W; i < steps * N; i += blockDim.x * W) {
    copy<W>(&st.b[0][0] + i, b + bc + i);
    copy<W>(&st.c[0][0] + i, c + bc + i);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Sum over the G lanes of a group (aligned, G a power of two); every lane
// gets the same bits.
template <int G>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

// yp[s] is lane g's part of step s's sum, s < G; returns the whole sum of
// step g.  Each round halves the steps a lane keeps and sends the other
// half to its partner: log2 G rounds of G - 1 shuffles in all, against G
// butterflies of log2 G for G steps.
template <int G>
__device__ __forceinline__ float reduce_scatter(float (&yp)[G], int g) {
#pragma unroll
  for (int half = G / 2; half > 0; half >>= 1) {
    const bool hi = g & half;  // keeps the upper half of its steps
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float keep = hi ? yp[i + half] : yp[i];
      const float send = hi ? yp[i] : yp[i + half];
      yp[i] = keep + __shfl_xor_sync(0xffffffffu, send, half);
    }
  }
  return yp[0];
}

template <int N>
__global__ void __launch_bounds__(kChannels * kLanes)
selective_scan_kernel(const float* __restrict__ u,
                      const float* __restrict__ dt,
                      const float* __restrict__ a,
                      const float* __restrict__ b,
                      const float* __restrict__ c, float* __restrict__ y,
                      float* __restrict__ h_last, int S, int D,
                      bool vec) {
  constexpr int G = kLanes;
  constexpr int P = N / G;  // states a lane
  __shared__ Stage<N> stage[2];
  const int row = blockIdx.y;
  const int d0 = blockIdx.x * kChannels;
  const int ch = threadIdx.x / G;
  const int g = threadIdx.x % G;
  const int d = d0 + ch;
  const bool live = d < D;
  float av[P];
  float h[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    av[j] = live ? a[static_cast<size_t>(d) * N + g * P + j] : 0.f;
    h[j] = 0.f;
  }
  const size_t first = static_cast<size_t>(row) * S;  // (row, t = 0)
  const int chunks = (S + kChunk - 1) / kChunk;
  auto stage_steps = [&](Stage<N>& st, int t0) {
    const int steps = min(kChunk, S - t0);
    if (vec) {
      stage_chunk<N, 4>(st, u, dt, b, c, first, t0, steps, d0, D);
    } else {
      stage_chunk<N, 1>(st, u, dt, b, c, first, t0, steps, d0, D);
    }
  };
  stage_steps(stage[0], 0);
  for (int ci = 0; ci < chunks; ++ci) {
    const int t0 = ci * kChunk;
    const int steps = min(kChunk, S - t0);
    if (ci + 1 < chunks) {
      stage_steps(stage[(ci + 1) & 1], t0 + kChunk);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();  // chunk ci has landed for every thread
    const Stage<N>& st = stage[ci & 1];
    // Step t: update this lane's P states, return its part of y_t.
    auto step = [&](int t) {
      const float dtv = st.dt[t][ch];
      const float dtu = dtv * st.u[t][ch];
      float yv = 0.f;
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const float a_bar = expf(dtv * av[j]);
        h[j] = a_bar * h[j] + dtu * st.b[t][g * P + j];
        const float hc = h[j] * st.c[t][g * P + j];
        yv = j == 0 ? hc : yv + hc;
      }
      return yv;
    };
    // Dead channels (d >= D) scan what their slots hold and store
    // nothing: every lane takes part in the group's shuffles.
    int t = 0;
    for (; t + G <= steps; t += G) {
      float yp[G];
#pragma unroll
      for (int s = 0; s < G; ++s) yp[s] = step(t + s);
      const float yv = reduce_scatter<G>(yp, g);  // y of step t + g
      if (live) y[(first + t0 + t + g) * D + d] = yv;
    }
    for (; t < steps; ++t) {  // a ragged chunk's last steps
      const float yv = group_sum<G>(step(t));
      if (live && g == 0) y[(first + t0 + t) * D + d] = yv;
    }
    __syncthreads();  // the next pass refills this buffer
  }
  if (live) {
    float* out = h_last + (static_cast<size_t>(row) * D + d) * N + g * P;
#pragma unroll
    for (int j = 0; j < P; ++j) out[j] = h[j];
  }
}

template <int N>
cudaError_t launch(const float* u, const float* dt, const float* a,
                   const float* b, const float* c, float* y, float* h_last,
                   int B, int S, int D, cudaStream_t stream) {
  static_assert(N % kLanes == 0 && (kLanes & (kLanes - 1)) == 0,
                "kLanes lanes a channel, a power of two dividing N");
  const dim3 grid(static_cast<unsigned>((D + kChannels - 1) / kChannels),
                  static_cast<unsigned>(B));
  auto aligned = [](const float* x) {
    return reinterpret_cast<uintptr_t>(x) % 16 == 0;
  };
  const bool vec = D % 4 == 0 && aligned(u) && aligned(dt) && aligned(b) &&
                   aligned(c);
  selective_scan_kernel<N><<<grid, kChannels * kLanes, 0, stream>>>(
      u, dt, a, b, c, y, h_last, S, D, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" int selective_scan_launch(const float* u, const float* dt,
                                     const float* a, const float* b,
                                     const float* c, float* y, float* h_last,
                                     int B, int S, int D, int N, int device,
                                     void* stream) {
  repro_torch::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (N == 4) {
    err = launch<4>(u, dt, a, b, c, y, h_last, B, S, D, st);
  } else if (N == 16) {
    err = launch<16>(u, dt, a, b, c, y, h_last, B, S, D, st);
  }
  return static_cast<int>(err);
}
