// K8: the Mamba selective scan on Hopper.
//
// Replaces the TPU kernel repro/kernels/selective_scan.py
// selective_scan_pallas (body _scan_kernel).  u, dt (B, S, D), a (D, N),
// b, c (B, S, N), all f32 -> y (B, S, D) f32 and h_last (B, D, N) f32:
//
//   h_t = exp(dt_t * a) * h_{t-1} + (dt_t * u_t) * b_t,   h_0 = 0
//   y_t = sum_n h_t[n] * c_t[n]                            (n in order)
//   h_last = h_S
//
// The TPU kernel carried the (512, N) state in VMEM scratch across a
// sequential grid axis of 128-step sequence chunks, asserted D % 512 and
// S % 128, and dropped the final state.  Blocks on Hopper run in no
// order, so the sequence is a loop inside the block instead: one thread
// per (batch row, channel d) keeps h[0..N) and a[d, 0..N) in registers
// for the whole sequence.  A block of 128 threads covers 128 consecutive
// channels of one batch row, so every load of u and dt and every store
// of y is a 512-byte coalesced row.  The block stages b_t and c_t of 64
// time steps at a time in shared memory (8 KB at N = 16), read by all its
// threads.  The ragged edge (D not a multiple of 128, S not a multiple of
// 64) is masked; any S and D are taken.  The final state is in registers
// at the end and is written to h_last, which the prefill hands to decode.
//
// Numerics: built with -fmad=false and accurate expf, each product and
// sum rounded on its own in the order of the plain PyTorch version
// (kernels/selective_scan.py selective_scan_plain): dA = dt * a, exp;
// bx = (dt * u) * b; h = a_bar * h + bx; y += h[n] * c[n] for n = 0..N-1.
//
// What bounds it on an H100: bytes.  At Jamba's full width in the serving
// prefill (B = 4, S = 512, D = 8192, N = 16) the kernel must read u and
// dt and write y, 3 x 67 MB, plus a, b, c and h_last (about 3 MB): some
// 0.061 ms at 3.35 TB/s, against some 1.6 GFLOP (0.024 ms at 67 TFLOP/s
// f32).  This first design is latency-bound instead: the grid is
// (B, D / 128) = 256 blocks of 4 warps on 132 SMs, and each thread walks
// its S steps one after another, 16 independent expf chains deep.
// Splitting N over lanes with a shuffle sum, or several sequence chunks
// per channel with a second pass, are later work.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 128;  // consecutive channels d of one batch row
constexpr int kChunk = 64;     // time steps of b and c staged per pass

template <int N>
__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const float* __restrict__ u,
                      const float* __restrict__ dt,
                      const float* __restrict__ a,
                      const float* __restrict__ b,
                      const float* __restrict__ c, float* __restrict__ y,
                      float* __restrict__ h_last, int S, int D) {
  __shared__ float sb[kChunk * N];
  __shared__ float sc[kChunk * N];
  const int row = blockIdx.x;
  const int d = blockIdx.y * kThreads + threadIdx.x;
  const bool live = d < D;
  float av[N];
  float h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    av[n] = live ? a[static_cast<size_t>(d) * N + n] : 0.f;
    h[n] = 0.f;
  }
  const size_t first = static_cast<size_t>(row) * S;  // (row, t = 0)
  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int steps = min(kChunk, S - t0);
    __syncthreads();  // every thread is done with the previous chunk
    const size_t bc = (first + t0) * N;
    for (int i = threadIdx.x; i < steps * N; i += kThreads) {
      sb[i] = b[bc + i];
      sc[i] = c[bc + i];
    }
    __syncthreads();
    if (live) {
      for (int t = 0; t < steps; ++t) {
        const size_t off = (first + t0 + t) * D + d;
        const float dtv = dt[off];
        const float dtu = dtv * u[off];
        float yv = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const float a_bar = expf(dtv * av[n]);
          h[n] = a_bar * h[n] + dtu * sb[t * N + n];
          yv = yv + h[n] * sc[t * N + n];
        }
        y[off] = yv;
      }
    }
  }
  if (live) {
    float* out = h_last + (static_cast<size_t>(row) * D + d) * N;
#pragma unroll
    for (int n = 0; n < N; ++n) out[n] = h[n];
  }
}

}  // namespace

extern "C" int selective_scan_launch(const float* u, const float* dt,
                                     const float* a, const float* b,
                                     const float* c, float* y, float* h_last,
                                     int B, int S, int D, int N,
                                     void* stream) {
  const dim3 grid(static_cast<unsigned>(B),
                  static_cast<unsigned>((D + kThreads - 1) / kThreads));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 4:
      selective_scan_kernel<4><<<grid, kThreads, 0, st>>>(u, dt, a, b, c, y,
                                                          h_last, S, D);
      break;
    case 16:
      selective_scan_kernel<16><<<grid, kThreads, 0, st>>>(u, dt, a, b, c, y,
                                                           h_last, S, D);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
