// Threefry-2x32-20 counter stream as CUDA device functions (kernel K3).
//
// Replaces the in-kernel draws of the TPU package, repro/kernels/prng.py
// (threefry2x32 :57, uniform32 :93, sa_draws :109, ga_draws :157).  Those
// are not a pallas_call of their own: they run inside the fused step
// kernels, and here they run inside csrc/qap_sa_step.cu (SA half) and
// csrc/qap_ga_step.cu (GA half).  Bit for bit the same stream as
// repro_torch/kernels/prng.py:
//
//     draw(j) = threefry2x32(k0, k1, stream_tag, j)
//
// on native uint32_t, where the plain PyTorch form holds the words in
// masked int64.  A draw costs 20 rounds of add/rotate/xor, some 100
// integer operations; the fused SA step makes two per candidate, far
// below the memory traffic of the candidate's O(N) delta, and the fused GA
// step 2 * tournament + 10 per child, against the child's O(N^2) F.
#pragma once

#include <cstdint>

namespace repro_torch {

constexpr uint32_t kStreamSaPair = 1;  // SA candidate swap pairs
constexpr uint32_t kStreamSaAcc = 2;   // SA Metropolis acceptance uniforms
constexpr uint32_t kStreamGaSel = 3;   // GA tournament member indices
constexpr uint32_t kStreamGaCut = 4;   // GA order-crossover cut points
constexpr uint32_t kStreamGaXgate = 5; // GA crossover gate uniforms
constexpr uint32_t kStreamGaMut = 6;   // GA mutation position pairs
constexpr uint32_t kStreamGaMgate = 7; // GA mutation gate uniforms

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ void threefry_rounds(uint32_t& x0, uint32_t& x1,
                                                int r0, int r1, int r2,
                                                int r3) {
  const int rots[4] = {r0, r1, r2, r3};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x0 += x1;
    x1 = rotl32(x1, rots[i]) ^ x0;
  }
}

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t c0, uint32_t c1,
                                             uint32_t& out0, uint32_t& out1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = c0 + k0, x1 = c1 + k1;
  threefry_rounds(x0, x1, 13, 15, 26, 6);
  x0 += k1; x1 += k2 + 1u;
  threefry_rounds(x0, x1, 17, 29, 16, 24);
  x0 += k2; x1 += k0 + 2u;
  threefry_rounds(x0, x1, 13, 15, 26, 6);
  x0 += k0; x1 += k1 + 3u;
  threefry_rounds(x0, x1, 17, 29, 16, 24);
  x0 += k1; x1 += k2 + 4u;
  threefry_rounds(x0, x1, 13, 15, 26, 6);
  x0 += k2; x1 += k0 + 5u;
  out0 = x0;
  out1 = x1;
}

// Top 24 bits times 2^-24: exact in f32.
__device__ __forceinline__ float uniform32(uint32_t bits) {
  return static_cast<float>(bits >> 8) * 5.9604644775390625e-8f;
}

// C(m, 2) without overflowing the intermediate product.
__device__ __forceinline__ int num_pairs(int m) {
  return (m % 2 == 0) ? (m / 2) * (m - 1) : m * ((m - 1) / 2);
}

// Flat index in [0, C(n, 2)) -> pair a < b: an f32 sqrt seeds the row,
// exact integer steps correct it (repro/core/qap.py pair_from_index).
__device__ __forceinline__ void pair_from_index(int idx, int n, int& a,
                                                int& b) {
  const int s = num_pairs(n) - idx;
  int m = static_cast<int>(sqrtf(2.0f * static_cast<float>(s)));
  m = min(max(m, 2), n);
  for (int i = 0; i < 2; ++i) m = (num_pairs(m - 1) >= s) ? m - 1 : m;
  for (int i = 0; i < 2; ++i) m = (m < n && num_pairs(m) < s) ? m + 1 : m;
  a = n - m;
  b = a + 1 + (num_pairs(m) - s);
}

// Candidate j of one SA temperature step (repro/kernels/prng.py sa_draws).
__device__ __forceinline__ void sa_draw(uint32_t k0, uint32_t k1, uint32_t j,
                                        int n_valid, int& a, int& b,
                                        float& u) {
  const int nv2 = max(n_valid, 2);
  uint32_t w0, w1;
  threefry2x32(k0, k1, kStreamSaPair, j, w0, w1);
  pair_from_index(static_cast<int>(w0 % static_cast<uint32_t>(num_pairs(nv2))),
                  nv2, a, b);
  if (n_valid < 2) {
    a = 0;
    b = 0;
  }
  threefry2x32(k0, k1, kStreamSaAcc, j, w0, w1);
  u = uniform32(w0);
}

// The GA half (repro/kernels/prng.py ga_draws), one draw per call, for
// child o of a generation; nv = max(n_valid, 1).
// Tournament candidate c of parent s (0 or 1): a member index in [0, pop).
__device__ __forceinline__ int ga_draw_sel(uint32_t k0, uint32_t k1, int o,
                                           int s, int c, int tournament,
                                           int pop) {
  uint32_t w0, w1;
  threefry2x32(k0, k1, kStreamGaSel,
               static_cast<uint32_t>((o * 2 + s) * tournament + c), w0, w1);
  return static_cast<int>(w0 % static_cast<uint32_t>(pop));
}

// The OX cut points, ordered: c1 <= c2 in [0, nv).
__device__ __forceinline__ void ga_draw_cuts(uint32_t k0, uint32_t k1, int o,
                                             int nv, int& c1, int& c2) {
  uint32_t w0, w1;
  threefry2x32(k0, k1, kStreamGaCut, static_cast<uint32_t>(o), w0, w1);
  const int a = static_cast<int>(w0 % static_cast<uint32_t>(nv));
  const int b = static_cast<int>(w1 % static_cast<uint32_t>(nv));
  c1 = min(a, b);
  c2 = max(a, b);
}

// The crossover gate uniform.
__device__ __forceinline__ float ga_draw_xu(uint32_t k0, uint32_t k1, int o) {
  uint32_t w0, w1;
  threefry2x32(k0, k1, kStreamGaXgate, static_cast<uint32_t>(o), w0, w1);
  return uniform32(w0);
}

// Mutation candidate t of max_mut: positions i, j in [0, nv) and its gate
// uniform.
__device__ __forceinline__ void ga_draw_mut(uint32_t k0, uint32_t k1, int o,
                                            int t, int max_mut, int nv,
                                            int& i, int& j, float& u) {
  const uint32_t idx = static_cast<uint32_t>(o * max_mut + t);
  uint32_t w0, w1;
  threefry2x32(k0, k1, kStreamGaMut, idx, w0, w1);
  i = static_cast<int>(w0 % static_cast<uint32_t>(nv));
  j = static_cast<int>(w1 % static_cast<uint32_t>(nv));
  threefry2x32(k0, k1, kStreamGaMgate, idx, w0, w1);
  u = uniform32(w0);
}

}  // namespace repro_torch
