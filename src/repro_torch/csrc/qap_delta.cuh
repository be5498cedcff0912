// The O(N) swap delta of one candidate from the rows it reads, as device
// functions shared by the L2 branches of K1 (csrc/qap_delta.cu) and of
// the fused SA step K4 (csrc/qap_sa_step.cu), so that a candidate's delta
// is the same bits in both on any input.
//
//   d = sum_{i != a,b} (C[i,a]-C[i,b]) * (M[p[i],v]-M[p[i],u])     (col)
//     + sum_{i != a,b} (C[a,i]-C[b,i]) * (M[v,p[i]]-M[u,p[i]])     (row)
//     + (C[a,a]-C[b,b])*(M[v,v]-M[u,u]) + C[a,b]*(M[v,u]-M[u,v])
//       + C[b,a]*(M[u,v]-M[v,u])                                  (corner)
//
// with u = p[a], v = p[b].  Every term comes from one of eight rows --
// C[a], C[b], C^T[a], C^T[b], M[u], M[v], M^T[u], M^T[v] -- since C[i,a] =
// C^T[a,i] and M[p[i],v] = M^T[v,p[i]].  Lane i takes i = lane + 32 j,
// sums col and row in j order, and a xor butterfly sums the lanes: the
// shared-memory branches of K1 and K4 run the same partition, the same
// butterfly and the same corner expression, so all four agree bit for bit.
#pragma once

#include <cstddef>

namespace repro_torch {

// The rows a candidate reads, in this order: C[a,:], C[b,:], C^T[a,:],
// C^T[b,:], then the kStagedM it gathers from, M[u,:], M[v,:], M^T[u,:],
// M^T[v,:] (the L2 branches stage these four).
constexpr int kRowsPerCandidate = 8;
constexpr int kStagedM = 4;
constexpr int kFirstStaged = kRowsPerCandidate - kStagedM;

struct CandidateRows {
  const float* r[kRowsPerCandidate];
};

__device__ __forceinline__ CandidateRows candidate_rows(
    const float* c, const float* ct, const float* m, const float* mt, int a,
    int b, int u, int v, int N) {
  const size_t n = static_cast<size_t>(N);
  return {{c + a * n, c + b * n, ct + a * n, ct + b * n, m + u * n,
           m + v * n, mt + u * n, mt + v * n}};
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

// col + row + the corner terms: the lanes' sums by a xor butterfly, so
// that every lane returns the same delta.
__device__ __forceinline__ float delta_finish(float col, float row,
                                              const float* const* x, int a,
                                              int b, int u, int v) {
  const float *ca = x[0], *cb = x[1], *mu = x[4], *mv = x[5];
  col = warp_sum(col);
  row = warp_sum(row);
  const float corner = (ca[a] - cb[b]) * (mv[v] - mu[u]) +
                       ca[b] * (mv[u] - mu[v]) + cb[a] * (mu[v] - mv[u]);
  return col + row + corner;
}

// One candidate's delta from its eight rows and the permutation row
// (shared or global memory alike); every lane of the warp calls it and
// returns the delta.  Four of a lane's i at a time, without a branch: all
// their loads issue before the first term is added, and a term with i in
// {a, b} or past N adds +0 in its place (a running sum from +0 is never
// -0, so the bits are those of skipping it; reads past N are clamped to
// word 0).
__device__ __forceinline__ float delta_from_rows(const float* const* x,
                                                 const int* prow, int a,
                                                 int b, int u, int v, int N) {
  const float *ca = x[0], *cb = x[1], *cta = x[2], *ctb = x[3];
  const float *mu = x[4], *mv = x[5], *mtu = x[6], *mtv = x[7];
  float col = 0.f, row = 0.f;
  for (int i0 = threadIdx.x & 31; i0 < N; i0 += 128) {
    float tc[4], tr[4];
    bool use[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = i0 + 32 * k;
      use[k] = i < N && i != a && i != b;
      const int ii = i < N ? i : 0;
      const int pi = prow[ii];
      tc[k] = (cta[ii] - ctb[ii]) * (mtv[pi] - mtu[pi]);
      tr[k] = (ca[ii] - cb[ii]) * (mv[pi] - mu[pi]);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      col += use[k] ? tc[k] : 0.f;
      row += use[k] ? tr[k] : 0.f;
    }
  }
  return delta_finish(col, row, x, a, b, u, v);
}

// delta_from_rows with the lane's p[lane + 32 j] held in registers (pl[j],
// 0 past N; N <= 32 MAXIT, MAXIT a multiple of kRegGroup), for a warp that
// scores one permutation's candidates in turn: the same terms in the same
// order.  kRegGroup of a lane's i at a time with one uniform branch, the
// loop unrolled, so that every read of a group issues before its first
// term is added and each row's reads sit at fixed offsets from the lane's
// first; the rows are read up to 32 kRegGroup ceil(N / (32 kRegGroup))
// words (padded slots), a term past N or with i in {a, b} adding +0.
constexpr int kRegGroup = 4;

template <int MAXIT>
__device__ __forceinline__ float delta_from_regs(const float* const* x,
                                                 const int (&pl)[MAXIT],
                                                 int a, int b, int u, int v,
                                                 int N) {
  static_assert(MAXIT % kRegGroup == 0, "whole groups of lane-iterations");
  const int lane = threadIdx.x & 31;
  const float *ca = x[0] + lane, *cb = x[1] + lane, *cta = x[2] + lane;
  const float *ctb = x[3] + lane, *mu = x[4], *mv = x[5], *mtu = x[6];
  const float* mtv = x[7];
  float col = 0.f, row = 0.f;
#pragma unroll
  for (int j0 = 0; j0 < MAXIT; j0 += kRegGroup) {
    if (32 * j0 >= N) break;
    float tc[kRegGroup], tr[kRegGroup];
    bool use[kRegGroup];
#pragma unroll
    for (int k = 0; k < kRegGroup; ++k) {
      const int j = j0 + k;
      const int i = lane + 32 * j;
      use[k] = i < N && i != a && i != b;
      const int pi = pl[j];
      tc[k] = (cta[32 * j] - ctb[32 * j]) * (mtv[pi] - mtu[pi]);
      tr[k] = (ca[32 * j] - cb[32 * j]) * (mv[pi] - mu[pi]);
    }
#pragma unroll
    for (int k = 0; k < kRegGroup; ++k) {
      col += use[k] ? tc[k] : 0.f;
      row += use[k] ? tr[k] : 0.f;
    }
  }
  return delta_finish(col, row, x, a, b, u, v);
}

}  // namespace repro_torch
