// K7: batched sparse QAP swap deltas on Hopper.
//
// Replaces the TPU kernel repro/kernels/qap_sparse.py
// qap_delta_sparse_pallas_batch (body _delta_sparse_kernel).  B
// permutations x K candidate swaps -> (B, K) f32, over ELL flows: rows of
// C in cols/vals and rows of C^T in cols_t/vals_t, each (N, D), padding
// entries of value 0 with in-range column ids.  With u = p[a], v = p[b]:
//
//   col    = sum_{k in C^T row a, k != a,b} C[k,a] * (M[p[k],v]-M[p[k],u])
//          - (the same over C^T row b)
//   row    = sum_{l in C row a, l != a,b} C[a,l] * (M[v,p[l]]-M[u,p[l]])
//          - (the same over C row b)
//   corner = (C[a,a]-C[b,b])*(M[v,v]-M[u,u]) + C[a,b]*(M[v,u]-M[u,v])
//          + C[b,a]*(M[u,v]-M[v,u])
//
// the corner entries of C found by lookups in the sparse rows a and b of
// C.  The leaves and M are shared ((N, D), (N, N)) or instance-batched
// ((B0, N, D), (B0, N, N)); permutation row r belongs to instance
// r / rows_per_inst.
//
// The TPU kernel ran one program per candidate with eight ELL rows and
// four M rows streamed by scalar-prefetched index maps, every block padded
// to 128 lanes.  Here a group of G lanes scores one candidate, the whole
// (B, K) batch in one launch: G = 8 for ELL widths D <= 8 (four candidates
// a warp), 16 for D <= 16, else a full warp whose lanes stride over the
// row (the launcher picks G from D).  A lane takes one entry
// of each of the four ELL rows a step and issues every load of the step
// before it sums: the four column ids and weights, then the four p[k],
// then the eight scattered M values.  The column terms gather M[p[k], v]
// and M[p[k], u] from M itself: a scattered read costs one 32-byte sector
// whether it lies in a column of M or a row of M^T, and M alone keeps half
// the bytes hot in L2 (64 MB at N = 4096) and spares the caller a
// transpose per solve.  Lanes 0-3 of the group load the four corner
// entries M[u,u], M[v,v], M[u,v], M[v,u] as soon as u and v are known,
// alongside the ELL rows, so no load waits behind the sums.  The eight
// partial sums are reduced by a butterfly within the group (log2 G levels,
// the same bits in every lane), and lane 0 combines them in the plain
// version's order, so on integer-valued instances the delta equals it bit
// for bit.  Masked terms (k = a or b) are loaded and dropped, not branched
// around; the tail of the last warp scores a copy of the last candidate
// and stores nothing.
//
// What bounds it on an H100: latency and the launch.  A candidate reads
// four ELL rows (at most 4 x 46 x 8 bytes) and about 4 D scattered values
// of M; the engine's refinement scores 4 chains x 16 candidates per launch
// and its polish 1 x 256, so the whole launch moves tens of KB (tens of
// nanoseconds at 3.35 TB/s) and is over in a few microseconds of launch
// and dependent-load latency: pairs -> p[a], p[b] and the ELL rows -> p[k]
// and the corners -> the M gathers -> the butterflies -> the store.  Blocks
// of two warps spread the candidates over as many SMs as there are blocks.
// The design keeps one launch per event-loop round and per polish round;
// fusing rounds is host work.
#include <cuda_runtime.h>

#include <cstddef>

#include "qap_dense_smem.cuh"

namespace {

constexpr int kThreads = 64;  // two warps a block

template <int G>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

template <int G>
__global__ void __launch_bounds__(kThreads) qap_delta_sparse_kernel(
    const int* __restrict__ cols, const float* __restrict__ vals,
    const int* __restrict__ cols_t, const float* __restrict__ vals_t,
    const float* __restrict__ M, const int* __restrict__ p,
    const int2* __restrict__ pairs, float* __restrict__ out,
    long long total, int K, int N, int D, int rows_per_inst) {
  const int lane = threadIdx.x & 31;
  const int sub = lane & (G - 1);
  const long long slot =
      static_cast<long long>(blockIdx.x) * (kThreads / G) + threadIdx.x / G;
  // every lane of a warp takes part in the shuffles: the tail scores a
  // copy of the last candidate
  const long long q = slot < total ? slot : total - 1;
  const int r = static_cast<int>(q / K);
  const size_t inst = static_cast<size_t>(r / rows_per_inst);
  const size_t ell = inst * N * D;
  const float* m = M + inst * N * N;
  const int* prow = p + static_cast<size_t>(r) * N;
  const int2 ab = pairs[q];
  const int a = ab.x;
  const int b = ab.y;
  const int u = prow[a];
  const int v = prow[b];
  // lanes 0-3: M[u,u], M[v,v], M[u,v], M[v,u]
  float corner = 0.f;
  if (sub < 4) {
    const int i = (sub == 0 || sub == 2) ? u : v;
    const int j = (sub == 0 || sub == 3) ? u : v;
    corner = m[static_cast<size_t>(i) * N + j];
  }
  const int* ca = cols + ell + static_cast<size_t>(a) * D;
  const int* cb = cols + ell + static_cast<size_t>(b) * D;
  const float* wa = vals + ell + static_cast<size_t>(a) * D;
  const float* wb = vals + ell + static_cast<size_t>(b) * D;
  const int* ta = cols_t + ell + static_cast<size_t>(a) * D;
  const int* tb = cols_t + ell + static_cast<size_t>(b) * D;
  const float* twa = vals_t + ell + static_cast<size_t>(a) * D;
  const float* twb = vals_t + ell + static_cast<size_t>(b) * D;
  const float* mu = m + static_cast<size_t>(u) * N;
  const float* mv = m + static_cast<size_t>(v) * N;

  float col_a = 0.f, col_b = 0.f, row_a = 0.f, row_b = 0.f;
  float caa = 0.f, cab = 0.f, cba = 0.f, cbb = 0.f;
  for (int d = sub; d < D; d += G) {
    const int ka = ta[d], kb = tb[d];  // column terms: rows a, b of C^T
    const int la = ca[d], lb = cb[d];  // row terms: rows a, b of C
    const float wka = twa[d], wkb = twb[d], wla = wa[d], wlb = wb[d];
    const float* mka = m + static_cast<size_t>(prow[ka]) * N;
    const float* mkb = m + static_cast<size_t>(prow[kb]) * N;
    const int pla = prow[la], plb = prow[lb];
    const float gka = mka[v] - mka[u];
    const float gkb = mkb[v] - mkb[u];
    const float gla = mv[pla] - mu[pla];
    const float glb = mv[plb] - mu[plb];
    if (ka != a && ka != b) col_a += wka * gka;
    if (kb != a && kb != b) col_b += wkb * gkb;
    if (la != a && la != b) row_a += wla * gla;
    if (lb != a && lb != b) row_b += wlb * glb;
    if (la == a) caa += wla;
    if (la == b) cab += wla;
    if (lb == b) cbb += wlb;
    if (lb == a) cba += wlb;
  }
  col_a = group_sum<G>(col_a);
  col_b = group_sum<G>(col_b);
  row_a = group_sum<G>(row_a);
  row_b = group_sum<G>(row_b);
  caa = group_sum<G>(caa);
  cab = group_sum<G>(cab);
  cba = group_sum<G>(cba);
  cbb = group_sum<G>(cbb);
  const int lead = lane & ~(G - 1);
  const float muu = __shfl_sync(0xffffffffu, corner, lead);
  const float mvv = __shfl_sync(0xffffffffu, corner, lead + 1);
  const float muv = __shfl_sync(0xffffffffu, corner, lead + 2);
  const float mvu = __shfl_sync(0xffffffffu, corner, lead + 3);
  if (sub == 0 && slot < total) {
    const float col = col_a - col_b;
    const float row = row_a - row_b;
    const float cor =
        (caa - cbb) * (mvv - muu) + cab * (mvu - muv) + cba * (muv - mvu);
    out[q] = col + row + cor;
  }
}

template <int G>
cudaError_t launch(const int* cols, const float* vals, const int* cols_t,
                   const float* vals_t, const float* M, const int* p,
                   const int* pairs, float* out, long long total, int K,
                   int N, int D, int rows_per_inst, cudaStream_t stream) {
  constexpr int per_block = kThreads / G;
  const unsigned blocks =
      static_cast<unsigned>((total + per_block - 1) / per_block);
  qap_delta_sparse_kernel<G><<<blocks, kThreads, 0, stream>>>(
      cols, vals, cols_t, vals_t, M, p, reinterpret_cast<const int2*>(pairs),
      out, total, K, N, D, rows_per_inst);
  return cudaGetLastError();
}

}  // namespace

extern "C" int qap_delta_sparse_launch(const int* cols, const float* vals,
                                       const int* cols_t, const float* vals_t,
                                       const float* M, const int* p,
                                       const int* pairs, float* out, int B,
                                       int K, int N, int D, int rows_per_inst,
                                       int device, void* stream) {
  repro_torch::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  const long long total = static_cast<long long>(B) * K;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the least group that holds the row, one entry a lane; a strided warp
  // past 16
  cudaError_t err;
  if (D <= 8) {
    err = launch<8>(cols, vals, cols_t, vals_t, M, p, pairs, out, total, K, N,
                    D, rows_per_inst, st);
  } else if (D <= 16) {
    err = launch<16>(cols, vals, cols_t, vals_t, M, p, pairs, out, total, K,
                     N, D, rows_per_inst, st);
  } else {
    err = launch<32>(cols, vals, cols_t, vals_t, M, p, pairs, out, total, K,
                     N, D, rows_per_inst, st);
  }
  return static_cast<int>(err);
}
