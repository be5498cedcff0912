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
// C.  The leaves and M/M^T are shared ((N, D), (N, N)) or instance-batched
// ((B0, N, D), (B0, N, N)); permutation row r belongs to instance
// r / rows_per_inst.
//
// The TPU kernel ran one program per candidate with eight ELL rows and
// four M rows streamed by scalar-prefetched index maps, every block padded
// to 128 lanes.  Here one warp scores one candidate, eight per block, the
// whole (B, K) batch in one launch.  Lanes stride over the D entries of
// the four ELL rows; each term gathers p[k] from the permutation row, then
// M^T[v, p[k]] / M^T[u, p[k]] (a column of M as a row of M^T, which the
// caller makes once per solve) or M[v, p[l]] / M[u, p[l]].  The ragged
// edge past D is masked by the loop bound, not padded.  The eight partial
// sums (four row/column sums, four corner lookups) are reduced by a
// fixed-order butterfly, and lane 0 combines them in the plain version's
// order, so on integer-valued instances the delta equals it bit for bit.
//
// What bounds it on an H100: latency and the launch.  A candidate reads
// four ELL rows (at most 4 x 46 x 8 bytes) and about 4 D scattered values
// of M/M^T; the engine's refinement scores 4 chains x 16 candidates per
// launch and its polish 1 x 256, so the whole launch moves tens of KB
// (tens of nanoseconds at 3.35 TB/s) and is over in a few microseconds of
// launch and dependent-load latency.  The design keeps one launch per
// event-loop round and per polish round; fusing rounds is later work.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

__global__ void qap_delta_sparse_kernel(
    const int* __restrict__ cols, const float* __restrict__ vals,
    const int* __restrict__ cols_t, const float* __restrict__ vals_t,
    const float* __restrict__ M, const float* __restrict__ MT,
    const int* __restrict__ p, const int* __restrict__ pairs,
    float* __restrict__ out, int B, int K, int N, int D, int rows_per_inst) {
  const int lane = threadIdx.x & 31;
  const long long q =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (q >= static_cast<long long>(B) * K) return;  // whole warp exits together
  const int r = static_cast<int>(q / K);
  const size_t inst = static_cast<size_t>(r / rows_per_inst);
  const size_t ell = inst * N * D;
  const size_t mat = inst * N * N;
  const int* prow = p + static_cast<size_t>(r) * N;
  const int a = pairs[2 * q];
  const int b = pairs[2 * q + 1];
  const int u = prow[a];
  const int v = prow[b];
  const int* ca = cols + ell + static_cast<size_t>(a) * D;
  const int* cb = cols + ell + static_cast<size_t>(b) * D;
  const float* wa = vals + ell + static_cast<size_t>(a) * D;
  const float* wb = vals + ell + static_cast<size_t>(b) * D;
  const int* ta = cols_t + ell + static_cast<size_t>(a) * D;
  const int* tb = cols_t + ell + static_cast<size_t>(b) * D;
  const float* twa = vals_t + ell + static_cast<size_t>(a) * D;
  const float* twb = vals_t + ell + static_cast<size_t>(b) * D;
  const float* mu = M + mat + static_cast<size_t>(u) * N;
  const float* mv = M + mat + static_cast<size_t>(v) * N;
  const float* mtu = MT + mat + static_cast<size_t>(u) * N;
  const float* mtv = MT + mat + static_cast<size_t>(v) * N;

  float col_a = 0.f, col_b = 0.f, row_a = 0.f, row_b = 0.f;
  float caa = 0.f, cab = 0.f, cba = 0.f, cbb = 0.f;
  for (int d = lane; d < D; d += 32) {
    int k = ta[d];  // column terms: rows a and b of C^T
    if (k != a && k != b) {
      const int pk = prow[k];
      col_a += twa[d] * (mtv[pk] - mtu[pk]);
    }
    k = tb[d];
    if (k != a && k != b) {
      const int pk = prow[k];
      col_b += twb[d] * (mtv[pk] - mtu[pk]);
    }
    int l = ca[d];  // row terms and corner lookups: rows a and b of C
    float w = wa[d];
    if (l != a && l != b) {
      const int pl = prow[l];
      row_a += w * (mv[pl] - mu[pl]);
    }
    if (l == a) caa += w;
    if (l == b) cab += w;
    l = cb[d];
    w = wb[d];
    if (l != a && l != b) {
      const int pl = prow[l];
      row_b += w * (mv[pl] - mu[pl]);
    }
    if (l == b) cbb += w;
    if (l == a) cba += w;
  }
  col_a = warp_sum(col_a);
  col_b = warp_sum(col_b);
  row_a = warp_sum(row_a);
  row_b = warp_sum(row_b);
  caa = warp_sum(caa);
  cab = warp_sum(cab);
  cba = warp_sum(cba);
  cbb = warp_sum(cbb);
  if (lane == 0) {
    const float muu = mu[u];
    const float mvv = mv[v];
    const float muv = mu[v];
    const float mvu = mv[u];
    const float col = col_a - col_b;
    const float row = row_a - row_b;
    const float corner =
        (caa - cbb) * (mvv - muu) + cab * (mvu - muv) + cba * (muv - mvu);
    out[q] = col + row + corner;
  }
}

}  // namespace

extern "C" int qap_delta_sparse_launch(const int* cols, const float* vals,
                                       const int* cols_t, const float* vals_t,
                                       const float* M, const float* MT,
                                       const int* p, const int* pairs,
                                       float* out, int B, int K, int N, int D,
                                       int rows_per_inst, void* stream) {
  const long long total = static_cast<long long>(B) * K;
  const unsigned blocks =
      static_cast<unsigned>((total + kWarpsPerBlock - 1) / kWarpsPerBlock);
  qap_delta_sparse_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      cols, vals, cols_t, vals_t, M, MT, p, pairs, out, B, K, N, D,
      rows_per_inst);
  return static_cast<int>(cudaGetLastError());
}
