// K5: one whole GA generation per island, fused, on Hopper.
//
// Replaces the TPU kernel repro/kernels/qap_ga_step.py
// qap_ga_step_pallas_batch (body _ga_step_kernel).  For each island of B:
// n_off children, each from two tournaments (first-minimum rule), an OXS
// parent swap if configured, order crossover under the crossover gate,
// MAX_MUT gated swap mutations, and the child's F (the K2 arithmetic,
// csrc/qap_objective.cuh).  The children replace the worst members, child
// k into the k-th slot of the stable ascending order's tail (ties at the
// cut go to the higher index), and the elitism guard reinstates the
// previous best (first minimum) over the new worst (first maximum) if it
// was lost.  Every draw comes from the Threefry counter stream of the
// island's key words (csrc/threefry.cuh, the GA half of kernel K3), one
// stream tag per operator.  Ring migration crosses islands and stays with
// the caller.
//
// Layout: one block of 128 threads per island.  The TPU kernel kept the
// island's population, C, M and the objective's n_pad^2 temporaries in
// VMEM; at the reference's cap (pop = n = 768) the population alone is
// 2.3 MB, far over the 227 KB of shared memory.  Here the population stays
// in global memory: parents are read from the input buffer, each child is
// built in shared memory and written straight into its slot of the output
// buffer.  The slots depend only on the old fitness, so they are known
// before breeding: a member's rank in the stable ascending order is
// #{j : f[j] < f[i]} + #{j < i : f[j] == f[i]}, and rank pop - n_off + k
// takes child k.  Rows that no child takes are copied across.
//
// Order crossover is integer work: the segment's genes are marked in a
// shared flag array, the kept genes and the free positions are two 0/1
// arrays whose block-wide prefix sums give their ranks, and the r-th kept
// gene is scattered to rank r (no one-hot rank matrices).  Per-child
// shared memory: 6 N ints.  Small sequential parts (tournaments, the four
// mutation swaps, the elitism guard) run on thread 0.
//
// What bounds it on an H100: at the engine's shape (64 islands of 32, 16
// children of order 125 in the 128 bucket) the work is 1024 children x
// (an O(N) crossover + an N^2 objective), 34 MFLOP, and the bytes are the
// wave's C and M (4.2 MB) plus the populations (1 MB) -- a bound of 1.6
// us.  The kernel is latency-bound instead: each island's 16 children run
// one after another, each through some ten block barriers, on 64 of the
// 132 SMs.  Breeding several children per block at once, and keeping the
// population in shared memory where it fits (it does here: 16 KB), are
// later work.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "qap_objective.cuh"
#include "threefry.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxMut = 4;  // core/ga_ops.py MAX_MUT

// In-place inclusive prefix sums of two int arrays of length n: each
// thread scans a contiguous chunk, the chunk totals are scanned across the
// warp with shuffles and across warps in warp order.  tmp: 2 * kWarps ints.
__device__ void block_scan2(int* x, int* y, int n, int* tmp) {
  const int per = (n + kThreads - 1) / kThreads;
  const int lo = min(static_cast<int>(threadIdx.x) * per, n);
  const int hi = min(lo + per, n);
  int sx = 0, sy = 0;
  for (int i = lo; i < hi; ++i) {
    sx += x[i];
    x[i] = sx;
    sy += y[i];
    y[i] = sy;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int ix = sx, iy = sy;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int ox = __shfl_up_sync(0xffffffffu, ix, off);
    const int oy = __shfl_up_sync(0xffffffffu, iy, off);
    if (lane >= off) {
      ix += ox;
      iy += oy;
    }
  }
  if (lane == 31) {
    tmp[warp] = ix;
    tmp[kWarps + warp] = iy;
  }
  __syncthreads();
  int bx = ix - sx, by = iy - sy;
  for (int w = 0; w < warp; ++w) {
    bx += tmp[w];
    by += tmp[kWarps + w];
  }
  for (int i = lo; i < hi; ++i) {
    x[i] += bx;
    y[i] += by;
  }
  __syncthreads();
}

struct Smem {
  float* fit;        // [P] fitness before the generation
  float* nfit;       // [P] fitness after it
  int* slot;         // [n_off] the slot child k replaces
  int* taken;        // [P] 1 where a child replaces the member
  int* child;        // [N] the child being built
  int* seg_gene;     // [N] 1 where the gene lies in p1's segment
  int* keep;         // [N] kept-gene flags, then their prefix sums
  int* avail;        // [N] free-position flags, then their prefix sums
  int* genes;        // [N] p2's genes in fill order
  int* by_rank;      // [N] the kept gene of each rank
  int* sel;          // [2 * tournament] this child's tournament draws
  int* mut_i;        // [kMaxMut]
  int* mut_j;        // [kMaxMut]
  float* mut_u;      // [kMaxMut]
  int* misc;         // [8] parents, cuts, guard results
  float* xu;         // [1]
  float* red;        // [kWarps]
  int* scan_tmp;     // [2 * kWarps]
};

__host__ __device__ inline size_t smem_words(int P, int N, int n_off,
                                             int tournament) {
  return 3 * static_cast<size_t>(P) + n_off + 6 * static_cast<size_t>(N) +
         2 * tournament + 3 * kMaxMut + 8 + 1 + 3 * kWarps;
}

__device__ Smem carve(unsigned char* raw, int P, int N, int n_off,
                      int tournament) {
  float* f = reinterpret_cast<float*>(raw);
  Smem s;
  s.fit = f;
  s.nfit = f + P;
  int* w = reinterpret_cast<int*>(f + 2 * P);
  s.slot = w;
  w += n_off;
  s.taken = w;
  w += P;
  s.child = w;
  w += N;
  s.seg_gene = w;
  w += N;
  s.keep = w;
  w += N;
  s.avail = w;
  w += N;
  s.genes = w;
  w += N;
  s.by_rank = w;
  w += N;
  s.sel = w;
  w += 2 * tournament;
  s.mut_i = w;
  w += kMaxMut;
  s.mut_j = w;
  w += kMaxMut;
  s.mut_u = reinterpret_cast<float*>(w);
  w += kMaxMut;
  s.misc = w;
  w += 8;
  s.xu = reinterpret_cast<float*>(w);
  w += 1;
  s.red = reinterpret_cast<float*>(w);
  w += kWarps;
  s.scan_tmp = w;
  return s;
}

__global__ void __launch_bounds__(kThreads)
qap_ga_step_kernel(const float* __restrict__ C, const float* __restrict__ M,
                   const int* __restrict__ pop_in,
                   const float* __restrict__ fit_in,
                   const uint32_t* __restrict__ keys,
                   const int* __restrict__ n_valid, int* __restrict__ pop_out,
                   float* __restrict__ fit_out, int P, int N,
                   int islands_per_inst, int n_off, int tournament,
                   float p_crossover, float p_mutation, int oxs) {
  extern __shared__ unsigned char smem_raw[];
  const Smem s = carve(smem_raw, P, N, n_off, tournament);
  const int r = blockIdx.x;
  const size_t nn = static_cast<size_t>(N) * N;
  const float* c = C + static_cast<size_t>(r / islands_per_inst) * nn;
  const float* m = M + static_cast<size_t>(r / islands_per_inst) * nn;
  const int* pin = pop_in + static_cast<size_t>(r) * P * N;
  int* pout = pop_out + static_cast<size_t>(r) * P * N;
  const uint32_t k0 = keys[2 * r], k1 = keys[2 * r + 1];
  const int nv_raw = n_valid[r];
  const int nv = max(nv_raw, 1);
  // min(p_mutation * n_valid / MAX_MUT, 1) in f32: the product rounds
  // once (no FMA), the division by 4 is exact.
  const float gate =
      fminf(p_mutation * static_cast<float>(nv_raw) / static_cast<float>(kMaxMut),
            1.0f);

  for (int i = threadIdx.x; i < P; i += kThreads) {
    s.fit[i] = fit_in[static_cast<size_t>(r) * P + i];
    s.nfit[i] = s.fit[i];
  }
  __syncthreads();
  // Replacement slots from the old fitness: the stable ascending rank.
  const int cut = P - n_off;
  for (int i = threadIdx.x; i < P; i += kThreads) {
    const float fi = s.fit[i];
    int rank = 0;
    for (int j = 0; j < P; ++j) {
      const float fj = s.fit[j];
      rank += (fj < fi) || (fj == fi && j < i);
    }
    s.taken[i] = rank >= cut;
    if (rank >= cut) s.slot[rank - cut] = i;
  }
  __syncthreads();
  for (size_t e = threadIdx.x; e < static_cast<size_t>(P) * N; e += kThreads) {
    if (!s.taken[e / N]) pout[e] = pin[e];
  }

  for (int o = 0; o < n_off; ++o) {
    // This child's draws, one per thread.
    const int n_sel = 2 * tournament;
    for (int t = threadIdx.x; t < n_sel + 2 + kMaxMut; t += kThreads) {
      if (t < n_sel) {
        s.sel[t] = repro_torch::ga_draw_sel(k0, k1, o, t / tournament,
                                            t % tournament, tournament, P);
      } else if (t == n_sel) {
        repro_torch::ga_draw_cuts(k0, k1, o, nv, s.misc[2], s.misc[3]);
      } else if (t == n_sel + 1) {
        s.xu[0] = repro_torch::ga_draw_xu(k0, k1, o);
      } else {
        const int q = t - n_sel - 2;
        repro_torch::ga_draw_mut(k0, k1, o, q, kMaxMut, nv, s.mut_i[q],
                                 s.mut_j[q], s.mut_u[q]);
      }
    }
    for (int i = threadIdx.x; i < N; i += kThreads) s.seg_gene[i] = 0;
    __syncthreads();
    if (threadIdx.x == 0) {
      int win[2];
      for (int side = 0; side < 2; ++side) {
        int best = s.sel[side * tournament];
        float bval = s.fit[best];
        for (int t = 1; t < tournament; ++t) {
          const int cand = s.sel[side * tournament + t];
          if (s.fit[cand] < bval) {
            best = cand;
            bval = s.fit[cand];
          }
        }
        win[side] = best;
      }
      if (oxs && s.fit[win[1]] < s.fit[win[0]]) {
        const int t = win[0];
        win[0] = win[1];
        win[1] = t;
      }
      s.misc[0] = win[0];
      s.misc[1] = win[1];
    }
    __syncthreads();
    const int* p1 = pin + static_cast<size_t>(s.misc[0]) * N;
    const int* p2 = pin + static_cast<size_t>(s.misc[1]) * N;
    const int c1 = s.misc[2], c2 = s.misc[3];
    for (int t = c1 + threadIdx.x; t < c2; t += kThreads) s.seg_gene[p1[t]] = 1;
    __syncthreads();
    for (int q = threadIdx.x; q < N; q += kThreads) {
      const bool valid = q < nv;
      const int rot = valid ? (q + c2) % nv : q;
      const int g = p2[rot];
      s.genes[q] = g;
      s.keep[q] = valid && !s.seg_gene[g];
      s.avail[q] = valid && !(rot >= c1 && rot < c2);
      s.by_rank[q] = 0;
    }
    __syncthreads();
    block_scan2(s.keep, s.avail, N, s.scan_tmp);
    for (int q = threadIdx.x; q < N; q += kThreads) {
      const int before = q > 0 ? s.keep[q - 1] : 0;
      if (s.keep[q] != before) s.by_rank[s.keep[q] - 1] = s.genes[q];
    }
    __syncthreads();
    const bool do_x = s.xu[0] < p_crossover;
    for (int q = threadIdx.x; q < N; q += kThreads) {
      int v;
      if (!do_x || (q >= c1 && q < c2)) {
        v = p1[q];
      } else if (q >= nv) {
        v = q;
      } else {
        const int t = (q - c2 + nv) % nv;
        v = s.by_rank[min(max(s.avail[t] - 1, 0), N - 1)];
      }
      s.child[q] = v;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int t = 0; t < kMaxMut; ++t) {
        if (s.mut_u[t] < gate) {
          const int a = s.mut_i[t], b = s.mut_j[t];
          const int va = s.child[a], vb = s.child[b];
          s.child[a] = vb;
          s.child[b] = va;
        }
      }
    }
    __syncthreads();
    const float f =
        repro_torch::block_objective<kThreads>(c, m, s.child, N, s.red);
    const int slot = s.slot[o];
    int* dst = pout + static_cast<size_t>(slot) * N;
    for (int q = threadIdx.x; q < N; q += kThreads) dst[q] = s.child[q];
    if (threadIdx.x == 0) s.nfit[slot] = f;
    __syncthreads();
  }

  // Elitism guard: the previous best (first minimum of the old fitness)
  // replaces the new worst (first maximum) if every member is now worse.
  if (threadIdx.x == 0) {
    int prev_i = 0;
    float mn = s.fit[0];
    for (int i = 1; i < P; ++i) {
      if (s.fit[i] < mn) {
        mn = s.fit[i];
        prev_i = i;
      }
    }
    int worst = 0;
    float mx = s.nfit[0], nmin = s.nfit[0];
    for (int i = 1; i < P; ++i) {
      if (s.nfit[i] > mx) {
        mx = s.nfit[i];
        worst = i;
      }
      nmin = fminf(nmin, s.nfit[i]);
    }
    const bool lost = mn < nmin;
    s.misc[4] = lost;
    s.misc[5] = prev_i;
    s.misc[6] = worst;
    if (lost) s.nfit[worst] = mn;
  }
  __syncthreads();
  if (s.misc[4]) {
    const int* src = pin + static_cast<size_t>(s.misc[5]) * N;
    int* dst = pout + static_cast<size_t>(s.misc[6]) * N;
    for (int q = threadIdx.x; q < N; q += kThreads) dst[q] = src[q];
  }
  for (int i = threadIdx.x; i < P; i += kThreads) {
    fit_out[static_cast<size_t>(r) * P + i] = s.nfit[i];
  }
}

}  // namespace

extern "C" int qap_ga_step_smem_bytes(int P, int N, int n_off,
                                      int tournament) {
  return static_cast<int>(smem_words(P, N, n_off, tournament) * sizeof(int));
}

extern "C" int qap_ga_step_launch(const float* C, const float* M,
                                  const int* pop_in, const float* fit_in,
                                  const uint32_t* keys, const int* n_valid,
                                  int* pop_out, float* fit_out, int B, int P,
                                  int N, int islands_per_inst, int n_off,
                                  int tournament, float p_crossover,
                                  float p_mutation, int oxs, void* stream) {
  const int smem = qap_ga_step_smem_bytes(P, N, n_off, tournament);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        qap_ga_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  qap_ga_step_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      C, M, pop_in, fit_in, keys, n_valid, pop_out, fit_out, P, N,
      islands_per_inst, n_off, tournament, p_crossover, p_mutation, oxs);
  return static_cast<int>(cudaGetLastError());
}
