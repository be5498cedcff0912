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
// stream tag per operator, child o's draws at counters of o alone.  Ring
// migration crosses islands and stays with the caller.
//
// The children are independent: a child reads its parents from the old
// population, its slot is known before breeding (a member's rank in the
// stable ascending order of the old fitness is #{j : f[j] < f[i]} +
// #{j < i : f[j] == f[i]}, and rank pop - n_off + k takes child k), and
// only the elitism guard needs every child's F.  Rows that no child takes
// are copied across.  Two branches, chosen on the host by the shapes
// (smem_warps below, the one place the threshold lives):
//
// * Shared memory, where the island's C and M (at the odd row stride of
//   csrc/qap_dense_smem.cuh), its population, its fitness and one warp's
//   scratch fit the 227 KB of a block (the engine's GA: 32 members of
//   order up to 161).  One block per island stages C, M and the
//   population once (cp.async), then breeds up to kSmemWarps children at
//   once, one warp each (a warp takes several children in turn where
//   there are more): lanes make the child's draws, every lane runs the
//   tournaments on the staged fitness, the OX segment's genes become a
//   bitmask in every lane's registers (__reduce_or_sync), the kept genes
//   and the free positions are ranked by ballots and popcounts across the
//   warp (ceil(N / 32) entries a lane), the r-th kept gene is scattered to
//   the r-th free position, lane 0 applies the gated swaps, and the warp
//   scores the child from shared memory (warp_objective) and writes it
//   into its slot.  One block barrier before the guard; no other.  Per
//   warp: the child, its rank array (2 N ints) and its tournament draws.
//
// * L2, the rest (the fused path takes orders up to 768, where pop = n
//   makes the population alone 2.3 MB): one block of 128 threads per
//   island; C, M and the population stay in global memory, each child is
//   built in shared memory by the whole block in turn (block-wide prefix
//   sums rank the kept genes and free positions; thread 0 runs the
//   tournaments and the mutation) and scored from L2 (block_objective).
//
// Both branches consume the same draws in the same order and run integer
// work exactly, so they agree bit for bit with each other on any input
// whose F they sum alike, and with the plain version on integer-valued
// instances.
//
// What bounds it on an H100: at the engine's shape (64 islands of 32, 16
// children of order 125 in the 128 bucket) the work is 1024 children x
// (an O(N) crossover + an N^2 objective), 34 MFLOP, and the bytes are the
// wave's C and M (4.2 MB) plus the populations (1 MB) -- a bound of 1.6
// us.  The L2 branch is latency-bound: 16 children one after another,
// each through some ten block barriers, with F gathered from L2.  The
// shared-memory branch breeds the 16 children at once on 16 warps and
// reads every term of F from shared memory, where the gathers through the
// child land on random banks: it is bound by shared-memory wavefronts
// (some 16 x 128 x 4 x 4.5 = 37 k per island), on 64 of the 132 SMs at
// that shape (one island a block).
#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <cstddef>
#include <cstdint>

#include "qap_dense_smem.cuh"
#include "qap_objective.cuh"
#include "threefry.cuh"

namespace {

using repro_torch::smem_stride;

constexpr int kThreads = 128;  // L2 branch
constexpr int kWarps = kThreads / 32;
constexpr int kSmemWarps = 16;  // shared-memory branch: children at once
constexpr int kMaxMut = 4;      // core/ga_ops.py MAX_MUT
constexpr unsigned kFull = 0xffffffffu;
static_assert(kMaxMut <= 32, "one lane draws each mutation candidate");

// One flag word per instantiation of the shared-memory kernel.
std::atomic<unsigned long long> g_smem_granted[repro_torch::kSmemMaxIters + 1];

// Shared memory of the shared-memory branch: C and M at the odd stride,
// then the population (P N ints), the old and new fitness, the slots, the
// taken flags and three guard words; then per warp the child, its rank
// array and its tournament draws.
size_t smem_fixed_bytes(int P, int N, int n_off) {
  return repro_torch::smem_instance_bytes(N) +
         sizeof(int) * (static_cast<size_t>(P) * N + 3 * static_cast<size_t>(P) +
                        n_off + 3);
}

size_t smem_warp_bytes(int N, int tournament) {
  return sizeof(int) * (2 * static_cast<size_t>(N) + 2 * tournament);
}

// The threshold: the warps the shared-memory branch breeds with, or 0
// where it does not take these shapes (the L2 branch does).
int smem_warps(int P, int N, int n_off, int tournament) {
  if (N > repro_torch::kSmemMaxN) return 0;
  const size_t fixed = smem_fixed_bytes(P, N, n_off);
  const size_t warp = smem_warp_bytes(N, tournament);
  const size_t limit = repro_torch::kSmemBlockLimit;
  if (fixed + warp > limit) return 0;
  return static_cast<int>(std::min<size_t>(
      {static_cast<size_t>(n_off), static_cast<size_t>(kSmemWarps),
       (limit - fixed) / warp}));
}

template <int ITERS>
__global__ void __launch_bounds__(kSmemWarps * 32)
qap_ga_step_smem_kernel(const float* __restrict__ C,
                        const float* __restrict__ M,
                        const int* __restrict__ pop_in,
                        const float* __restrict__ fit_in,
                        const long long* __restrict__ keys,
                        const int* __restrict__ n_valid,
                        int* __restrict__ pop_out, float* __restrict__ fit_out,
                        int P, int N, int islands_per_inst, int n_off,
                        int tournament, float p_crossover, float p_mutation,
                        int oxs) {
  extern __shared__ float smem[];
  const int s = smem_stride(N);
  float* c = smem;
  float* m = c + static_cast<size_t>(N) * s;
  int* pop = reinterpret_cast<int*>(m + static_cast<size_t>(N) * s);
  float* fit = reinterpret_cast<float*>(pop + static_cast<size_t>(P) * N);
  float* nfit = fit + P;
  int* slot = reinterpret_cast<int*>(nfit + P);
  int* taken = slot + n_off;
  int* guard = taken + P;  // lost, previous best, new worst
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  int* child = guard + 3 + warp * (2 * N + 2 * tournament);
  int* by_rank = child + N;  // the kept gene of each rank
  int* sel = by_rank + N;    // this child's tournament draws

  const int r = blockIdx.x;
  const size_t pn = static_cast<size_t>(P) * N;
  const int* pin = pop_in + r * pn;
  int* pout = pop_out + r * pn;
  for (size_t e = threadIdx.x; e < pn; e += blockDim.x) {
    repro_torch::cp_async4(pop + e, pin + e);
  }
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    fit[i] = fit_in[static_cast<size_t>(r) * P + i];
    nfit[i] = fit[i];
  }
  const size_t nn = static_cast<size_t>(N) * N;
  const size_t inst = r / islands_per_inst;
  // waits for the population's copies too
  repro_torch::stage_instance(c, m, C + inst * nn, M + inst * nn, N);

  // Replacement slots from the old fitness: the stable ascending rank.
  const int cut = P - n_off;
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    const float fi = fit[i];
    int rank = 0;
    for (int j = 0; j < P; ++j) {
      const float fj = fit[j];
      rank += (fj < fi) || (fj == fi && j < i);
    }
    taken[i] = rank >= cut;
    if (rank >= cut) slot[rank - cut] = i;
  }
  __syncthreads();
  for (size_t e = threadIdx.x; e < pn; e += blockDim.x) {
    if (!taken[e / N]) pout[e] = pop[e];
  }

  // uint32 key words held in int64: the low 32 bits are the word.
  const uint32_t k0 = static_cast<uint32_t>(keys[2 * r]);
  const uint32_t k1 = static_cast<uint32_t>(keys[2 * r + 1]);
  const int nv_raw = n_valid[r];
  const int nv = max(nv_raw, 1);
  // min(p_mutation * n_valid / MAX_MUT, 1) in f32: the product rounds
  // once (no FMA), the division by 4 is exact.
  const float gate = fminf(
      p_mutation * static_cast<float>(nv_raw) / static_cast<float>(kMaxMut),
      1.0f);
  const int n_sel = 2 * tournament;
  for (int o = warp; o < n_off; o += warps) {
    __syncwarp();  // the previous child's reads of this warp's scratch
    for (int t = lane; t < n_sel; t += 32) {
      sel[t] = repro_torch::ga_draw_sel(k0, k1, o, t / tournament,
                                        t % tournament, tournament, P);
    }
    int c1, c2;
    repro_torch::ga_draw_cuts(k0, k1, o, nv, c1, c2);
    const float xu = repro_torch::ga_draw_xu(k0, k1, o);
    int mi = 0, mj = 0;
    float mu = 0.f;
    if (lane < kMaxMut) {
      repro_torch::ga_draw_mut(k0, k1, o, lane, kMaxMut, nv, mi, mj, mu);
    }
    __syncwarp();
    // Tournaments, the same in every lane.
    int win[2];
    for (int side = 0; side < 2; ++side) {
      int best = sel[side * tournament];
      float bval = fit[best];
      for (int t = 1; t < tournament; ++t) {
        const int cand = sel[side * tournament + t];
        if (fit[cand] < bval) {
          best = cand;
          bval = fit[cand];
        }
      }
      win[side] = best;
    }
    if (oxs && fit[win[1]] < fit[win[0]]) {
      const int t = win[0];
      win[0] = win[1];
      win[1] = t;
    }
    const int* p1 = pop + static_cast<size_t>(win[0]) * N;
    const int* p2 = pop + static_cast<size_t>(win[1]) * N;

    // p1's segment genes as a bitmask of ITERS words, in every lane.
    unsigned seg[ITERS];
#pragma unroll
    for (int w = 0; w < ITERS; ++w) seg[w] = 0u;
#pragma unroll
    for (int j = 0; j < ITERS; ++j) {
      const int t = lane + 32 * j;
      const bool in = t >= c1 && t < c2;
      const int g = in ? p1[t] : 0;
#pragma unroll
      for (int w = 0; w < ITERS; ++w) {
        seg[w] |= __reduce_or_sync(
            kFull, in && (g >> 5) == w ? 1u << (g & 31) : 0u);
      }
    }
    // p2's genes in fill order from c2; the kept ones (not in the
    // segment) and the free positions (outside it), ranked across the
    // warp by ballots.
    int gene[ITERS], rot[ITERS], krank[ITERS], arank[ITERS];
    bool keep[ITERS], avail[ITERS];
    int kbase = 0, abase = 0;
    const unsigned upto = kFull >> (31 - lane);  // lanes 0..lane
#pragma unroll
    for (int j = 0; j < ITERS; ++j) {
      const int q = lane + 32 * j;
      const bool valid = q < nv;
      rot[j] = valid ? (q + c2) % nv : q;
      gene[j] = q < N ? p2[rot[j]] : 0;
      unsigned word = 0u;
#pragma unroll
      for (int w = 0; w < ITERS; ++w) word = (gene[j] >> 5) == w ? seg[w] : word;
      keep[j] = valid && !((word >> (gene[j] & 31)) & 1u);
      avail[j] = valid && !(rot[j] >= c1 && rot[j] < c2);
      const unsigned kb = __ballot_sync(kFull, keep[j]);
      const unsigned ab = __ballot_sync(kFull, avail[j]);
      krank[j] = kbase + __popc(kb & upto);
      arank[j] = abase + __popc(ab & upto);
      kbase += __popc(kb);
      abase += __popc(ab);
      if (q < N) by_rank[q] = 0;
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < ITERS; ++j) {
      if (keep[j]) by_rank[krank[j] - 1] = gene[j];
    }
    __syncwarp();
    // The child: p1 where the crossover gate is shut and on the segment,
    // the identity past n_valid, and the r-th kept gene at the r-th free
    // position in fill order.
    const bool do_x = xu < p_crossover;
#pragma unroll
    for (int j = 0; j < ITERS; ++j) {
      const int q = lane + 32 * j;
      if (q < N) {
        if (!do_x || (q >= c1 && q < c2)) {
          child[q] = p1[q];
        } else if (q >= nv) {
          child[q] = q;
        }
      }
      if (do_x && avail[j]) {
        child[rot[j]] = by_rank[min(max(arank[j] - 1, 0), N - 1)];
      }
    }
    __syncwarp();
    for (int t = 0; t < kMaxMut; ++t) {
      const int a = __shfl_sync(kFull, mi, t);
      const int b = __shfl_sync(kFull, mj, t);
      if (__shfl_sync(kFull, mu, t) < gate) {
        if (lane == 0) {
          const int va = child[a], vb = child[b];
          child[a] = vb;
          child[b] = va;
        }
        __syncwarp();
      }
    }
    int pl[ITERS];
#pragma unroll
    for (int j = 0; j < ITERS; ++j) {
      const int q = lane + 32 * j;
      pl[j] = q < N ? child[q] : 0;
    }
    const float f = repro_torch::warp_objective<ITERS>(c, m, s, pl, N);
    int* dst = pout + static_cast<size_t>(slot[o]) * N;
#pragma unroll
    for (int j = 0; j < ITERS; ++j) {
      const int q = lane + 32 * j;
      if (q < N) dst[q] = pl[j];
    }
    if (lane == 0) nfit[slot[o]] = f;
  }
  __syncthreads();

  // Elitism guard: the previous best (first minimum of the old fitness)
  // replaces the new worst (first maximum) if every member is now worse.
  if (threadIdx.x == 0) {
    int prev_i = 0;
    float mn = fit[0];
    for (int i = 1; i < P; ++i) {
      if (fit[i] < mn) {
        mn = fit[i];
        prev_i = i;
      }
    }
    int worst = 0;
    float mx = nfit[0], nmin = nfit[0];
    for (int i = 1; i < P; ++i) {
      if (nfit[i] > mx) {
        mx = nfit[i];
        worst = i;
      }
      nmin = fminf(nmin, nfit[i]);
    }
    const bool lost = mn < nmin;
    guard[0] = lost;
    guard[1] = prev_i;
    guard[2] = worst;
    if (lost) nfit[worst] = mn;
  }
  __syncthreads();
  if (guard[0]) {
    const int* src = pop + static_cast<size_t>(guard[1]) * N;
    int* dst = pout + static_cast<size_t>(guard[2]) * N;
    for (int q = threadIdx.x; q < N; q += blockDim.x) dst[q] = src[q];
  }
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    fit_out[static_cast<size_t>(r) * P + i] = nfit[i];
  }
}

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
qap_ga_step_l2_kernel(const float* __restrict__ C, const float* __restrict__ M,
                   const int* __restrict__ pop_in,
                   const float* __restrict__ fit_in,
                   const long long* __restrict__ keys,
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
  // uint32 key words held in int64: the low 32 bits are the word.
  const uint32_t k0 = static_cast<uint32_t>(keys[2 * r]);
  const uint32_t k1 = static_cast<uint32_t>(keys[2 * r + 1]);
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

// Dynamic shared memory of the branch that takes these shapes, or -1
// where neither does (the L2 branch's state past 227 KB).
extern "C" int qap_ga_step_smem_bytes(int P, int N, int n_off,
                                      int tournament) {
  const int warps = smem_warps(P, N, n_off, tournament);
  const size_t need =
      warps > 0 ? smem_fixed_bytes(P, N, n_off) +
                      warps * smem_warp_bytes(N, tournament)
                : smem_words(P, N, n_off, tournament) * sizeof(int);
  return need > static_cast<size_t>(repro_torch::kSmemBlockLimit)
             ? -1
             : static_cast<int>(need);
}

// The warps the shared-memory branch breeds with; 0 where the L2 branch
// takes these shapes.
extern "C" int qap_ga_step_smem_warps(int P, int N, int n_off,
                                      int tournament) {
  return smem_warps(P, N, n_off, tournament);
}

extern "C" int qap_ga_step_launch(const float* C, const float* M,
                                  const int* pop_in, const float* fit_in,
                                  const long long* keys, const int* n_valid,
                                  int* pop_out, float* fit_out, int B, int P,
                                  int N, int islands_per_inst, int n_off,
                                  int tournament, float p_crossover,
                                  float p_mutation, int oxs, int device,
                                  void* stream) {
  const int smem = qap_ga_step_smem_bytes(P, N, n_off, tournament);
  if (smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  repro_torch::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int warps = smem_warps(P, N, n_off, tournament);
  if (warps > 0) {
    return static_cast<int>(repro_torch::with_iters(N, [&](auto iters) {
      constexpr int I = decltype(iters)::value;
      int sms = 0;
      const cudaError_t err = repro_torch::smem_launch_setup(
          reinterpret_cast<const void*>(qap_ga_step_smem_kernel<I>),
          g_smem_granted[I], sms);
      if (err != cudaSuccess) return err;
      qap_ga_step_smem_kernel<I><<<B, warps * 32, smem, st>>>(
          C, M, pop_in, fit_in, keys, n_valid, pop_out, fit_out, P, N,
          islands_per_inst, n_off, tournament, p_crossover, p_mutation, oxs);
      return cudaGetLastError();
    }));
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        qap_ga_step_l2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  qap_ga_step_l2_kernel<<<B, kThreads, smem, st>>>(
      C, M, pop_in, fit_in, keys, n_valid, pop_out, fit_out, P, N,
      islands_per_inst, n_off, tournament, p_crossover, p_mutation, oxs);
  return static_cast<int>(cudaGetLastError());
}
