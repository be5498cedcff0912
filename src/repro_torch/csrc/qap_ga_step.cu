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
// * L2, the rest (orders above kSmemMaxN -- the engine's exact-size
//   requests of 170-255 processes, Table 1's fused PGA on tai175/343/729,
//   the GA at its default pop = n up to the fused cap 768 -- and islands
//   past 227 KB).  Four kernels on the caller's stream, one call: (1) rank,
//   one warp a member over (island, group of 8 members): its stable rank
//   by its lanes, the slot it gives a child, or its row copied across;
//   (2) breed, one warp a child over (island, group of up to 4 children):
//   the shared-memory branch's steps with the parents staged by cp.async
//   from L2 and the bitmask in the warp's shared memory (ceil(N / 32)
//   words; no registers can hold 24 of them), the child written to its
//   slot and to a workspace row; (3) K2's L2 tile kernel
//   (csrc/qap_objective_tiles.cuh) over the children, tiled by
//   kernels/qap_objective.py l2_tiling from the order alone, so a child's
//   F is the bits K2 gives it on any input; (4) finish, one block an
//   island: the children's tiles added in tile order into their slots,
//   the guard (first minimum and maximum by warp butterflies that keep
//   the lower index on ties) and its row copy.  No host sync and nothing
//   allocated: the wrapper passes the workspace, and the call can be
//   captured in a CUDA graph.  No block barrier in the rank and breed
//   kernels.
//
// Both branches consume the same draws in the same order and run integer
// work exactly, so they agree bit for bit with the plain version on
// integer-valued instances (whose F is exact in any order); on real-valued
// ones the L2 branch's F is K2's.
//
// What bounds it on an H100: at the engine's shape (64 islands of 32, 16
// children of order 125 in the 128 bucket) the work is 1024 children x
// (an O(N) crossover + an N^2 objective), 34 MFLOP, and the bytes are the
// wave's C and M (4.2 MB) plus the populations (1 MB) -- a bound of 1.6
// us.  The shared-memory branch breeds the 16 children at once on 16 warps
// and reads every term of F from shared memory, where the gathers through
// the child land on random banks: it is bound by shared-memory wavefronts
// (some 16 x 128 x 4 x 4.5 = 37 k per island), on 64 of the 132 SMs at
// that shape (one island a block).  The L2 branch is bound by its scoring,
// K2's L2 branch on the children (each moves its N rows of M through L2):
// on an H100, 16 islands of 32 at order 256 take 0.039 ms in a CUDA graph,
// 0.029 of it the tiles; Table 1's fused 4 islands of 128 with 64
// children 0.067 on tai343 and 0.195 on tai729 (0.055 and 0.178 the
// tiles) -- against 0.61, 5.1 and 18.8 ms for one block an island
// building its children one after another.
#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstddef>
#include <cstdint>

#include "qap_dense_smem.cuh"
#include "qap_objective.cuh"
#include "qap_objective_tiles.cuh"
#include "threefry.cuh"

namespace {

using repro_torch::smem_stride;

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

// ---------------------------------------------------------------------
// L2 branch: four kernels on one stream (rank, breed, tile, finish).

constexpr int kRankWarps = 8;        // members a rank block, one a warp
constexpr int kBreedMaxWarps = 4;    // children a breed block, one a warp
constexpr int kFinishThreads = 256;  // one block an island

// Words of one breeding warp's scratch: its two parents (row slots, so
// that they move by 16-byte cp.async), the child, its rank array, the
// segment bitmask (ceil(N / 32) words) and its tournament draws, rounded
// to 16 bytes.
__host__ __device__ constexpr size_t breed_warp_words(int N, int tournament) {
  return (2 * static_cast<size_t>(repro_torch::row_slot_words(N)) +
          2 * static_cast<size_t>(N) + (N + 31) / 32 +
          2 * static_cast<size_t>(tournament) + 3) &
         ~static_cast<size_t>(3);
}

// Replacement slots from the old fitness, one warp a member: block
// (island r, group of kRankWarps members), warp w takes member i = group
// * kRankWarps + w, its lanes count over j its stable ascending rank
// (#{j : f[j] < f[i]} + #{j < i : f[j] == f[i]}), and rank P - n_off + k
// sends child k to row i: slot[r * n_off + k] = i.  A member no child
// replaces has its row copied across by its warp.
__global__ void __launch_bounds__(kRankWarps * 32)
qap_ga_step_rank_kernel(const int* __restrict__ pop_in,
                        const float* __restrict__ fit_in,
                        int* __restrict__ pop_out, int* __restrict__ slot,
                        int P, int N, int n_off, int groups) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x / groups;
  const int i = (blockIdx.x - r * groups) * kRankWarps + (threadIdx.x >> 5);
  if (i >= P) return;
  const float* f = fit_in + static_cast<size_t>(r) * P;
  const float fi = f[i];
  int rank = 0;
  for (int j = lane; j < P; j += 32) {
    const float fj = f[j];
    rank += (fj < fi) || (fj == fi && j < i);
  }
  rank = __reduce_add_sync(kFull, rank);
  const int cut = P - n_off;
  if (rank >= cut) {
    if (lane == 0) slot[static_cast<size_t>(r) * n_off + rank - cut] = i;
    return;
  }
  const size_t row = (static_cast<size_t>(r) * P + i) * N;
#pragma unroll 4
  for (int q = lane; q < N; q += 32) pop_out[row + q] = pop_in[row + q];
}

// One warp a child: block (island r, group of warps children), warp w
// breeds child o = group * warps + w with the shared-memory branch's
// steps, its parents and their fitness read from global memory (L2) and
// its scratch in the warp's own slice of shared memory; the child goes to
// its slot of pop_out and to row r * n_off + o of kids, which the tile
// kernel scores.  No block barrier: warps past n_off exit at once.
__global__ void __launch_bounds__(kBreedMaxWarps * 32)
qap_ga_step_breed_kernel(const int* __restrict__ pop_in,
                         const float* __restrict__ fit_in,
                         const long long* __restrict__ keys,
                         const int* __restrict__ n_valid,
                         const int* __restrict__ slot,
                         int* __restrict__ pop_out, int* __restrict__ kids,
                         int P, int N, int n_off, int tournament,
                         float p_crossover, float p_mutation, int oxs,
                         int groups) {
  extern __shared__ __align__(16) int breed_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int r = blockIdx.x / groups;
  const int o = (blockIdx.x - r * groups) * warps + warp;
  if (o >= n_off) return;
  const int words = (N + 31) / 32;
  const int w = repro_torch::row_slot_words(N);
  int* parents = breed_smem + warp * breed_warp_words(N, tournament);
  int* child = parents + 2 * w;
  int* by_rank = child + N;  // the kept gene of each rank
  unsigned* seg = reinterpret_cast<unsigned*>(by_rank + N);
  int* sel = reinterpret_cast<int*>(seg + words);
  const int* pin = pop_in + static_cast<size_t>(r) * P * N;
  const float* fit = fit_in + static_cast<size_t>(r) * P;

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
  for (int w = lane; w < words; w += 32) seg[w] = 0u;
  for (int q = lane; q < N; q += 32) by_rank[q] = 0;
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
  // The parents, staged: every word of both in flight at once.
  const int* g1 = pin + static_cast<size_t>(win[0]) * N;
  const int* g2 = pin + static_cast<size_t>(win[1]) * N;
  repro_torch::stage_row(parents, g1, N, lane, 32);
  repro_torch::stage_row(parents + w, g2, N, lane, 32);
  repro_torch::cp_async_commit();
  repro_torch::cp_async_wait<0>();
  __syncwarp();
  const int* p1 = parents + repro_torch::row_shift(g1);
  const int* p2 = parents + w + repro_torch::row_shift(g2);

  // p1's segment genes as a bitmask of ceil(N / 32) words.
  for (int t = c1 + lane; t < c2; t += 32) {
    const int g = p1[t];
    atomicOr(seg + (g >> 5), 1u << (g & 31));
  }
  __syncwarp();
  // p2's genes in fill order from c2: the kept ones (not in the segment)
  // ranked across the warp by ballots, the r-th into by_rank[r - 1].
  const unsigned upto = kFull >> (31 - lane);  // lanes 0..lane
  int kbase = 0;
  for (int j0 = 0; j0 < N; j0 += 32) {
    const int q = j0 + lane;
    const bool valid = q < nv;
    const int rot = valid ? (q + c2) % nv : q;
    const int gene = q < N ? p2[rot] : 0;
    const unsigned word =
        static_cast<unsigned>(gene >> 5) < static_cast<unsigned>(words)
            ? seg[gene >> 5]
            : 0u;
    const bool keep = valid && !((word >> (gene & 31)) & 1u);
    const unsigned kb = __ballot_sync(kFull, keep);
    if (keep) by_rank[kbase + __popc(kb & upto) - 1] = gene;
    kbase += __popc(kb);
  }
  __syncwarp();
  // The child: p1 where the crossover gate is shut and on the segment,
  // the identity past n_valid, and the r-th kept gene at the r-th free
  // position (outside the segment) in fill order.
  const bool do_x = xu < p_crossover;
  int abase = 0;
  for (int j0 = 0; j0 < N; j0 += 32) {
    const int q = j0 + lane;
    const bool valid = q < nv;
    const int rot = valid ? (q + c2) % nv : q;
    const bool avail = valid && !(rot >= c1 && rot < c2);
    const unsigned ab = __ballot_sync(kFull, avail);
    const int arank = abase + __popc(ab & upto);
    abase += __popc(ab);
    if (q < N) {
      if (!do_x || (q >= c1 && q < c2)) {
        child[q] = p1[q];
      } else if (q >= nv) {
        child[q] = q;
      }
    }
    if (do_x && avail) child[rot] = by_rank[min(max(arank - 1, 0), N - 1)];
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
  int* dst = pop_out +
             (static_cast<size_t>(r) * P + slot[static_cast<size_t>(r) * n_off + o]) * N;
  int* kid = kids + (static_cast<size_t>(r) * n_off + o) * N;
  for (int q = lane; q < N; q += 32) {
    const int v = child[q];
    dst[q] = v;
    kid[q] = v;
  }
}

// (value, index) of the first minimum (kMax: first maximum) over a
// warp's lanes; idx == kNone marks a lane with no element.
constexpr int kNone = 0x7fffffff;

template <bool kMax>
__device__ __forceinline__ void first_extreme(float& v, int& idx) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, idx, off);
    const bool better = kMax ? ov > v : ov < v;
    if (oi != kNone &&
        (idx == kNone || better || (ov == v && oi < idx))) {
      v = ov;
      idx = oi;
    }
  }
}

// One block an island: the children's F (their tiles added in tile
// order, tile_total) into their slots of the new fitness, then the
// elitism guard: the previous best (first minimum of the old fitness)
// replaces the new worst (first maximum) if every member is now worse.
__global__ void __launch_bounds__(kFinishThreads)
qap_ga_step_finish_kernel(const int* __restrict__ pop_in,
                          const float* __restrict__ fit_in,
                          const int* __restrict__ slot,
                          const float* __restrict__ partial,
                          int* __restrict__ pop_out,
                          float* __restrict__ fit_out, int P, int N,
                          int n_off, int tiles) {
  extern __shared__ float nfit[];  // [P], then guard[3]
  int* guard = reinterpret_cast<int*>(nfit + P);  // lost, best, new worst
  const int r = blockIdx.x;
  const float* fit = fit_in + static_cast<size_t>(r) * P;
  for (int i = threadIdx.x; i < P; i += kFinishThreads) nfit[i] = fit[i];
  __syncthreads();
  for (int k = threadIdx.x; k < n_off; k += kFinishThreads) {
    const size_t q = static_cast<size_t>(r) * n_off + k;
    nfit[slot[q]] = repro_torch::tile_total(partial + q * tiles, tiles);
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float mn = 0.f, mx = 0.f, nmin = INFINITY;
    int prev_i = kNone, worst = kNone;
    for (int i = lane; i < P; i += 32) {
      const float fo = fit[i], fn = nfit[i];
      if (prev_i == kNone || fo < mn) {
        mn = fo;
        prev_i = i;
      }
      if (worst == kNone || fn > mx) {
        mx = fn;
        worst = i;
      }
      nmin = fminf(nmin, fn);
    }
    first_extreme<false>(mn, prev_i);
    first_extreme<true>(mx, worst);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      nmin = fminf(nmin, __shfl_xor_sync(kFull, nmin, off));
    }
    if (lane == 0) {
      const bool lost = mn < nmin;
      guard[0] = lost;
      guard[1] = prev_i;
      guard[2] = worst;
      if (lost) nfit[worst] = mn;
    }
  }
  __syncthreads();
  if (guard[0]) {
    const size_t base = static_cast<size_t>(r) * P;
    const int* src = pop_in + (base + guard[1]) * N;
    int* dst = pop_out + (base + guard[2]) * N;
    for (int q = threadIdx.x; q < N; q += kFinishThreads) dst[q] = src[q];
  }
  for (int i = threadIdx.x; i < P; i += kFinishThreads) {
    fit_out[static_cast<size_t>(r) * P + i] = nfit[i];
  }
}

// The L2 kernels that take dynamic shared memory, and their grant flags
// (the full 227 KB granted once per device), and the tile kernel's.
const void* const g_l2_kernels[2] = {
    reinterpret_cast<const void*>(qap_ga_step_breed_kernel),
    reinterpret_cast<const void*>(qap_ga_step_finish_kernel)};
std::atomic<unsigned long long> g_l2_granted[2];
std::atomic<unsigned long long> g_tile_granted[repro_torch::kTileMaxGroup];

}  // namespace

// The warps the shared-memory branch breeds with; 0 where the L2 branch
// takes these shapes.
extern "C" int qap_ga_step_smem_warps(int P, int N, int n_off,
                                      int tournament) {
  return smem_warps(P, N, n_off, tournament);
}

// work: the L2 branch's workspace, read only where smem_warps is 0: the
// slots (B n_off ints), the children (B n_off N ints) and their tile sums
// (B n_off ceil(N / tile_rows) floats).  breed_warps, and group,
// tile_warps, sets and tile_rows (the tiling of K2's L2 branch for the
// children, kernels/qap_objective.py l2_tiling): the L2 branch's plan
// (kernels/qap_ga_step.py l2_plan).
extern "C" int qap_ga_step_launch(const float* C, const float* M,
                                  const int* pop_in, const float* fit_in,
                                  const long long* keys, const int* n_valid,
                                  int* pop_out, float* fit_out, void* work,
                                  int B, int P, int N, int islands_per_inst,
                                  int n_off, int tournament, float p_crossover,
                                  float p_mutation, int oxs, int breed_warps,
                                  int group, int tile_warps, int sets,
                                  int tile_rows, int device, void* stream) {
  repro_torch::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int warps = smem_warps(P, N, n_off, tournament);
  if (warps > 0) {
    const size_t smem = smem_fixed_bytes(P, N, n_off) +
                        warps * smem_warp_bytes(N, tournament);
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
  const size_t limit = repro_torch::kSmemBlockLimit;
  const size_t breed_bytes =
      sizeof(int) * breed_warps * breed_warp_words(N, tournament);
  // the finish kernel's new fitness (P words) and guard words
  const size_t fit_bytes = sizeof(float) * (static_cast<size_t>(P) + 3);
  if (work == nullptr || breed_warps < 1 || breed_warps > kBreedMaxWarps ||
      breed_bytes > limit || fit_bytes > limit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int sms = 0;
  cudaError_t err = cudaSuccess;
  for (int k = 0; k < 2 && err == cudaSuccess; ++k) {
    err = repro_torch::smem_launch_setup(g_l2_kernels[k], g_l2_granted[k],
                                         sms);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t kids_n = static_cast<size_t>(B) * n_off;
  int* slot = static_cast<int*>(work);
  int* kids = slot + kids_n;
  float* partial = reinterpret_cast<float*>(kids + kids_n * N);
  const int rank_groups = (P + kRankWarps - 1) / kRankWarps;
  qap_ga_step_rank_kernel<<<static_cast<unsigned>(B) * rank_groups,
                            kRankWarps * 32, 0, st>>>(
      pop_in, fit_in, pop_out, slot, P, N, n_off, rank_groups);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = (n_off + breed_warps - 1) / breed_warps;
  qap_ga_step_breed_kernel<<<static_cast<unsigned>(B) * groups,
                             breed_warps * 32, breed_bytes, st>>>(
      pop_in, fit_in, keys, n_valid, slot, pop_out, kids, P, N, n_off,
      tournament, p_crossover, p_mutation, oxs, groups);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = repro_torch::launch_objective_tiles(
      C, M, kids, partial, static_cast<long long>(kids_n), N,
      static_cast<long long>(islands_per_inst) * n_off, group, tile_warps,
      sets, tile_rows, st, g_tile_granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  qap_ga_step_finish_kernel<<<B, kFinishThreads, fit_bytes, st>>>(
      pop_in, fit_in, slot, partial, pop_out, fit_out, P, N, n_off,
      (N + tile_rows - 1) / tile_rows);
  return static_cast<int>(cudaGetLastError());
}
