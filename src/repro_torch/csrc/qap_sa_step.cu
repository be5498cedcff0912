// K4: one whole SA temperature step per chain, fused, on Hopper; on the
// shared-memory branch also a whole exchange round of steps per launch.
//
// Replaces the TPU kernel repro/kernels/qap_sa_step.py
// qap_sa_step_pallas_batch (body _sa_step_kernel).  For each chain: draw
// max_neighbors candidate swaps and Metropolis uniforms from the Threefry
// counter stream (csrc/threefry.cuh, kernel K3), then scan them in order:
// the O(N) swap delta of K1, accept if d < 0 or u < exp(-d / max(T,
// 1e-9)) while fewer than max_success swaps landed, and track the best
// permutation seen.  Returns (p, f, best_p, best_f); a single step leaves
// cooling to the caller.  A round (qap_sa_step_launch with steps >= 1,
// orders up to kSmemMaxN) runs `steps` such steps in one launch: step t
// keyed by threefry(round key, (0, t)), which is core/keys.py split(key,
// steps)[t], and the temperature cooled after each step in the host's
// roundings (cool_step), so a round gives the bits of `steps` single-step
// launches with the host's cooling between them.  Rejected candidates
// never change the state, so this scan gives the same result as the
// acceptance-event loop of the plain version
// (repro_torch/kernels/qap_sa_step.py) on integer-valued instances.
//
// Two branches, chosen on the host by the order (qap_dense_smem.cuh):
//
// * Shared memory, N <= kSmemMaxN: one warp per chain.  The chains of one
//   instance share a block, which stages the instance's C and M once
//   (cp.async, odd row stride, no transposes); each warp keeps its chain's
//   p and best_p in its own slice of shared memory behind them, and each
//   lane also holds its own entries p[lane + 32 j] in registers for the
//   delta loop (unrolled: the kernel is instantiated per ceil(N / 32)).
//   Lanes draw 32 candidates at a time (lane t draws candidate base + t)
//   and hand them out by shuffles; each candidate's delta is lanes over i,
//   a xor butterfly and the corner terms from shared memory.  A butterfly
//   leaves the bitwise same sum in every lane (IEEE addition commutes), so
//   every lane takes the same accept decision; the loop has no block
//   barrier, only __syncwarp around lane 0's swap.  The split: at most
//   floor(SMs / (2 B0)) blocks per instance, each with ceil(chains /
//   blocks) warps, at most smem_max_warps (within the shared memory left
//   after the instance), so a wave of 32 instances x 16 chains at the 128
//   bucket is 64 blocks of 8 warps: two chains on each of an SM's four
//   schedulers, which hide each other's latency, and half the staging of
//   one block per SM.  Warps past an instance's last chain exit after
//   staging.  In a round each warp keeps its chain for every step: p and
//   best_p in its slice and pr[], f, best f, T in registers, so the block
//   stages C and M once a round and the launch's tail (the last
//   block-wave, every block waiting for its slowest chain) falls once a
//   round, not once a step.  A wave of 128 instances x 250 chains at the
//   128 bucket is 1024 blocks of 32 warps, one block an SM (C and M fill
//   132 KB): on an H100 its round of 100 steps took 58.2 ms in a CUDA
//   graph against 65.9 ms at 16 warps a block, whose 8 chains a scheduler
//   hid less of each other's latency.
//
// * L2, larger orders (the engine's exact-size requests of 170-255
//   processes, Table 1's fused PSA on tai175/343/729, up to the fused
//   steps' cap of 768): the shared-memory branch's loop, one warp per
//   chain, with the eight rows each candidate reads staged in the chain's
//   own shared memory by Hopper's bulk copy, the next candidate's while
//   this one is summed, by a producer warp beside the chain; the chain
//   sums each candidate with K1's terms in K1's order
//   (csrc/qap_delta.cuh), so its delta is K1's bits on any input.
//   Details at qap_sa_step_l2_kernel.
//
// What bounds it on an H100: the bytes are C and M once per instance plus
// the chains' state (4.2 MB + 1 MB for 512 chains at the 128 bucket, 1.6
// us at 3.35 TB/s); the time is the longest chain's sequence of up to K
// candidates, each a chain of dependent instructions of one warp.  On
// the shared-memory branch some 250 of them (4 unrolled shared-memory
// iterations, 2 x 5 shuffles, a division and an expf), every read from
// shared memory, no block barrier.  On the L2 branch a candidate also
// waits for its rows (staged one candidate ahead) and its warp sums
// ceil(N / 32) lane-iterations alone, where a block of four warps a chain
// split them, with block barriers, before this design.  There the warp's
// own delta (some 970 cycles a candidate at order 256, 2,040 on tai729)
// sets the pace, then the loop around it (draws' shuffles, swap, best
// copy: about a sixth of the kernel's time at order 256), which is why
// the swap's register updates branch once per kRegGroup lane-iterations,
// not once each.  On an H100 128 chains x 25 candidates at order 256 take
// 0.0130 ms in a CUDA graph against 0.0133 for the block of four warps a
// chain, Table 1's 32 x 50 on tai729 0.0212 against 0.0275.
// Scoring several candidates per round against the current state (the
// event loop's trick) measured slower on the shared-memory branch: the
// warp is bound by the instructions it issues, not by their latency.
#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <cstddef>
#include <cstdint>

#include "qap_delta.cuh"
#include "qap_dense_smem.cuh"
#include "threefry.cuh"

namespace {

using repro_torch::kRowsPerCandidate;
using repro_torch::smem_stride;
using repro_torch::warp_sum;

// Shared-memory branch: chains (warps) a block at most, and the kernel's
// launch bound, by ITERS.  At the 128 bucket and above an instance's C
// and M fill over half an SM's shared memory, so a block has the SM alone
// and 32 warps hide each other's latency (order 169's round: 59 ms in a
// CUDA graph on an H100 against 75 at 16).  At the 32 and 64 buckets two
// blocks of 16 share an SM and a smaller block frees its SM sooner (a
// step: 0.085 and 0.108 ms against 0.090 and 0.115 at 32; rounds the
// same).  The cut falls between ITERS 3 and 4: orders 97-127 are no
// bucket of the engine and were not timed.
__host__ __device__ constexpr int smem_max_warps(int iters) {
  return iters <= 3 ? 16 : 32;
}
constexpr unsigned kFull = 0xffffffffu;

// One flag word per instantiation of the shared-memory kernel, one for the
// L2 kernel.
std::atomic<unsigned long long> g_smem_granted[repro_torch::kSmemMaxIters + 1];
std::atomic<unsigned long long> g_l2_granted;

// One chain's p and best_p on the shared-memory branch.
size_t chain_state_bytes(int n) {
  return 2 * static_cast<size_t>(n) * sizeof(int);
}

// The L2 branch holds each lane's p[lane + 32 j] in registers, which
// bounds its order at 32 kMaxRegIters, the fused steps' cap (768).
constexpr int kMaxRegIters = 24;

// Row sets of the L2 branch: the next candidate's rows land in one while
// the warp sums this one's from the other.
constexpr int kL2Sets = 2;

// Words of a row slot on the L2 branch: a row keeps its place within 16
// bytes (row_shift), and the slot holds it up to whole groups of
// delta_from_regs (128 words), so that a lane's reads past n stay in it.
__host__ __device__ constexpr int l2_slot_words(int n) {
  constexpr int kSpan = 32 * repro_torch::kRegGroup;
  return kSpan * ((n + kSpan - 1) / kSpan) + 4;
}

// Words of the L2 block's shared memory: the two sets of kRowsPerCandidate
// row slots, p and best_p (a slot each), then an mbarrier a set for its
// copies and one for its requests (8 words) and a request of 4 words a
// set.
constexpr size_t l2_block_words(int n) {
  return static_cast<size_t>(l2_slot_words(n)) *
             (kL2Sets * kRowsPerCandidate + 2) +
         16;
}

// The cooling schedules of a round (kernels/qap_sa_step.py COOL_CODES).
constexpr int kCoolLinear = 0;
constexpr int kCoolCauchy = 1;

// One cooling, then the clamp at t_final, in the host's roundings
// (kernels/qap_sa_step.py cool): linear T q; Cauchy T / (1 + beta T) with
// 1 + beta T rounded once in f64 (the f64 product of two f32 is exact),
// then to f32.  The clamp lets NaN through, as torch's clamp_min does.
__device__ __forceinline__ float cool_step(float t, int schedule, float beta,
                                           float q, float t_final) {
  const float x =
      schedule == kCoolCauchy
          ? __fdiv_rn(t, __double2float_rn(__dadd_rn(
                             __dmul_rn(static_cast<double>(beta),
                                       static_cast<double>(t)),
                             1.0)))
          : __fmul_rn(t, q);
  return isnan(x) ? x : fmaxf(x, t_final);
}

// steps == 0: one temperature step keyed by `keys` as given, no cooling
// (temp_out and beta unread).  steps >= 1: a round of that many steps
// from round keys, the final temperature into temp_out.
template <int ITERS>
__global__ void __launch_bounds__(smem_max_warps(ITERS) * 32)
qap_sa_step_smem_kernel(const float* __restrict__ C,
                        const float* __restrict__ M,
                        const int* __restrict__ p_in,
                        const float* __restrict__ f_in,
                        const int* __restrict__ bp_in,
                        const float* __restrict__ bf_in,
                        const float* __restrict__ temp,
                        const long long* __restrict__ keys,
                        const int* __restrict__ n_valid,
                        const float* __restrict__ beta,
                        int* __restrict__ p_out, float* __restrict__ f_out,
                        int* __restrict__ bp_out, float* __restrict__ bf_out,
                        float* __restrict__ temp_out, int N,
                        int rows_per_inst, int K, int max_success,
                        int blocks_per_inst, int steps, int schedule, float q,
                        float t_final) {
  extern __shared__ float smem[];
  const int s = smem_stride(N);
  float* c = smem;
  float* m = smem + static_cast<size_t>(N) * s;
  const int inst = blockIdx.x / blocks_per_inst;
  const int warp = threadIdx.x >> 5;
  const int chain =
      (blockIdx.x - inst * blocks_per_inst) * (blockDim.x >> 5) + warp;
  const size_t nn = static_cast<size_t>(N) * N;
  repro_torch::stage_instance(c, m, C + inst * nn, M + inst * nn, N);
  if (chain >= rows_per_inst) return;  // whole warp; no block barrier follows

  const int lane = threadIdx.x & 31;
  int* p = reinterpret_cast<int*>(m + static_cast<size_t>(N) * s) +
           static_cast<size_t>(warp) * 2 * N;
  int* bp = p + N;
  const int r = inst * rows_per_inst + chain;
  const size_t row0 = static_cast<size_t>(r) * N;
  int pr[ITERS];  // this lane's p[i], i = lane + 32 j, kept beside p
#pragma unroll
  for (int j = 0; j < ITERS; ++j) {
    const int i = lane + 32 * j;
    pr[j] = 0;
    if (i < N) {
      pr[j] = p_in[row0 + i];
      p[i] = pr[j];
      bp[i] = bp_in[row0 + i];
    }
  }
  __syncwarp();

  // uint32 key words held in int64: the low 32 bits are the word.
  const uint32_t rk0 = static_cast<uint32_t>(keys[2 * r]);
  const uint32_t rk1 = static_cast<uint32_t>(keys[2 * r + 1]);
  const int nv = n_valid[r];
  float f = f_in[r];
  float bf = bf_in[r];
  float t_now = temp[r];
  const float chain_beta =
      steps > 0 && schedule == kCoolCauchy ? beta[r] : 0.f;
  for (int step = 0; step < max(steps, 1); ++step) {
    uint32_t k0 = rk0, k1 = rk1;  // the step's key: split(round key)[step]
    if (steps > 0) {
      repro_torch::threefry2x32(rk0, rk1, 0u, static_cast<uint32_t>(step), k0,
                                k1);
    }
    const float tsafe = fmaxf(t_now, 1e-9f);
    int successes = 0;
    for (int base = 0; base < K && successes < max_success; base += 32) {
      int la = 0, lb = 0;
      float lu = 0.f;
      if (base + lane < K) {
        repro_torch::sa_draw(k0, k1, static_cast<uint32_t>(base + lane), nv,
                             la, lb, lu);
      }
      const int count = min(32, K - base);
      for (int t = 0; t < count && successes < max_success; ++t) {
        const int a = __shfl_sync(kFull, la, t);
        const int b = __shfl_sync(kFull, lb, t);
        const float ut = __shfl_sync(kFull, lu, t);
        const int u = p[a], v = p[b];
        const float* ca = c + a * s;
        const float* cb = c + b * s;
        const float* mu = m + u * s;
        const float* mv = m + v * s;
        float col = 0.f, row = 0.f;
#pragma unroll
        for (int j = 0; j < ITERS; ++j) {
          const int i = lane + 32 * j;
          if (i < N && i != a && i != b) {
            const float* ci = c + i * s;
            const float* mp = m + pr[j] * s;
            col += (ci[a] - ci[b]) * (mp[v] - mp[u]);
            row += (ca[i] - cb[i]) * (mv[pr[j]] - mu[pr[j]]);
          }
        }
        col = warp_sum(col);
        row = warp_sum(row);
        const float corner = (ca[a] - cb[b]) * (mv[v] - mu[u]) +
                             ca[b] * (mv[u] - mu[v]) + cb[a] * (mu[v] - mv[u]);
        const float d = col + row + corner;
        if ((d < 0.f) || (ut < expf(-d / tsafe))) {  // the same in every lane
          __syncwarp();  // every lane has read p[a] and p[b]
          if (lane == 0) {
            p[a] = v;
            p[b] = u;
          }
#pragma unroll
          for (int j = 0; j < ITERS; ++j) {
            const int i = lane + 32 * j;
            pr[j] = i == a ? v : (i == b ? u : pr[j]);
          }
          __syncwarp();
          f = f + d;
          ++successes;
          if (f < bf) {
            bf = f;
#pragma unroll
            for (int j = 0; j < ITERS; ++j) {
              const int i = lane + 32 * j;
              if (i < N) bp[i] = pr[j];
            }
          }
        }
      }
    }
    if (steps > 0) t_now = cool_step(t_now, schedule, chain_beta, q, t_final);
  }

  __syncwarp();
#pragma unroll
  for (int j = 0; j < ITERS; ++j) {
    const int i = lane + 32 * j;
    if (i < N) {
      p_out[row0 + i] = pr[j];
      bp_out[row0 + i] = bp[i];
    }
  }
  if (lane == 0) {
    f_out[r] = f;
    bf_out[r] = bf;
    if (steps > 0) temp_out[r] = t_now;
  }
}

// L2 branch: one warp per chain, the shared-memory branch's loop with the
// eight rows each candidate reads -- C[a], C[b], C^T[a], C^T[b], M[u],
// M[v], M^T[u], M^T[v] -- staged in the chain's shared memory by bulk copy
// (one instruction a row, completion in bytes on the set's mbarrier), and
// beside the chain's warp a producer warp that issues them: a bulk copy
// takes uniform operands, so a warp issues its eight one after another,
// some 800 cycles that would sit on the chain's path.  Block = chain
// blockIdx.x: warp 0 runs it, warp 1 is its producer.  The chain keeps p
// and best_p in shared memory and each lane its p[lane + 32 j] in
// registers (N <= 32 kMaxRegIters), as the shared-memory branch does, and
// sums a candidate with K1's terms in K1's order (delta_from_regs).  The
// chain posts the next candidate (a, b, p[a], p[b]) to the producer (a
// request a set, an mbarrier arrive) before summing this one; requests
// alternate the two row sets, and the producer stages each into its set
// (candidate 0's at once, while the chain loads its state).  A swap
// changes p only at a and b, so the next candidate's rows stay valid
// unless this one is accepted and shares a position with it: then the
// chain waits for those copies and stages the rows again itself.  With no
// candidate to score (K or max_success 0) neither warp touches a barrier
// past their init.  Lanes draw 32 candidates at a time (lane t draws
// candidate base + t, the next 32 one batch ahead) and hand them out by
// shuffles.  One block barrier, before the loops (the barriers' init);
// none in them.
__global__ void __launch_bounds__(64)
qap_sa_step_l2_kernel(const float* __restrict__ C,
                      const float* __restrict__ CT,
                      const float* __restrict__ M,
                      const float* __restrict__ MT,
                      const int* __restrict__ p_in,
                      const float* __restrict__ f_in,
                      const int* __restrict__ bp_in,
                      const float* __restrict__ bf_in,
                      const float* __restrict__ temp,
                      const long long* __restrict__ keys,
                      const int* __restrict__ n_valid, int* __restrict__ p_out,
                      float* __restrict__ f_out, int* __restrict__ bp_out,
                      float* __restrict__ bf_out, int N, int rows_per_inst,
                      int K, int max_success) {
  extern __shared__ __align__(16) float l2_smem[];
  const int lane = threadIdx.x & 31;
  const bool producer = threadIdx.x >= 32;
  const int r = blockIdx.x;
  const int w = l2_slot_words(N);
  float* slots = l2_smem;
  int* p = reinterpret_cast<int*>(slots + kL2Sets * kRowsPerCandidate * w);
  int* bp = p + w;
  unsigned long long* full = reinterpret_cast<unsigned long long*>(bp + w);
  unsigned long long* req = full + kL2Sets;
  int* mail = reinterpret_cast<int*>(req + kL2Sets);  // request s: mail[4 s..]
  if (threadIdx.x == 0) {
    for (int k = 0; k < kL2Sets; ++k) {
      repro_torch::mbar_init(full + k, 1);
      repro_torch::mbar_init(req + k, 1);
    }
    repro_torch::fence_proxy_async();
  }
  __syncthreads();  // every barrier initialised; no block barrier follows
  // a candidate to score: else the chain requests no rows and the
  // producer waits for none
  const bool scores = K > 0 && max_success > 0;
  if (producer && !scores) return;
  const size_t nn = static_cast<size_t>(N) * N;
  const size_t base = static_cast<size_t>(r / rows_per_inst) * nn;
  const float *c = C + base, *ct = CT + base, *m = M + base, *mt = MT + base;
  // row_shift of row 0 of C, C^T, M, M^T (row k's: + k N, mod 4)
  const int shifts[4] = {repro_torch::row_shift(c), repro_torch::row_shift(ct),
                         repro_torch::row_shift(m), repro_torch::row_shift(mt)};

  // Set `set` <- the eight rows of candidate (a, b) with u = p[a], v =
  // p[b], lane j < 8 copying row j; every lane of the calling warp calls
  // it.
  auto stage = [&](int a, int b, int u, int v, int set) {
    const int j = lane & (kRowsPerCandidate - 1);
    const float* mat = j < 2 ? c : j < 4 ? ct : j < 6 ? m : mt;
    const int row = (j & 1) ? (j < 4 ? b : v) : (j < 4 ? a : u);
    const float* src = mat + static_cast<size_t>(row) * N;
    const unsigned bytes = repro_torch::bulk_row_bytes(src, N);
    const unsigned total =
        __reduce_add_sync(kFull, lane < kRowsPerCandidate ? bytes : 0u);
    if (lane == 0) repro_torch::mbar_expect_tx(full + set, total);
    __syncwarp();
    if (lane < kRowsPerCandidate) {
      repro_torch::fence_proxy_async();
      repro_torch::bulk_copy(slots + (set * kRowsPerCandidate + j) * w,
                             repro_torch::bulk_row_src(src), bytes,
                             full + set);
    }
  };

  // uint32 key words held in int64: the low 32 bits are the word.
  const uint32_t k0 = static_cast<uint32_t>(keys[2 * r]);
  const uint32_t k1 = static_cast<uint32_t>(keys[2 * r + 1]);
  const int nv = n_valid[r];
  const size_t row0 = static_cast<size_t>(r) * N;
  if (producer) {
    // Candidate 0 into set 0 at once, while the chain loads its state;
    // then the chain's requests, which alternate sets 1, 0, 1, ...; a < 0
    // ends them.
    int a, b;
    float u;
    repro_torch::sa_draw(k0, k1, 0u, nv, a, b, u);
    stage(a, b, p_in[row0 + a], p_in[row0 + b], 0);
    for (unsigned s = 1, parity = 0;; s ^= 1u) {
      repro_torch::mbar_wait(req + s, (parity >> s) & 1u);
      parity ^= 1u << s;
      const int a = mail[4 * s];
      if (a < 0) return;
      stage(a, mail[4 * s + 1], mail[4 * s + 2], mail[4 * s + 3], s);
    }
  }

  for (int i = lane; i < N; i += 32) {
    p[i] = p_in[row0 + i];
    bp[i] = bp_in[row0 + i];
  }
  int pr[kMaxRegIters];  // p[lane + 32 j], 0 past N
#pragma unroll
  for (int j = 0; j < kMaxRegIters; ++j) {
    const int i = lane + 32 * j;
    pr[j] = i < N ? p_in[row0 + i] : 0;
  }
  float f = f_in[r];
  float bf = bf_in[r];
  const float tsafe = fmaxf(temp[r], 1e-9f);
  __syncwarp();

  auto draw = [&](int from, int& a, int& b, float& u) {
    a = b = 0;
    u = 0.f;
    if (from + lane < K) {
      repro_torch::sa_draw(k0, k1, static_cast<uint32_t>(from + lane), nv, a,
                           b, u);
    }
  };
  // Bit s of `phase`: the parity set s completes next; of `pending`, a
  // copy into set s not yet waited for.  `posted`: the set of the
  // producer's next request.  Candidate 0's rows: in set 0, staged by the
  // producer.
  unsigned phase = 0, pending = scores ? 1u : 0u, posted = 1;
  // Candidate (a, b)'s rows into `set` at the current p: by the producer
  // or by this warp; every lane calls it after every lane's last read of
  // the set.
  auto request = [&](int a, int b, int set, bool self) {
    const int u = p[a], v = p[b];
    if (self) {
      stage(a, b, u, v, set);
    } else {
      if (lane == 0) {
        mail[4 * set] = a;
        mail[4 * set + 1] = b;
        mail[4 * set + 2] = u;
        mail[4 * set + 3] = v;
        repro_torch::mbar_arrive(req + set);
      }
      posted ^= 1u;
    }
    pending |= 1u << set;
  };
  auto land = [&](int set) {
    repro_torch::mbar_wait(full + set, (phase >> set) & 1u);
    phase ^= 1u << set;
    pending &= ~(1u << set);
  };

  int la, lb, na, nb;  // candidates base + lane and base + 32 + lane
  float lu, nu;
  int first = 0;
  draw(0, la, lb, lu);
  draw(32, na, nb, nu);
  int successes = 0, set = 0;
  for (int t = 0; t < K && successes < max_success; ++t) {
    if (t == first + 32) {
      first = t;
      la = na;
      lb = nb;
      lu = nu;
      draw(first + 32, na, nb, nu);
    }
    const int a = __shfl_sync(kFull, la, t - first);
    const int b = __shfl_sync(kFull, lb, t - first);
    const float ut = __shfl_sync(kFull, lu, t - first);
    const bool more = t + 1 < K;
    const int nt = t + 1 - first;  // the next candidate's lane, 1..32
    const int a1 = __shfl_sync(kFull, nt < 32 ? la : na, nt & 31);
    const int b1 = __shfl_sync(kFull, nt < 32 ? lb : nb, nt & 31);
    if (more) request(a1, b1, set ^ 1, false);
    land(set);
    const int u = p[a], v = p[b];
    // row j of the set, at its source's place within 16 bytes (row_shift)
    const float* s = slots + set * kRowsPerCandidate * w;
    const int rows[kRowsPerCandidate] = {a, b, a, b, u, v, u, v};
    const float* x[kRowsPerCandidate];
#pragma unroll
    for (int j = 0; j < kRowsPerCandidate; ++j) {
      x[j] = s + j * w + ((shifts[j >> 1] + rows[j] * N) & 3);
    }
    const float d =
        repro_torch::delta_from_regs<kMaxRegIters>(x, pr, a, b, u, v, N);
    bool restage = false;
    if ((d < 0.f) || (ut < expf(-d / tsafe))) {  // the same in every lane
      __syncwarp();  // every lane has read p[a] and p[b]
      if (lane == 0) {
        p[a] = v;
        p[b] = u;
      }
#pragma unroll
      for (int j0 = 0; j0 < kMaxRegIters; j0 += repro_torch::kRegGroup) {
        if (32 * j0 >= N) break;
#pragma unroll
        for (int j = j0; j < j0 + repro_torch::kRegGroup; ++j) {
          const int i = lane + 32 * j;
          pr[j] = i == a ? v : (i == b ? u : pr[j]);
        }
      }
      __syncwarp();
      f = f + d;
      ++successes;
      if (f < bf) {
        bf = f;
#pragma unroll
        for (int j0 = 0; j0 < kMaxRegIters; j0 += repro_torch::kRegGroup) {
          if (32 * j0 >= N) break;
#pragma unroll
          for (int j = j0; j < j0 + repro_torch::kRegGroup; ++j) {
            const int i = lane + 32 * j;
            if (i < N) bp[i] = pr[j];
          }
        }
      }
      restage = more && (a1 == a || a1 == b || b1 == a || b1 == b);
    }
    __syncwarp();  // every lane has read the set and p
    if (restage && successes < max_success) {
      // the next candidate's rows again, after the copies requested before
      // this one's swap have landed
      if ((pending >> (set ^ 1)) & 1u) land(set ^ 1);
      __syncwarp();
      request(a1, b1, set ^ 1, true);
    }
    set ^= 1;
  }
  // copies still in flight land before the warp leaves; then the producer
  // is told to stop
  if (pending & 1u) land(0);
  if (pending & 2u) land(1);
  if (scores && lane == 0) {
    mail[4 * posted] = -1;
    repro_torch::mbar_arrive(req + posted);
  }

  for (int i = lane; i < N; i += 32) {
    p_out[row0 + i] = p[i];
    bp_out[row0 + i] = bp[i];
  }
  if (lane == 0) {
    f_out[r] = f;
    bf_out[r] = bf;
  }
}

}  // namespace

// The shared-memory branch's launch: one step (steps 0) or a round.
static cudaError_t smem_launch(const float* C, const float* M,
                               const int* p_in, const float* f_in,
                               const int* bp_in, const float* bf_in,
                               const float* temp, const long long* keys,
                               const int* n_valid, const float* beta,
                               int* p_out, float* f_out, int* bp_out,
                               float* bf_out, float* temp_out, int B, int N,
                               int rows_per_inst, int K, int max_success,
                               int steps, int schedule, float q,
                               float t_final, cudaStream_t st) {
  int sms = 0;
  return repro_torch::with_iters(N, [&](auto iters) {
    constexpr int I = decltype(iters)::value;
    const cudaError_t err = repro_torch::smem_launch_setup(
        reinterpret_cast<const void*>(qap_sa_step_smem_kernel<I>),
        g_smem_granted[I], sms);
    if (err != cudaSuccess) return err;
    const int b0 = B / rows_per_inst;
    const size_t inst_bytes = repro_torch::smem_instance_bytes(N);
    const int fit = static_cast<int>(
        (repro_torch::kSmemBlockLimit - inst_bytes) / chain_state_bytes(N));
    // At most half an SM per instance: two chains on each of an SM's
    // four schedulers hide each other's latency, and half the blocks
    // stage half the bytes.
    const int spread = std::max(1, sms / (2 * b0));
    const int want = (rows_per_inst + spread - 1) / spread;
    const int warps =
        std::max(1, std::min({want, fit, smem_max_warps(I)}));
    const int per = (rows_per_inst + warps - 1) / warps;
    qap_sa_step_smem_kernel<I>
        <<<static_cast<unsigned>(b0) * per, warps * 32,
           inst_bytes + warps * chain_state_bytes(N), st>>>(
            C, M, p_in, f_in, bp_in, bf_in, temp, keys, n_valid, beta, p_out,
            f_out, bp_out, bf_out, temp_out, N, rows_per_inst, K,
            max_success, per, steps, schedule, q, t_final);
    return cudaGetLastError();
  });
}

// CT and MT are read only above kSmemMaxN and may be null below it; keys
// are the uint32 words held in int64.  The L2 branch takes orders up to
// 32 kMaxRegIters (kernels/qap_sa_step.py l2_plan).  steps 0: one
// temperature step keyed by `keys`, no cooling (beta and temp_out
// unread).  steps >= 1, on the shared-memory branch alone (N <=
// kSmemMaxN): a round of that many steps from each chain's round key in
// `keys`, cooled by `schedule` (kCoolLinear, kCoolCauchy) with `q`,
// `beta` (per chain, read under kCoolCauchy) and `t_final`, the
// temperature after the round into temp_out.
extern "C" int qap_sa_step_launch(
    const float* C, const float* CT, const float* M, const float* MT,
    const int* p_in, const float* f_in, const int* bp_in, const float* bf_in,
    const float* temp, const long long* keys, const int* n_valid,
    const float* beta, int* p_out, float* f_out, int* bp_out, float* bf_out,
    float* temp_out, int B, int N, int rows_per_inst, int K, int max_success,
    int steps, int schedule, float q, float t_final, int device,
    void* stream) {
  if (steps < 0 || (steps > 0 && (N > repro_torch::kSmemMaxN ||
                                  (schedule != kCoolLinear &&
                                   schedule != kCoolCauchy)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  repro_torch::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= repro_torch::kSmemMaxN) {
    return static_cast<int>(smem_launch(
        C, M, p_in, f_in, bp_in, bf_in, temp, keys, n_valid, beta, p_out,
        f_out, bp_out, bf_out, temp_out, B, N, rows_per_inst, K, max_success,
        steps, schedule, q, t_final, st));
  }
  int sms = 0;
  const size_t bytes = sizeof(float) * l2_block_words(N);
  if (CT == nullptr || MT == nullptr || N > 32 * kMaxRegIters ||
      bytes > static_cast<size_t>(repro_torch::kSmemBlockLimit)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = repro_torch::smem_launch_setup(
      reinterpret_cast<const void*>(qap_sa_step_l2_kernel), g_l2_granted, sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  // a block a chain: its warp and its producer warp
  qap_sa_step_l2_kernel<<<B, 64, bytes, st>>>(
      C, CT, M, MT, p_in, f_in, bp_in, bf_in, temp, keys, n_valid, p_out,
      f_out, bp_out, bf_out, N, rows_per_inst, K, max_success);
  return static_cast<int>(cudaGetLastError());
}
