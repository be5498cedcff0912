// K2's L2 design as device code shared by K2 (csrc/qap_objective.cu) and
// the fused GA step K5 (csrc/qap_ga_step.cu), which scores its children
// with it on its L2 branch (orders above kSmemMaxN, or islands past 227
// KB).
//
// The tile kernel runs over (instance, group of G permutations, tile of
// R rows of C).  A block stages its G permutation rows in shared memory;
// warp w takes the tile's rows w, w + warps, ... in order, and for each
// stages C[k, :] and the G rows M[p_g[k], :] into one of its own slot
// sets by 16-byte cp.async (two sets: the next row's land while this one
// is summed), reads C[k, l] once for all G permutations and gathers
// M[p_g[k], p_g[l]] from shared memory, lanes over l.  Each permutation's
// tile sum (lanes by a butterfly, then warps in order) goes to a
// workspace, and tile_total adds a permutation's tiles in tile order (in
// K2's second kernel, in K5's last).  The warps, sets and R are chosen on
// the host from N alone, G from the batch (kernels/qap_objective.py
// l2_tiling), so a permutation's F depends on N alone: it is the same
// bits in K2 and K5, alone or in any batch, on any input.
#pragma once

#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>

#include "qap_dense_smem.cuh"

namespace repro_torch {

// The tile kernel's most warps a block and permutations a group
// (kernels/qap_objective.py L2_MAX_WARPS, L2_MAX_GROUP).
constexpr int kTileMaxWarps = 4;
constexpr int kTileMaxGroup = 2;

// The reduction's G x warps floats, rounded to 16 bytes.
__host__ __device__ constexpr int tile_red_words(int group, int warps) {
  return (group * warps + 3) & ~3;
}

// Shared memory of a tile block: its G permutation rows, the reduction's
// floats, and each warp's `sets` sets of C's row and the G rows of M.
constexpr size_t tile_block_bytes(int n, int group, int warps, int sets) {
  return sizeof(float) *
         (static_cast<size_t>(row_slot_words(n)) *
              (group + static_cast<size_t>(warps) * sets * (1 + group)) +
          tile_red_words(group, warps));
}

// Is (group, warps, sets, tile_rows) a tiling the kernel takes at order N
// with perms_per_inst permutations an instance?
inline bool tiling_ok(int N, long long perms_per_inst, int group, int warps,
                      int sets, int tile_rows) {
  return group >= 1 && group <= kTileMaxGroup && group <= perms_per_inst &&
         warps >= 1 && warps <= kTileMaxWarps && sets >= 1 && sets <= 2 &&
         tile_rows >= 1 &&
         tile_block_bytes(N, group, warps, sets) <=
             static_cast<size_t>(kSmemBlockLimit);
}

// One block per (instance, group of G permutations, tile of tile_rows
// rows of C); partial[q * tiles + tile] = permutation q's sum over the
// tile's rows.  Warp w takes the tile's rows w, w + warps, ...: for each
// it stages C[k, :] and M[p_g[k], :], g < G, into one of its `sets` slot
// sets (two: the next row's land while this one is summed), then lane i
// reads C[k, l] once for the G permutations and gathers M[p_g[k],
// p_g[l]], l = i, i + 32, ...
template <int G>
__global__ void __launch_bounds__(kTileMaxWarps * 32)
qap_objective_tile_kernel(const float* __restrict__ C,
                          const float* __restrict__ M,
                          const int* __restrict__ perms,
                          float* __restrict__ partial, int N,
                          long long perms_per_inst, int groups_per_inst,
                          int sets, int tile_rows) {
  extern __shared__ __align__(16) float tile_smem[];
  const int w = row_slot_words(N);
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tiles = (N + tile_rows - 1) / tile_rows;
  const int tile = static_cast<int>(blockIdx.x % tiles);
  const long long grp = blockIdx.x / tiles;
  const long long inst = grp / groups_per_inst;
  const long long q0 =
      inst * perms_per_inst + (grp - inst * groups_per_inst) * G;
  const int count = static_cast<int>(
      min(static_cast<long long>(G), (inst + 1) * perms_per_inst - q0));
  const size_t nn = static_cast<size_t>(N) * N;
  const float* c = C + inst * nn;
  const float* m = M + inst * nn;
  int* ps = reinterpret_cast<int*>(tile_smem);
  float* red = tile_smem + G * w;
  float* mine = red + tile_red_words(G, warps) + warp * sets * (1 + G) * w;

#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (g < count) {
      stage_row(ps + g * w, perms + (q0 + g) * N, N, threadIdx.x, blockDim.x);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int* pg[G];  // p_g, in shared memory
#pragma unroll
  for (int g = 0; g < G; ++g) {
    pg[g] = ps + g * w + row_shift(perms + (q0 + min(g, count - 1)) * N);
  }
  const int k0 = tile * tile_rows;
  const int rows = min(tile_rows, N - k0);
  auto m_row = [&](int g, int k) {
    return m + static_cast<size_t>(pg[min(g, count - 1)][k]) * N;
  };
  // Set `set` <- C[k0 + kk, :] and M[p_g[k0 + kk], :], g < count.
  auto issue = [&](int kk, int set) {
    float* s = mine + set * (1 + G) * w;
    const int k = k0 + kk;
    stage_row(s, c + static_cast<size_t>(k) * N, N, lane, 32);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g < count) stage_row(s + (1 + g) * w, m_row(g, k), N, lane, 32);
    }
    cp_async_commit();
  };

  float acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.f;
  int set = 0;
  if (warp < rows) issue(warp, 0);
  for (int kk = warp; kk < rows; kk += warps) {
    const bool more = kk + warps < rows;
    if (sets > 1 && more) {
      issue(kk + warps, set ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const float* s = mine + set * (1 + G) * w;
    const int k = k0 + kk;
    const float* crow = s + row_shift(c + static_cast<size_t>(k) * N);
    const float* mrow[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      mrow[g] = s + (1 + g) * w + row_shift(m_row(g, k));
    }
#pragma unroll 4
    for (int l = lane; l < N; l += 32) {
      const float cl = crow[l];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (g < count) acc[g] += cl * mrow[g][pg[g][l]];
      }
    }
    __syncwarp();  // every lane has read the set before it is refilled
    if (sets > 1) {
      set ^= 1;
    } else if (more) {
      issue(kk + warps, 0);
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    float v = acc[g];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_xor_sync(0xffffffffu, v, off);
    }
    if (lane == 0) red[g * warps + warp] = v;
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < count) {
    const float* r = red + threadIdx.x * warps;
    float s = r[0];
    for (int x = 1; x < warps; ++x) s += r[x];
    partial[(q0 + threadIdx.x) * tiles + tile] = s;
  }
}

// A permutation's F: its `tiles` partial sums (partial + q * tiles) added
// in tile order.
__device__ __forceinline__ float tile_total(const float* r, int tiles) {
  float s = r[0];
  for (int t = 1; t < tiles; ++t) s += r[t];
  return s;
}

// Launch the tile kernel over `total` permutations, perms_per_inst an
// instance, G = group of them a block; partial: total x ceil(N /
// tile_rows) floats.  granted: one flag word for each G (the full 227 KB
// granted once per device, smem_launch_setup).
inline cudaError_t launch_objective_tiles(
    const float* C, const float* M, const int* perms, float* partial,
    long long total, int N, long long perms_per_inst, int group, int warps,
    int sets, int tile_rows, cudaStream_t st,
    std::atomic<unsigned long long> (&granted)[kTileMaxGroup]) {
  if (!tiling_ok(N, perms_per_inst, group, warps, sets, tile_rows)) {
    return cudaErrorInvalidValue;
  }
  const void* kernel =
      group == 1 ? reinterpret_cast<const void*>(qap_objective_tile_kernel<1>)
                 : reinterpret_cast<const void*>(qap_objective_tile_kernel<2>);
  int sms = 0;
  const cudaError_t err =
      smem_launch_setup(kernel, granted[group - 1], sms);
  if (err != cudaSuccess) return err;
  const int tiles = (N + tile_rows - 1) / tile_rows;
  const long long groups = (perms_per_inst + group - 1) / group;
  const unsigned blocks =
      static_cast<unsigned>(total / perms_per_inst * groups * tiles);
  const size_t bytes = tile_block_bytes(N, group, warps, sets);
  if (group == 1) {
    qap_objective_tile_kernel<1><<<blocks, warps * 32, bytes, st>>>(
        C, M, perms, partial, N, perms_per_inst, static_cast<int>(groups),
        sets, tile_rows);
  } else {
    qap_objective_tile_kernel<2><<<blocks, warps * 32, bytes, st>>>(
        C, M, perms, partial, N, perms_per_inst, static_cast<int>(groups),
        sets, tile_rows);
  }
  return cudaGetLastError();
}

}  // namespace repro_torch
