// K1: fused pillar encode — points to the final eval-mode BEV grid.
//
// Replaces the TPU kernel airv2x_tpu/ops/pallas_pillars.py:_encode_kernel
// (reached through fused_pillar_encode from FastPillarBEV's eval path).
//
// What it computes, per map g and BEV cell r (C feature channels):
//   max[g,r,c] = max over the map's points p in cell r of feat[p,c]
//   sum[g,r,:] = sum over those points of aux[p,:]   (count, 3 residual sums)
//   out[g,r,c] = min(cnt,1) * max(relu((max*flip - W_cl.mean) * a + b), floor)
// where mean = residual sums / max(cnt,1) + the cell centre, with the cell
// row recovered as iy = floor((r + 0.5) * (1/nx)), as the TPU kernel does.
// Points whose id is outside [0, cells) are skipped.
//
// What bounds it on an H100: bytes. The least traffic is the point inputs
// read once plus the (m, cells, C) output written once; the output
// dominates (3 x 140,800 x 64 bf16 = 54 MB at the flagship vehicle call,
// against 17 MB of inputs). So the one pass over every cell writes the
// output and reads nothing else per empty cell but a 4-byte table entry.
//
// Why the accumulator is compact: few cells hold a point. A map has n point
// slots for its cells (20,000 for 140,800 at the flagship: at most 14% of
// the cells, ~4% in a make_scene cloud, where most slots are skipped). A
// dense accumulator (m x cells x C f32, 108 MB at m = 3) would be written
// and read back whole for a few percent of useful rows. Instead an occupied
// cell accumulates in the row of its leader, the lowest index of its points:
//   table  (m, cells) u32: cell -> leader, 0xFFFFFFFF for none (1.7 MB);
//   rows   (m, n, C + 4) f32: row p holds the C maxima, the count and the
//          three residual sums of the cell that p leads (16 MB at m = 3).
// Both stay in the 50 MB L2.
//
// Why the empty cells are exact: in a cell with no point the plain version
// has max = -1e9 and cnt = 0, so occ = 0 multiplies max(relu(v), floor) >= 0,
// where v = (-1e9 * flip - W_cl.mean) * a + b is finite for any |a| < 3e29:
// the product is +0.0, the bits the epilogue stores there without a row.
//
// One memset and three launches on the caller's stream:
//   0. table <- 0xFF bytes (no leader anywhere);
//   1. leader: one warp per point, the warps of a grid over (points, maps)
//      striding over the map's points; a point with a valid id does
//      atomicMin(table[g, id], p) (no counter, no spin-wait, and the same
//      leader in every run) and copies its features and aux into its own
//      row, which becomes its cell's accumulator if it leads;
//   2. scatter: the same warps, lanes along C, so a point's features are
//      read coalesced. A point that does not lead its cell folds them into
//      its leader's row with the integer-trick float atomicMax (atomics.cuh,
//      -0.0 folded to +0.0), and lanes 0-3 atomicAdd its count weight and
//      residuals. Most occupied cells hold one point (15,468 cells for
//      16,524 points in a make_scene vehicle call), so most points do no
//      atomic at all;
//   3. epilogue: a grid over (cells, maps), a group of lanes per cell, each
//      lane 16 bytes of output along C (one element where C does not fill
//      16-byte vectors). A group reads the table entries of its next
//      kUnroll cells at once. An empty cell stores zeros. In an occupied
//      cell every lane starts its maxima load, the group's first lane
//      computes iy, ix, the three means and the occupancy once and shuffles
//      them to the group, and each lane does its channels' W_cl . mean, BN,
//      relu and floor. The arithmetic uses the _rn intrinsics in the plain
//      version's order, so no multiply-add is contracted: it rounds as the
//      plain PyTorch version does, and only the order of the atomic sums
//      differs from run to run.
// The grid sizes and kUnroll were picked by timing on an H100.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "atomics.cuh"

namespace {

using airv2x::atomic_max_float;

constexpr unsigned kNoLeader = 0xFFFFFFFFu;  // the memset's 0xFF bytes
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// blocks of each grid over all maps (132 SMs): kPointBlocks for the point
// passes, kEpilogueBlocks for the epilogue; the epilogue's cells per group
// and step
constexpr int kPointBlocks = 132 * 8;
constexpr int kEpilogueBlocks = 132 * 4;
constexpr int kUnroll = 2;

// blocks along x for a grid of m maps, each of `items` over `per_block`
int blocks_x(int items, int per_block, int m, int total) {
  const int need = (items + per_block - 1) / per_block;
  const int cap = total / m > 0 ? total / m : 1;
  return need < cap ? need : cap;
}

// Both point passes: one warp per point, lanes along C, the warps of a
// 2-D grid over (points, maps) striding over the map's points.
__global__ void k1_leader_kernel(const int* __restrict__ ids,
                                 const float* __restrict__ feat,
                                 const float* __restrict__ aux,
                                 unsigned* __restrict__ table,
                                 float* __restrict__ rows, int n, int cells,
                                 int C) {
  const int g = blockIdx.y;
  const int lane = threadIdx.x & 31;
  for (int i = blockIdx.x * kWarps + threadIdx.x / 32; i < n;
       i += gridDim.x * kWarps) {
    const long long p = static_cast<long long>(g) * n + i;
    const int id = __ldg(ids + p);
    if (id < 0 || id >= cells) continue;
    if (lane == 0) {
      atomicMin(table + static_cast<long long>(g) * cells + id,
                static_cast<unsigned>(i));
    }
    // the point's own row starts as the point itself; + 0.0f folds -0.0 to
    // +0.0 as atomic_max_float does, so the maxima's bits do not depend on
    // which point leads
    float* row = rows + p * (C + 4);
    const float* f = feat + p * C;
    for (int c = lane; c < C; c += 32) row[c] = __fadd_rn(__ldg(f + c), 0.0f);
    if (lane < 4) row[C + lane] = __ldg(aux + p * 4 + lane);
  }
}

__global__ void k1_scatter_kernel(const int* __restrict__ ids,
                                  const float* __restrict__ feat,
                                  const float* __restrict__ aux,
                                  const unsigned* __restrict__ table,
                                  float* __restrict__ rows, int n, int cells,
                                  int C) {
  const int g = blockIdx.y;
  const int lane = threadIdx.x & 31;
  for (int i = blockIdx.x * kWarps + threadIdx.x / 32; i < n;
       i += gridDim.x * kWarps) {
    const long long p = static_cast<long long>(g) * n + i;
    const int id = __ldg(ids + p);
    if (id < 0 || id >= cells) continue;
    const unsigned lead =
        __ldg(table + static_cast<long long>(g) * cells + id);
    if (lead == static_cast<unsigned>(i)) continue;  // its row holds it
    float* row = rows + (static_cast<long long>(g) * n + lead) * (C + 4);
    const float* f = feat + p * C;
    for (int c = lane; c < C; c += 32) {
      atomic_max_float(row + c, __ldg(f + c));
    }
    if (lane < 4) atomicAdd(row + C + lane, __ldg(aux + p * 4 + lane));
  }
}

template <typename T>
__device__ __forceinline__ T to_out(float v);
template <>
__device__ __forceinline__ float to_out<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(hi)))
          << 16);
}

// V outputs in one store: 16 bytes (4 f32 or 8 bf16), or one element
template <typename T, int V>
struct Store;
template <>
struct Store<float, 4> {
  __device__ static void run(float* dst, const float (&v)[4]) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Store<__nv_bfloat16, 8> {
  __device__ static void run(__nv_bfloat16* dst, const float (&v)[8]) {
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(bf16x2(v[0], v[1]), bf16x2(v[2], v[3]),
                   bf16x2(v[4], v[5]), bf16x2(v[6], v[7]));
  }
};
template <typename T>
struct Store<T, 1> {
  __device__ static void run(T* dst, const float (&v)[1]) {
    *dst = to_out<T>(v[0]);
  }
};

// V floats from src, 16-byte aligned when V is a multiple of 4
template <int V>
__device__ __forceinline__ void load_vec(const float* src, float (&v)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int k = 0; k < V / 4; ++k) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(src) + k);
      v[4 * k] = q.x;
      v[4 * k + 1] = q.y;
      v[4 * k + 2] = q.z;
      v[4 * k + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = __ldg(src + k);
  }
}

// One cell of the output, by its group of tpc lanes (a power of two <= 32,
// aligned in the warp); each lane V channels per step.
// params rows: 0:3 W_cl, 3 bn scale a, 4 bn shift b, 5 flip, 6 floor.
template <typename T, int V>
__device__ __forceinline__ void encode_cell(
    int r, unsigned lead, const float* __restrict__ map_rows,
    const float* __restrict__ params, T* __restrict__ dst, int C, int tpc,
    int sub, unsigned group, int nx, float inv_nx, float vsx, float vsy,
    float cx0, float cy0, float cz) {
  const int nvec = C / V;
  if (lead == kNoLeader) {
    const float zero[V] = {};
    for (int j = sub; j < nvec; j += tpc) Store<T, V>::run(dst + j * V, zero);
    return;
  }
  const float* row = map_rows + static_cast<long long>(lead) * (C + 4);
  // the lane's first maxima load before the group waits on lane 0's sums
  // (sub < tpc <= nvec)
  float vmax[V];
  load_vec<V>(row + sub * V, vmax);
  float occ = 0.0f, mx = 0.0f, my = 0.0f, mz = 0.0f;
  if (sub == 0) {  // the cell's scalars, once per cell
    const float cnt = __ldg(row + C);
    const float denom = fmaxf(cnt, 1.0f);
    const float rf = static_cast<float>(r);
    const float iy = floorf(__fmul_rn(__fadd_rn(rf, 0.5f), inv_nx));
    const float ix = __fsub_rn(rf, __fmul_rn(iy, static_cast<float>(nx)));
    mx = __fadd_rn(__fdiv_rn(__ldg(row + C + 1), denom),
                   __fadd_rn(__fmul_rn(ix, vsx), cx0));
    my = __fadd_rn(__fdiv_rn(__ldg(row + C + 2), denom),
                   __fadd_rn(__fmul_rn(iy, vsy), cy0));
    mz = __fadd_rn(__fdiv_rn(__ldg(row + C + 3), denom), cz);
    occ = fminf(cnt, 1.0f);
  }
  occ = __shfl_sync(group, occ, 0, tpc);
  mx = __shfl_sync(group, mx, 0, tpc);
  my = __shfl_sync(group, my, 0, tpc);
  mz = __shfl_sync(group, mz, 0, tpc);
  for (int j = sub; j < nvec; j += tpc) {
    const int c0 = j * V;
    float w0[V], w1[V], w2[V], a[V], b[V], flip[V], floor_c[V], res[V];
    if (j != sub) load_vec<V>(row + c0, vmax);
    load_vec<V>(params + c0, w0);
    load_vec<V>(params + C + c0, w1);
    load_vec<V>(params + 2 * C + c0, w2);
    load_vec<V>(params + 3 * C + c0, a);
    load_vec<V>(params + 4 * C + c0, b);
    load_vec<V>(params + 5 * C + c0, flip);
    load_vec<V>(params + 6 * C + c0, floor_c);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float m_cell =
          __fadd_rn(__fadd_rn(__fmul_rn(mx, w0[k]), __fmul_rn(my, w1[k])),
                    __fmul_rn(mz, w2[k]));
      const float smax = __fmul_rn(vmax[k], flip[k]);
      const float v =
          __fadd_rn(__fmul_rn(__fsub_rn(smax, m_cell), a[k]), b[k]);
      res[k] = __fmul_rn(occ, fmaxf(fmaxf(v, 0.0f), floor_c[k]));
    }
    Store<T, V>::run(dst + c0, res);
  }
}

// Pass 3: the blocks of map g stride over its cells; each step a group
// reads kUnroll cells' table entries at once, then writes those cells.
template <typename T, int V>
__global__ void k1_epilogue_kernel(const unsigned* __restrict__ table,
                                   const float* __restrict__ rows,
                                   const float* __restrict__ params,
                                   T* __restrict__ out, int n, int cells,
                                   int C, int tpc, int nx, float inv_nx,
                                   float vsx, float vsy, float cx0, float cy0,
                                   float cz) {
  const int g = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (tpc - 1);  // the lane's place in its cell's group
  const unsigned group =
      tpc == 32 ? 0xFFFFFFFFu : ((1u << tpc) - 1u) << (lane & ~(tpc - 1));
  const int per_block = kThreads / tpc;
  const int stride = gridDim.x * per_block;
  const unsigned* tab = table + static_cast<long long>(g) * cells;
  const float* map_rows = rows + static_cast<long long>(g) * n * (C + 4);
  T* map_out = out + static_cast<long long>(g) * cells * C;
  for (int base = blockIdx.x * per_block + static_cast<int>(threadIdx.x) / tpc;
       base < cells; base += kUnroll * stride) {
    unsigned lead[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = base + u * stride;
      lead[u] = r < cells ? __ldg(tab + r) : kNoLeader;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = base + u * stride;  // the whole group skips together
      if (r >= cells) break;
      // 32-bit offsets: cells * C < 2^31 (checked by the wrapper)
      encode_cell<T, V>(r, lead[u], map_rows, params, map_out + r * C, C, tpc,
                        sub, group, nx, inv_nx, vsx, vsy, cx0, cy0, cz);
    }
  }
}

template <typename T, int V>
void launch_epilogue(const unsigned* table, const float* rows,
                     const float* params, void* out, int m, int n, int cells,
                     int C, int nx, float inv_nx, float vsx, float vsy,
                     float cx0, float cy0, float cz, cudaStream_t stream) {
  const int nvec = C / V;
  int tpc = 1;  // lanes per cell: a power of two <= min(nvec, 32)
  while (tpc < 32 && 2 * tpc <= nvec) tpc *= 2;
  const int per_block = kThreads / tpc;
  const int bx = blocks_x(cells, per_block, m, kEpilogueBlocks);
  k1_epilogue_kernel<T, V><<<dim3(bx, m), kThreads, 0, stream>>>(
      table, rows, params, static_cast<T*>(out), n, cells, C, tpc, nx, inv_nx,
      vsx, vsy, cx0, cy0, cz);
}

}  // namespace

// table: (m, cells) u32; rows: (m, n, C + 4) f32, 16-byte aligned (the
// wrapper carves both out of one workspace); out: (m, cells, C) f32 or bf16.
extern "C" int pillar_encode(const int* ids, const float* feat,
                             const float* aux, const float* params,
                             void* table, float* rows, void* out, int m,
                             int n, int cells, int C, int nx, float inv_nx,
                             float vsx, float vsy, float cx0, float cy0,
                             float cz, int out_bf16, cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(rows) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m == 0 || cells == 0 || C == 0) {
    return static_cast<int>(cudaGetLastError());
  }
  unsigned* tab = static_cast<unsigned*>(table);
  const cudaError_t err = cudaMemsetAsync(
      tab, 0xFF, sizeof(unsigned) * static_cast<size_t>(m) * cells, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const dim3 grid(blocks_x(n, kWarps, m, kPointBlocks), m);
    k1_leader_kernel<<<grid, kThreads, 0, stream>>>(ids, feat, aux, tab, rows,
                                                    n, cells, C);
    k1_scatter_kernel<<<grid, kThreads, 0, stream>>>(ids, feat, aux, tab,
                                                     rows, n, cells, C);
  }
  // 16-byte vectors along C need C to fill them and params to be aligned
  const bool aligned = reinterpret_cast<uintptr_t>(params) % 16 == 0;
  if (out_bf16) {
    if (aligned && C % 8 == 0) {
      launch_epilogue<__nv_bfloat16, 8>(tab, rows, params, out, m, n, cells,
                                        C, nx, inv_nx, vsx, vsy, cx0, cy0, cz,
                                        stream);
    } else {
      launch_epilogue<__nv_bfloat16, 1>(tab, rows, params, out, m, n, cells,
                                        C, nx, inv_nx, vsx, vsy, cx0, cy0, cz,
                                        stream);
    }
  } else if (aligned && C % 4 == 0) {
    launch_epilogue<float, 4>(tab, rows, params, out, m, n, cells, C, nx,
                              inv_nx, vsx, vsy, cx0, cy0, cz, stream);
  } else {
    launch_epilogue<float, 1>(tab, rows, params, out, m, n, cells, C, nx,
                              inv_nx, vsx, vsy, cx0, cy0, cz, stream);
  }
  return static_cast<int>(cudaGetLastError());
}
