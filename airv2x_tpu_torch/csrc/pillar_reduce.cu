// K3: fused pillar reduce — per-map scatter-max and scatter-add of packed
// 128-lane point rows.
//
// Replaces the TPU kernel airv2x_tpu/ops/pallas_pillars.py:_kernel
// (reached through fused_pillar_reduce). It is K1's accumulation alone:
//   out[g, r, 0:64]   = max(-1e9, max over the map's points p with id r of
//                           vals[g, p, 0:64])
//   out[g, r, 64:128] = sum over those points of vals[g, p, 64:128]
// for rows r in [0, cells + 8); row `cells` is the dump row that callers
// send invalid points to, rows past it stay at their initial value. Ids
// outside [0, cells + 8) are skipped.
//
// What bounds it on an H100: bytes. The (m, cells + 8, 128) f32 output is
// written once (216 MB at the flagship's m = 3, 140,800 cells) and the
// point rows read once (31 MB at n = 20,000).
//
// Design: the TPU kernel kept one map's 72 MB accumulator resident in VMEM
// and walked the points serially; a Hopper block has 227 KB of shared
// memory, so the output itself is the accumulator, and two launches on one
// stream do the work:
//   1. init: lanes 0:64 <- -1e9, lanes 64:128 <- 0, coalesced;
//   2. scatter: one thread per (point, lane), neighbouring threads on
//      neighbouring lanes of one point, so each point's row is read and
//      updated as one coalesced 512-byte segment. Lanes < 64 use the
//      integer-trick float atomicMax (atomics.cuh), lanes >= 64 atomicAdd:
//      the maxima are exact, the sums differ from a serial order only by
//      the order of the f32 additions.

#include <cuda_runtime.h>

#include "atomics.cuh"

namespace {

constexpr int kLanes = 128;
constexpr int kFeat = 64;  // lanes [0, 64) take the max, the rest the sum
constexpr float kNeg = -1e9f;
constexpr int kThreads = 256;

__global__ void init_kernel(float* __restrict__ out, long long total) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += stride) {
    out[i] = (i % kLanes) < kFeat ? kNeg : 0.0f;
  }
}

__global__ void scatter_kernel(const int* __restrict__ ids,
                               const float* __restrict__ vals,
                               float* __restrict__ out, int n, int rows,
                               long long total) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                       threadIdx.x;
       idx < total; idx += stride) {
    const long long p = idx / kLanes;  // point, over all maps
    const int lane = static_cast<int>(idx - p * kLanes);
    const int id = __ldg(ids + p);
    if (id < 0 || id >= rows) continue;
    float* dst = out + ((p / n) * rows + id) * kLanes + lane;
    const float v = __ldg(vals + idx);
    if (lane < kFeat) {
      airv2x::atomic_max_float(dst, v);
    } else {
      atomicAdd(dst, v);
    }
  }
}

}  // namespace

extern "C" int pillar_reduce(const int* ids, const float* vals, float* out,
                             int m, int n, int rows, cudaStream_t stream) {
  const long long n_out = static_cast<long long>(m) * rows * kLanes;
  if (n_out > 0) {
    init_kernel<<<airv2x::grid_stride_blocks(n_out, kThreads), kThreads, 0,
                  stream>>>(out, n_out);
  }
  const long long n_in = static_cast<long long>(m) * n * kLanes;
  if (n_in > 0) {
    scatter_kernel<<<airv2x::grid_stride_blocks(n_in, kThreads), kThreads, 0,
                     stream>>>(ids, vals, out, n, rows, n_in);
  }
  return static_cast<int>(cudaGetLastError());
}
