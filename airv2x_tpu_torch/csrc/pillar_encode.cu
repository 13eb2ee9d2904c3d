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
// read once plus the (m, cells, C) output written once; the output dominates
// (3 x 140,800 x 64 bf16 = 54 MB for the flagship vehicle call).
//
// Design: the TPU kernel kept the whole 72 MB per-map accumulator resident
// in VMEM; a Hopper block has 227 KB of shared memory, so the accumulator
// lives in global memory (L2-resident in part) and the work is three
// launches on one stream:
//   1. init: max scratch <- -1e9, sum scratch <- 0 (the wrapper allocates
//      both with torch.empty);
//   2. scatter: one thread per (point, lane). Lanes < C do a float atomicMax
//      built from the integer trick (atomicMax on int for x >= 0, atomicMin
//      on unsigned for x < 0, -0.0 folded to +0.0), skipped when the stored
//      value already wins; lanes < 4 atomicAdd the count and residual sums;
//   3. epilogue: one thread per (cell, channel), coalesced along channels,
//      writes the output in its dtype. Its arithmetic uses the _rn
//      intrinsics so that no multiply-add is contracted: it rounds as the
//      plain PyTorch version does, and only the order of the atomic sums
//      differs from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e9f;
constexpr int kThreads = 256;

int blocks_for(long long total) {
  long long b = (total + kThreads - 1) / kThreads;
  const long long cap = 132LL * 64;  // grid-stride beyond ~64 blocks per SM
  return static_cast<int>(b < cap ? b : cap);
}

__global__ void init_kernel(float* __restrict__ maxbuf, long long n_max,
                            float* __restrict__ sumbuf, long long n_sum) {
  const long long n = n_max > n_sum ? n_max : n_sum;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += stride) {
    if (i < n_max) maxbuf[i] = kNeg;
    if (i < n_sum) sumbuf[i] = 0.0f;
  }
}

__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
  int bits = __float_as_int(v);
  if (bits == static_cast<int>(0x80000000u)) bits = 0;  // -0.0 -> +0.0
  v = __int_as_float(bits);
  if (*addr >= v) return;  // stored values only grow: a stale read is safe
  if (bits >= 0) {
    atomicMax(reinterpret_cast<int*>(addr), bits);
  } else {
    atomicMin(reinterpret_cast<unsigned int*>(addr),
              static_cast<unsigned int>(bits));
  }
}

__global__ void scatter_kernel(const int* __restrict__ ids,
                               const float* __restrict__ feat,
                               const float* __restrict__ aux,
                               float* __restrict__ maxbuf,
                               float* __restrict__ sumbuf, int m, int n,
                               int cells, int C, int lanes) {
  const long long total = static_cast<long long>(m) * n * lanes;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                       threadIdx.x;
       idx < total; idx += stride) {
    const long long p = idx / lanes;
    const int c = static_cast<int>(idx - p * lanes);
    const int id = __ldg(ids + p);
    if (id < 0 || id >= cells) continue;
    const long long row = (p / n) * cells + id;
    if (c < C) atomic_max_float(maxbuf + row * C + c, __ldg(feat + p * C + c));
    if (c < 4) atomicAdd(sumbuf + row * 4 + c, __ldg(aux + p * 4 + c));
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

// params rows: 0:3 W_cl, 3 bn scale a, 4 bn shift b, 5 flip, 6 floor.
template <typename T>
__global__ void epilogue_kernel(const float* __restrict__ maxbuf,
                                const float* __restrict__ sumbuf,
                                const float* __restrict__ params,
                                T* __restrict__ out, int m, int cells, int C,
                                int nx, float inv_nx, float vsx, float vsy,
                                float cx0, float cy0, float cz) {
  const long long total = static_cast<long long>(m) * cells * C;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                       threadIdx.x;
       idx < total; idx += stride) {
    const long long mr = idx / C;
    const int c = static_cast<int>(idx - mr * C);
    const int r = static_cast<int>(mr % cells);
    const float* s = sumbuf + mr * 4;
    const float cnt = s[0];
    const float denom = fmaxf(cnt, 1.0f);
    const float rf = static_cast<float>(r);
    const float iy = floorf(__fmul_rn(__fadd_rn(rf, 0.5f), inv_nx));
    const float ix = __fsub_rn(rf, __fmul_rn(iy, static_cast<float>(nx)));
    const float mx = __fadd_rn(__fdiv_rn(s[1], denom),
                               __fadd_rn(__fmul_rn(ix, vsx), cx0));
    const float my = __fadd_rn(__fdiv_rn(s[2], denom),
                               __fadd_rn(__fmul_rn(iy, vsy), cy0));
    const float mz = __fadd_rn(__fdiv_rn(s[3], denom), cz);
    const float w0 = __ldg(params + c);
    const float w1 = __ldg(params + C + c);
    const float w2 = __ldg(params + 2 * C + c);
    const float a = __ldg(params + 3 * C + c);
    const float b = __ldg(params + 4 * C + c);
    const float flip = __ldg(params + 5 * C + c);
    const float floor_c = __ldg(params + 6 * C + c);
    const float m_cell = __fadd_rn(
        __fadd_rn(__fmul_rn(mx, w0), __fmul_rn(my, w1)), __fmul_rn(mz, w2));
    const float smax = __fmul_rn(maxbuf[idx], flip);
    const float v = __fadd_rn(__fmul_rn(__fsub_rn(smax, m_cell), a), b);
    const float occ = fminf(cnt, 1.0f);
    out[idx] = to_out<T>(__fmul_rn(occ, fmaxf(fmaxf(v, 0.0f), floor_c)));
  }
}

}  // namespace

extern "C" int pillar_encode(const int* ids, const float* feat,
                             const float* aux, const float* params,
                             float* maxbuf, float* sumbuf, void* out, int m,
                             int n, int cells, int C, int nx, float inv_nx,
                             float vsx, float vsy, float cx0, float cy0,
                             float cz, int out_bf16, cudaStream_t stream) {
  const long long n_max = static_cast<long long>(m) * cells * C;
  const long long n_sum = static_cast<long long>(m) * cells * 4;
  const long long n_init = n_max > n_sum ? n_max : n_sum;
  if (n_init > 0) {
    init_kernel<<<blocks_for(n_init), kThreads, 0, stream>>>(
        maxbuf, n_max, sumbuf, n_sum);
  }
  const int lanes = C > 4 ? C : 4;
  const long long n_pts = static_cast<long long>(m) * n * lanes;
  if (n_pts > 0) {
    scatter_kernel<<<blocks_for(n_pts), kThreads, 0, stream>>>(
        ids, feat, aux, maxbuf, sumbuf, m, n, cells, C, lanes);
  }
  if (n_max > 0) {
    if (out_bf16) {
      epilogue_kernel<__nv_bfloat16><<<blocks_for(n_max), kThreads, 0,
                                       stream>>>(
          maxbuf, sumbuf, params, static_cast<__nv_bfloat16*>(out), m, cells,
          C, nx, inv_nx, vsx, vsy, cx0, cy0, cz);
    } else {
      epilogue_kernel<float><<<blocks_for(n_max), kThreads, 0, stream>>>(
          maxbuf, sumbuf, params, static_cast<float*>(out), m, cells, C, nx,
          inv_nx, vsx, vsy, cx0, cy0, cz);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
