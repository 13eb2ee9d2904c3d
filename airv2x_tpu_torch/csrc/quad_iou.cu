// K2: pairwise rotated-quad IoU, (N,4,2) x (M,4,2) -> (N,M) f32.
//
// Replaces the TPU kernel airv2x_tpu/ops/pallas_iou.py:_iou_tile_kernel /
// _iou_tile_body (reached through pairwise_quad_iou_pallas and
// pairwise_quad_iou_fused from ops/nms.py:rotated_nms).
//
// What it computes: the sort-free edge-integral (Green's theorem) area of
// A ∩ B. Each directed edge of A is clipped, as a parameter interval
// t in [0,1], against B's four half-planes and contributes
// 1/2 · cross(p, q) · Δt; B's edges inside A add the symmetric sum. Pieces
// collinear with a half-plane boundary get weight 1/2, which makes both
// degenerate families exact: identical quads give 1, quads sharing an edge
// give 0. Every pair is centred at A's first corner, so the cross products
// stay local-scale at 140 m BEV offsets. Constants as on the TPU:
// tol = 1e-4 · (max(|A|, |B|) + 1), eps = 1e-8, big = 1e9.
//
// What bounds it on an H100: operations. Each pair is ~600 non-tensor-core
// f32 operations on 64 bytes of corners, far above the card's
// ~20 FLOP/byte ridge; NMS calls it at 512 x 512 on the strict upper
// triangle (~131k pairs).
//
// Design: one thread per (i, j) pair in 16 x 16 blocks; the block's 16 row
// quads and 16 column quads are staged in shared memory; ragged edges are
// masked, so N and M need not be multiples of the tile. With `triangular`,
// blocks lying wholly in the strict lower triangle (every i > j) write
// zeros and return: greedy NMS reads only pairs where the row outranks the
// column. The Mosaic-era float-{0,1} predicate arithmetic is replaced by
// branches. The cross products and the area accumulation use the _rn
// intrinsics, so no multiply-add is contracted: the `den - tol` tests then
// classify near-parallel edges exactly as the plain PyTorch version does.

#include <cuda_runtime.h>

namespace {

constexpr float kTol = 1e-4f;
constexpr float kEps = 1e-8f;
constexpr float kBig = 1e9f;
constexpr int kTile = 16;

// a*b - c*d, each product rounded on its own
__device__ __forceinline__ float cross_rn(float a, float b, float c, float d) {
  return __fsub_rn(__fmul_rn(a, b), __fmul_rn(c, d));
}

__device__ __forceinline__ float signed_area(const float* x, const float* y) {
  float s = cross_rn(x[0], y[1], x[1], y[0]);
  s = __fadd_rn(s, cross_rn(x[1], y[2], x[2], y[1]));
  s = __fadd_rn(s, cross_rn(x[2], y[3], x[3], y[2]));
  s = __fadd_rn(s, cross_rn(x[3], y[0], x[0], y[3]));
  return 0.5f * s;
}

__device__ __forceinline__ float sign_of(float v) {
  return v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f);
}

// Sum over the edges of P of cross(p, q) · Δt · w, each edge clipped to the
// inside of H (orientation sign sgn_h); the caller applies the 1/2.
__device__ float pieces(const float* xp, const float* yp, const float* xh,
                        const float* yh, float sgn_h, float tol2) {
  float total = 0.0f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float px = xp[e], py = yp[e];
    const float qx = xp[(e + 1) & 3], qy = yp[(e + 1) & 3];
    const float dx = qx - px, dy = qy - py;
    const float cross_e = cross_rn(px, qy, py, qx);
    float tlo = -kBig, thi = kBig;
    bool emp = false, coll = false;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float b0x = xh[k], b0y = yh[k];
      const float ex = xh[(k + 1) & 3] - b0x;
      const float ey = yh[(k + 1) & 3] - b0y;
      const float num = sgn_h * cross_rn(ex, py - b0y, ey, px - b0x);
      const float den = sgn_h * cross_rn(ex, dy, ey, dx);
      if (den - tol2 >= 0.0f) {  // entering constraint
        tlo = fmaxf(tlo, -num / den);
      } else if (-den - tol2 >= 0.0f) {  // leaving constraint
        thi = fminf(thi, -num / den);
      } else {  // parallel: outside, or on the boundary
        emp = emp || (-num - tol2 >= 0.0f);
        coll = coll || (tol2 - fabsf(num) >= 0.0f);
      }
    }
    const float t0 = fmaxf(tlo, 0.0f);
    const float t1 = fminf(thi, 1.0f);
    const float dt = emp ? 0.0f : fmaxf(t1 - t0, 0.0f);
    const float w = coll ? 0.5f : 1.0f;
    total = __fadd_rn(total, __fmul_rn(cross_e, __fmul_rn(dt, w)));
  }
  return total;
}

__global__ void quad_iou_kernel(const float* __restrict__ rows,
                                const float* __restrict__ cols,
                                float* __restrict__ out, int N, int M,
                                int triangular) {
  __shared__ float srow[kTile][8];
  __shared__ float scol[kTile][8];
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  const int i = row0 + threadIdx.y;
  const int j = col0 + threadIdx.x;

  if (triangular && row0 >= col0 + kTile) {  // every (i, j) here has i > j
    if (i < N && j < M) out[static_cast<long long>(i) * M + j] = 0.0f;
    return;
  }

  const int t = threadIdx.y * kTile + threadIdx.x;  // 0..255 loads 2x128
  if (t < kTile * 8) {
    const int q = t / 8, c = t % 8;
    srow[q][c] = (row0 + q < N) ? rows[(row0 + q) * 8 + c] : 0.0f;
  } else {
    const int q = (t - kTile * 8) / 8, c = t % 8;
    scol[q][c] = (col0 + q < M) ? cols[(col0 + q) * 8 + c] : 0.0f;
  }
  __syncthreads();
  if (i >= N || j >= M) return;

  const float* a = srow[threadIdx.y];
  const float* b = scol[threadIdx.x];
  const float ox = a[0], oy = a[1];
  float xa[4], ya[4], xb[4], yb[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    xa[k] = a[2 * k] - ox;
    ya[k] = a[2 * k + 1] - oy;
    xb[k] = b[2 * k] - ox;
    yb[k] = b[2 * k + 1] - oy;
  }
  const float sa = signed_area(xa, ya);
  const float sb = signed_area(xb, yb);
  const float sgn_a = sign_of(sa), sgn_b = sign_of(sb);
  const float aa = fabsf(sa), ab = fabsf(sb);
  const float tol2 = kTol * (fmaxf(aa, ab) + 1.0f);

  const float pa = __fmul_rn(pieces(xa, ya, xb, yb, sgn_b, tol2), sgn_a);
  const float pb = __fmul_rn(pieces(xb, yb, xa, ya, sgn_a, tol2), sgn_b);
  const float inter = 0.5f * fabsf(__fadd_rn(pa, pb));
  const float uni = aa + ab - inter;
  out[static_cast<long long>(i) * M + j] = inter / fmaxf(uni, kEps);
}

}  // namespace

extern "C" int quad_iou(const float* rows, const float* cols, float* out,
                        int N, int M, int triangular, cudaStream_t stream) {
  if (N > 0 && M > 0) {
    const dim3 block(kTile, kTile);
    const dim3 grid((M + kTile - 1) / kTile, (N + kTile - 1) / kTile);
    quad_iou_kernel<<<grid, block, 0, stream>>>(rows, cols, out, N, M,
                                                triangular);
  }
  return static_cast<int>(cudaGetLastError());
}
