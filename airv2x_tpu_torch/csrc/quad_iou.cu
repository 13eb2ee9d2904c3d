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
// What bounds it on an H100: operations. Each pair that needs the clip is
// ~720 non-tensor-core f32 operations on 64 bytes of corners, far above the
// card's ~20 FLOP/byte ridge; NMS calls it at 512 x 512 on the strict upper
// triangle (~131k pairs), where almost every pair of an NMS pool is far
// apart: the clip of such a pair only ever yields 0.
//
// Design:
//   * Blocks of 256 threads own T x T tiles (T = 16). With `triangular` the
//     grid covers only tile pairs bi <= bj of an S x S tile grid (S covers N
//     and M): each block computes tile (bi, bj) and, off the diagonal,
//     zero-fills its mirror (bj, bi), so every tile is written once and
//     every pair i < j lies in a computed tile (greedy NMS reads only pairs
//     where the row outranks the column). Full mode has a block per tile.
//     ops/quad_iou.py:iou_blocks mirrors the map.
//   * The tile's row and column quads are staged once in shared memory, with
//     per quad its axis-aligned box, |area|, 1 / shortest edge, corner factor,
//     largest coordinate and whether it is finite and strictly convex.
//   * Prefilter (ops/quad_iou.py:_separated is its plain form): a pair whose
//     boxes lie apart by more than the clip's tolerance can reach (tol2
//     over the shortest edge, times the corner factor, plus 64 ulps of the
//     coordinates) gets IoU +0.0, as the clip would give, written coalesced.
//     The test is `gap > margin`, so a NaN falls through. The other pairs
//     go to a shared-memory queue (a warp ballot, one atomicAdd per warp).
//     The survivors cluster where the NMS pool's boxes overlap, often near
//     the diagonal, and a block clips its own: T = 16 keeps the busiest
//     block's queue short (measured on an H100 against T = 32 and 64 with
//     128-512 threads: the fastest in triangular mode on NMS inputs).
//   * Each queued pair is clipped by 8 lanes, one per directed edge: 4 of
//     A's edges clipped to B, 4 of B's to A. The group's first lane gathers
//     each quad's four edge terms and adds them in the plain version's
//     order (e0 + e1 + e2 + e3), so a pair is computed bit for bit as the
//     clip of every pair was before the prefilter.
// Every pair is centred at A's first corner, so the cross products stay
// local-scale at 140 m BEV offsets. The cross products and the area
// accumulation use the _rn intrinsics, so no multiply-add is contracted:
// the `den - tol` tests then classify near-parallel edges exactly as the
// plain PyTorch version does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kTol = 1e-4f;
constexpr float kEps = 1e-8f;
constexpr float kBig = 1e9f;
constexpr float kUlps = 64.0f / 16777216.0f;  // 64 x 2^-24
constexpr float kMinTurn = 1.0f / 1024.0f;
constexpr int kTile = 16;
constexpr int kThreads = 256;
constexpr int kPairs = kTile * kTile;

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

// torch.sign, torch.maximum and torch.minimum: a NaN propagates (fmaxf and
// fminf would drop it), so a pair with a NaN corner gives what the plain
// version gives
__device__ __forceinline__ float sign_of(float v) {
  return v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : (v == 0.0f ? 0.0f : v));
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

// cross(p, q) x dt x w of the directed edge p -> q of P clipped to the
// inside of H (orientation sign sgn_h); the caller adds the four edges.
__device__ float edge_term(float px, float py, float qx, float qy,
                           const float* xh, const float* yh, float sgn_h,
                           float tol2) {
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
      tlo = max_nan(tlo, __fdiv_rn(-num, den));
    } else if (-den - tol2 >= 0.0f) {  // leaving constraint
      thi = min_nan(thi, __fdiv_rn(-num, den));
    } else {  // parallel: outside, or on the boundary
      emp = emp || (-num - tol2 >= 0.0f);
      coll = coll || (tol2 - fabsf(num) >= 0.0f);
    }
  }
  const float t0 = max_nan(tlo, 0.0f);
  const float t1 = min_nan(thi, 1.0f);
  const float dt = emp ? 0.0f : max_nan(t1 - t0, 0.0f);
  const float w = coll ? 0.5f : 1.0f;
  return __fmul_rn(cross_e, __fmul_rn(dt, w));
}

// What the prefilter needs of one quad (ops/quad_iou.py:_quad_terms).
struct QuadTerms {
  float xmin, xmax, ymin, ymax, area, rlmin, kappa, scale;
  int ok;
};

__device__ QuadTerms quad_terms(const float* c) {
  float x[4], y[4], ex[4], ey[4], len[4];
  bool finite = true;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    x[k] = c[2 * k];
    y[k] = c[2 * k + 1];
    finite = finite && isfinite(x[k]) && isfinite(y[k]);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    ex[k] = x[(k + 1) & 3] - x[k];
    ey[k] = y[(k + 1) & 3] - y[k];
    len[k] = sqrtf(__fadd_rn(__fmul_rn(ex[k], ex[k]), __fmul_rn(ey[k], ey[k])));
  }
  float xc[4], yc[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    xc[k] = x[k] - x[0];
    yc[k] = y[k] - y[0];
  }
  const float area = signed_area(xc, yc);
  const float sgn = sign_of(area);
  QuadTerms q;
  q.kappa = 0.0f;
  bool convex = true;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int n = (k + 1) & 3;
    const float turn = cross_rn(ex[k], ey[n], ey[k], ex[n]);
    const float lprod = __fmul_rn(len[k], len[n]);
    q.kappa = fmaxf(q.kappa, __fdiv_rn(__fmul_rn(2.0f, lprod), fabsf(turn)));
    convex = convex && turn != 0.0f &&
             __fmul_rn(turn, sgn) >= __fmul_rn(kMinTurn, lprod);
  }
  q.xmin = fminf(fminf(x[0], x[1]), fminf(x[2], x[3]));
  q.xmax = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]));
  q.ymin = fminf(fminf(y[0], y[1]), fminf(y[2], y[3]));
  q.ymax = fmaxf(fmaxf(y[0], y[1]), fmaxf(y[2], y[3]));
  q.area = fabsf(area);
  q.rlmin = __fdiv_rn(1.0f, fminf(fminf(len[0], len[1]), fminf(len[2], len[3])));
  q.scale = fmaxf(fmaxf(fmaxf(fabsf(x[0]), fabsf(x[1])),
                        fmaxf(fabsf(x[2]), fabsf(x[3]))),
                  fmaxf(fmaxf(fabsf(y[0]), fabsf(y[1])),
                        fmaxf(fabsf(y[2]), fabsf(y[3]))));
  q.ok = finite && convex;
  return q;
}

// ops/quad_iou.py:_separated for one pair: the boxes lie apart by more
// than the clip can reach; false for a NaN.
__device__ __forceinline__ bool separated(const QuadTerms& a,
                                          const QuadTerms& b) {
  const float gap = fmaxf(fmaxf(b.xmin - a.xmax, a.xmin - b.xmax),
                          fmaxf(b.ymin - a.ymax, a.ymin - b.ymax));
  const float tol2 =
      kTol * __fadd_rn(__fmul_rn(fmaxf(a.area, b.area), 1.001f), 1.0f);
  const float margin = __fmul_rn(
      fmaxf(a.kappa, b.kappa),
      __fadd_rn(__fmul_rn(__fmul_rn(2.0f, tol2), fmaxf(a.rlmin, b.rlmin)),
                __fmul_rn(kUlps, __fadd_rn(fmaxf(a.scale, b.scale), 1.0f))));
  return a.ok && b.ok && gap > margin;
}

// The tile of this block and, in triangular mode, the mirror it zero-fills
// (ops/quad_iou.py:iou_blocks); -1 where there is none.
__device__ __forceinline__ void block_tiles(int N, int M, int triangular,
                                            int* bi, int* bj, int* zi,
                                            int* zj) {
  const int tn = (N + kTile - 1) / kTile, tm = (M + kTile - 1) / kTile;
  int k = blockIdx.x;
  if (!triangular) {
    *bi = k / tm;
    *bj = k % tm;
    *zi = *zj = -1;
    return;
  }
  const int s = max(tn, tm);
  int r = 0;
  while (k >= s - r) {
    k -= s - r;
    ++r;
  }
  const int c = r + k;
  const bool computed = r < tn && c < tm;
  *bi = computed ? r : -1;
  *bj = computed ? c : -1;
  const bool mirror = r < c && c < tn && r < tm;
  *zi = mirror ? c : -1;
  *zj = mirror ? r : -1;
}

__global__ void __launch_bounds__(kThreads)
    quad_iou_kernel(const float* __restrict__ rows,
                    const float* __restrict__ cols, float* __restrict__ out,
                    int N, int M, int triangular) {
  __shared__ float srow[kTile][8];
  __shared__ float scol[kTile][8];
  __shared__ QuadTerms trow[kTile];
  __shared__ QuadTerms tcol[kTile];
  __shared__ uint16_t queue[kPairs];
  __shared__ int count;

  int bi, bj, zi, zj;
  block_tiles(N, M, triangular, &bi, &bj, &zi, &zj);
  const int tid = threadIdx.x;
  if (zi >= 0) {  // the mirror tile: every (i, j) there has i > j
    for (int p = tid; p < kPairs; p += kThreads) {
      const int i = zi * kTile + p / kTile, j = zj * kTile + p % kTile;
      if (i < N && j < M) out[static_cast<long long>(i) * M + j] = 0.0f;
    }
  }
  if (bi < 0) return;
  const int row0 = bi * kTile, col0 = bj * kTile;

  for (int t = tid; t < 2 * kTile * 8; t += kThreads) {
    const bool is_row = t < kTile * 8;
    const int q = (is_row ? t : t - kTile * 8) / 8, c = t % 8;
    if (is_row) {
      srow[q][c] = row0 + q < N ? rows[(row0 + q) * 8 + c] : 0.0f;
    } else {
      scol[q][c] = col0 + q < M ? cols[(col0 + q) * 8 + c] : 0.0f;
    }
  }
  if (tid == 0) count = 0;
  __syncthreads();
  if (tid < kTile) {
    trow[tid] = quad_terms(srow[tid]);
  } else if (tid < 2 * kTile) {
    tcol[tid - kTile] = quad_terms(scol[tid - kTile]);
  }
  __syncthreads();

  // prefilter: consecutive threads take consecutive columns
  const int lane = tid % 32;
  for (int p = tid; p < kPairs; p += kThreads) {
    const int li = p / kTile, lj = p % kTile;
    const int i = row0 + li, j = col0 + lj;
    const bool live = i < N && j < M;
    const bool far = live && separated(trow[li], tcol[lj]);
    if (far) out[static_cast<long long>(i) * M + j] = 0.0f;
    const unsigned need = __ballot_sync(0xffffffffu, live && !far);
    if (need) {
      int base = 0;
      if (lane == 0) base = atomicAdd(&count, __popc(need));
      base = __shfl_sync(0xffffffffu, base, 0);
      if (live && !far) {
        queue[base + __popc(need & ((1u << lane) - 1))] =
            static_cast<uint16_t>(p);
      }
    }
  }
  __syncthreads();

  // the clip: 8 lanes per queued pair, lane e < 4 A's edge e clipped to B,
  // lane 4 + e B's edge e clipped to A
  const int n_queued = count;
  const int g = tid / 8, e = tid % 8, first = lane & ~7;
  for (int q0 = 0; q0 < n_queued; q0 += kThreads / 8) {
    const int q = q0 + g;
    const bool active = q < n_queued;
    const int p = active ? queue[q] : 0;
    const float* a = srow[p / kTile];
    const float* b = scol[p % kTile];
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
    const float tol2 = kTol * (max_nan(aa, ab) + 1.0f);
    const int k = e & 3, kn = (k + 1) & 3;
    const float term =
        e < 4 ? edge_term(xa[k], ya[k], xa[kn], ya[kn], xb, yb, sgn_b, tol2)
              : edge_term(xb[k], yb[k], xb[kn], yb[kn], xa, ya, sgn_a, tol2);
    float t[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) t[r] = __shfl_sync(0xffffffffu, term, first + r);
    if (active && e == 0) {
      float suma = 0.0f, sumb = 0.0f;  // in the order e0 + e1 + e2 + e3
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        suma = __fadd_rn(suma, t[r]);
        sumb = __fadd_rn(sumb, t[4 + r]);
      }
      const float pa = __fmul_rn(suma, sgn_a);
      const float pb = __fmul_rn(sumb, sgn_b);
      // a quad of area within tol2 of zero has no reliable half-planes:
      // its intersection is 0 (ops/quad_iou.py:quad_iou_plain)
      const float inter = (aa <= tol2 || ab <= tol2)
                              ? 0.0f : 0.5f * fabsf(__fadd_rn(pa, pb));
      const float uni = aa + ab - inter;
      out[static_cast<long long>(row0 + p / kTile) * M + col0 + p % kTile] =
          inter / max_nan(uni, kEps);
    }
  }
}

}  // namespace

// rows (N, 4, 2) and cols (M, 4, 2) f32, out (N, M) f32.
extern "C" int quad_iou(const float* rows, const float* cols, float* out,
                        int N, int M, int triangular, cudaStream_t stream) {
  if (N > 0 && M > 0) {
    const int tn = (N + kTile - 1) / kTile, tm = (M + kTile - 1) / kTile;
    const int s = tn > tm ? tn : tm;
    const int blocks = triangular ? s * (s + 1) / 2 : tn * tm;
    quad_iou_kernel<<<blocks, kThreads, 0, stream>>>(rows, cols, out, N, M,
                                                     triangular);
  }
  return static_cast<int>(cudaGetLastError());
}
