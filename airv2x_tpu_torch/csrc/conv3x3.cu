// K4: 3x3 stride-1 SAME convolution with a fused per-channel affine + ReLU
// epilogue (eval BatchNorm folded into scale / bias), NHWC x HWIO -> NHWC.
//
// Replaces the TPU kernels airv2x_tpu/ops/pallas_conv.py:_kernel (K4a, a
// grid over maps) and _kernel_allmaps (K4b, every map in one invocation),
// both reached through conv3x3_same.
//
// What it computes, per map b, pixel (y, x) and output channel o:
//   acc = sum over di, dj in 0..2 and input channels c of
//         x[b, y + di - 1, x + dj - 1, c] * w[di, dj, c, o]   (zero outside)
//   out[b, y, x, o] = cast(relu?(acc * scale[o] + bias[o]))
// with f32 accumulation over operands of x's type (bf16 or f32) and the
// epilogue in f32, as the TPU kernel does.
//
// What bounds it on an H100: at the flagship backbone's shapes (6 maps,
// 100x352x64, 50x176x128, 25x88x256) every launch does 15.57 GFLOP; in
// bf16 that is ~15.7 us of tensor-core time against 4.4-16.1 us of HBM
// traffic, so operations bound it at stages 1-2 and bytes barely at stage
// 0. In f32 without tensor cores it is ~232 us of FMA time per launch.
//
// Design: an implicit GEMM, M = output pixels of one map, N = Cout,
// K = 9 * Cin. A block of 256 threads owns an 8 x 16 pixel tile and 64
// output channels. For each chunk of input channels it stages the
// (8 + 2) x (16 + 2) input halo in shared memory once, zero-filled by
// predicated 16-byte loads at the map's border, and reuses it for all nine
// taps: that is what the TPU kernel's column concat and row slices buy,
// and no padded or concatenated copy is made in HBM. The weights of the
// chunk are staged as [tap][chunk channel][64 outputs].
//   * bf16: tensor cores through nvcuda::wmma (m16n16k16, f32
//     accumulators). Warp w computes tile row w (16 pixels) x 64 outputs;
//     for a tap the A fragment is 16 consecutive halo pixels, which lie
//     one chunk (16 channels) apart, so the halo needs no im2col. The
//     accumulators go through an f32 staging tile in shared memory to the
//     epilogue, which masks the ragged edge of the map (H = 25 and
//     W = 88 at stage 2 are not multiples of the tile).
//   * f32: the same staging with plain FMAs, no TF32, so f32 parity with
//     a full-precision reference is tight: each thread accumulates 8
//     pixels x 4 outputs.
// The epilogue uses _rn intrinsics (no contracted multiply-add), rounding
// as the plain PyTorch version does. K4b is the same kernel with one block
// walking every map of its tile (maps_per_block = B), one launch in all;
// K4a puts the maps on the grid. Channels must be multiples of 8 (16-byte
// loads), which the callers' support gate already requires.
// wgmma, TMA and warp specialisation are left to a later redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kTH = 8;        // output rows per block tile
constexpr int kTW = 16;       // output columns per block tile
constexpr int kTN = 64;       // output channels per block tile
constexpr int kHH = kTH + 2;  // halo rows
constexpr int kHW = kTW + 2;  // halo columns
constexpr int kThreads = 256;
constexpr int kLds = kTN + 4;  // f32 staging row stride (bf16 epilogue)
constexpr int kSmemBytes = kTH * kTW * kLds * 4;  // >= halo + weights

template <typename T>
struct Chunk;  // input channels staged per pass
template <>
struct Chunk<bf16> {
  static constexpr int kc = 16;  // one wmma K step
};
template <>
struct Chunk<float> {
  static constexpr int kc = 8;
};

static_assert((kHH * kHW + 9 * kTN) * 16 * 2 <= kSmemBytes, "bf16 smem");
static_assert((kHH * kHW + 9 * kTN) * 8 * 4 <= kSmemBytes, "f32 smem");

struct Shape {
  int H, W, Cin, Cout;
};
struct Tile {
  int b, y0, x0, n0;
};

// Stage the input halo [kHH][kHW][KC] and the weights [9][KC][kTN] of input
// channels [c0, c0 + KC), zero outside the map and past Cin / Cout.
template <typename T, int KC>
__device__ __forceinline__ void load_chunk(const T* __restrict__ x,
                                           const T* __restrict__ w, T* xs,
                                           T* ws, const Shape& s,
                                           const Tile& t, int c0) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int VPP = KC / V;
  for (int i = threadIdx.x; i < kHH * kHW * VPP; i += kThreads) {
    const int v = i % VPP, pix = i / VPP;
    const int hy = pix / kHW, hx = pix - hy * kHW;
    const int gy = t.y0 + hy - 1, gx = t.x0 + hx - 1, c = c0 + v * V;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gy >= 0 && gy < s.H && gx >= 0 && gx < s.W && c < s.Cin) {
      val = __ldg(reinterpret_cast<const uint4*>(
          x + ((static_cast<long long>(t.b) * s.H + gy) * s.W + gx) * s.Cin +
          c));
    }
    *reinterpret_cast<uint4*>(xs + pix * KC + v * V) = val;
  }
  constexpr int VN = kTN / V;
  for (int i = threadIdx.x; i < 9 * KC * VN; i += kThreads) {
    const int v = i % VN, row = i / VN;  // row = tap * KC + k
    const int k = row % KC, tap = row / KC;
    const int ci = c0 + k, co = t.n0 + v * V;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (ci < s.Cin && co < s.Cout) {
      val = __ldg(reinterpret_cast<const uint4*>(
          w + (static_cast<long long>(tap) * s.Cin + ci) * s.Cout + co));
    }
    *reinterpret_cast<uint4*>(ws + row * kTN + v * V) = val;
  }
}

__device__ __forceinline__ float epilogue(float acc, float sc, float bi,
                                          int relu) {
  const float v = __fadd_rn(__fmul_rn(acc, sc), bi);
  return relu ? fmaxf(v, 0.0f) : v;
}

__device__ void conv_tile(const bf16* __restrict__ x,
                          const bf16* __restrict__ w,
                          const float* __restrict__ scale,
                          const float* __restrict__ bias,
                          bf16* __restrict__ out, const Shape& s,
                          const Tile& t, int relu, unsigned char* smem) {
  constexpr int KC = Chunk<bf16>::kc;
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* ws = xs + kHH * kHW * KC;
  const int warp = threadIdx.x / 32;  // tile row
  // 16-column fragments that hold at least one real output channel
  const int nfrag = min(kTN / 16, (s.Cout - t.n0 + 15) / 16);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kTN / 16];
#pragma unroll
  for (int f = 0; f < kTN / 16; ++f) wmma::fill_fragment(acc[f], 0.0f);

  for (int c0 = 0; c0 < s.Cin; c0 += KC) {
    __syncthreads();  // the previous chunk's fragments are loaded
    load_chunk<bf16, KC>(x, w, xs, ws, s, t, c0);
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int di = tap / 3, dj = tap % 3;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, xs + ((warp + di) * kHW + dj) * KC, KC);
#pragma unroll
      for (int f = 0; f < kTN / 16; ++f) {
        if (f < nfrag) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(b, ws + tap * KC * kTN + f * 16, kTN);
          wmma::mma_sync(acc[f], a, b, acc[f]);
        }
      }
    }
  }

  __syncthreads();  // every warp is done with the halo and weights
  float* st = reinterpret_cast<float*>(smem);  // [kTH * kTW][kLds]
#pragma unroll
  for (int f = 0; f < kTN / 16; ++f) {
    wmma::store_matrix_sync(st + warp * 16 * kLds + f * 16, acc[f], kLds,
                            wmma::mem_row_major);
  }
  __syncthreads();
  // two output channels per thread: one 4-byte store, a warp's stores
  // cover 128 contiguous bytes of one pixel's channels
  for (int i = threadIdx.x; i < kTH * kTW * (kTN / 2); i += kThreads) {
    const int cp = i % (kTN / 2), p = i / (kTN / 2);
    const int gy = t.y0 + p / kTW, gx = t.x0 + p % kTW, gc = t.n0 + 2 * cp;
    if (gy < s.H && gx < s.W && gc < s.Cout) {
      const float* a = st + p * kLds + 2 * cp;
      const float v0 = epilogue(a[0], __ldg(scale + gc), __ldg(bias + gc), relu);
      const float v1 =
          epilogue(a[1], __ldg(scale + gc + 1), __ldg(bias + gc + 1), relu);
      *reinterpret_cast<__nv_bfloat162*>(
          out + ((static_cast<long long>(t.b) * s.H + gy) * s.W + gx) *
                    s.Cout +
          gc) = __floats2bfloat162_rn(v0, v1);
    }
  }
}

__device__ void conv_tile(const float* __restrict__ x,
                          const float* __restrict__ w,
                          const float* __restrict__ scale,
                          const float* __restrict__ bias,
                          float* __restrict__ out, const Shape& s,
                          const Tile& t, int relu, unsigned char* smem) {
  constexpr int KC = Chunk<float>::kc;
  float* xs = reinterpret_cast<float*>(smem);
  float* ws = xs + kHH * kHW * KC;
  const int q = threadIdx.x % 16;   // output channels 4q .. 4q + 3
  const int pg = threadIdx.x / 16;  // tile row pg / 2, columns cb .. cb + 7
  const int r = pg >> 1, cb = (pg & 1) * 8;

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  }

  for (int c0 = 0; c0 < s.Cin; c0 += KC) {
    __syncthreads();
    load_chunk<float, KC>(x, w, xs, ws, s, t, c0);
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int di = tap / 3, dj = tap % 3;
      const float* xr = xs + ((r + di) * kHW + cb + dj) * KC;
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        const float4 wv =
            *reinterpret_cast<const float4*>(ws + (tap * KC + k) * kTN + 4 * q);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float xv = xr[j * KC + k];
          acc[j][0] = fmaf(xv, wv.x, acc[j][0]);
          acc[j][1] = fmaf(xv, wv.y, acc[j][1]);
          acc[j][2] = fmaf(xv, wv.z, acc[j][2]);
          acc[j][3] = fmaf(xv, wv.w, acc[j][3]);
        }
      }
    }
  }

  const int gy = t.y0 + r, gc = t.n0 + 4 * q;
  if (gy >= s.H || gc >= s.Cout) return;  // Cout % 4 == 0: all 4 or none
  float sc[4], bi[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    sc[e] = __ldg(scale + gc + e);
    bi[e] = __ldg(bias + gc + e);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int gx = t.x0 + cb + j;
    if (gx < s.W) {
      float4 v;
      v.x = epilogue(acc[j][0], sc[0], bi[0], relu);
      v.y = epilogue(acc[j][1], sc[1], bi[1], relu);
      v.z = epilogue(acc[j][2], sc[2], bi[2], relu);
      v.w = epilogue(acc[j][3], sc[3], bi[3], relu);
      *reinterpret_cast<float4*>(
          out + ((static_cast<long long>(t.b) * s.H + gy) * s.W + gx) *
                    s.Cout +
          gc) = v;
    }
  }
}

// blockIdx: x = column tile, y = row tile, z = map group * Cout tiles +
// Cout tile. A block computes its tile for maps [b0, b0 + maps_per_block).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias, T* __restrict__ out, int B,
                   Shape s, int maps_per_block, int relu) {
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  const int ntn = (s.Cout + kTN - 1) / kTN;
  Tile t;
  t.x0 = blockIdx.x * kTW;
  t.y0 = blockIdx.y * kTH;
  t.n0 = (blockIdx.z % ntn) * kTN;
  const int b0 = (blockIdx.z / ntn) * maps_per_block;
  const int b1 = min(B, b0 + maps_per_block);
  for (t.b = b0; t.b < b1; ++t.b) {
    conv_tile(x, w, scale, bias, out, s, t, relu, smem);
  }
}

}  // namespace

extern "C" int conv3x3(const void* x, const void* w, const float* scale,
                       const float* bias, void* out, int B, int H, int W,
                       int Cin, int Cout, int relu, int allmaps, int is_bf16,
                       cudaStream_t stream) {
  if (Cin % 8 != 0 || Cout % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  const Shape s{H, W, Cin, Cout};
  const int ntn = (Cout + kTN - 1) / kTN;
  const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH,
                  allmaps ? ntn : ntn * B);
  const int mpb = allmaps ? B : 1;
  if (is_bf16) {
    conv3x3_kernel<bf16><<<grid, kThreads, 0, stream>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w), scale, bias,
        static_cast<bf16*>(out), B, s, mpb, relu);
  } else {
    conv3x3_kernel<float><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), scale,
        bias, static_cast<float*>(out), B, s, mpb, relu);
  }
  return static_cast<int>(cudaGetLastError());
}
