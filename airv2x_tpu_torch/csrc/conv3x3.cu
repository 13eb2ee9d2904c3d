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
// epilogue in f32 (_rn intrinsics, no contracted multiply-add, one rounding
// to the output type), as the TPU kernel and the plain PyTorch version do.
//
// What bounds it on an H100: at the flagship backbone's shapes (6 maps,
// 100x352x64, 50x176x128, 25x88x256) every launch does 15.57 GFLOP; in
// bf16 that is ~15.7 us of tensor-core time against 4.4-16.1 us of HBM
// traffic, so operations bound it at stages 1-2 and bytes barely at stage
// 0. In f32 without tensor cores it is ~232 us of FMA time per launch.
//
// bf16: an implicit GEMM on Hopper's wgmma, fed by TMA through rings of
// shared-memory slots (the shape of a fast Hopper GEMM):
//   * M = `maps` maps x a tile of tile_h x tile_w output pixels (64 to 384
//     rows, whole m64 blocks of one map each), N = block_n output channels
//     (64 or 128), K = 9 taps x Cin in 64-channel chunks.
//   * A: per (chunk, column shift dj) one TMA box of a 4-D tensor map over x
//     (C, W, H, B): {64 channels, tile_w, tile_h + 2, maps} at (x0 + dj - 1,
//     y0 - 1), i.e. the tile's rows with one halo row above and below. TMA
//     fills what lies outside the map with zeros: the SAME padding, and the
//     channels past Cin (Cin = 8 or 24 loads one 64-channel box). Each
//     pixel's 128 bytes land in the 128-byte swizzle that wgmma reads
//     K-major. The A tile of tap (di, dj) is the box's window that starts di
//     x tile_w pixels in; tile_w is a multiple of 8, so the window starts on
//     a 1024-byte swizzle atom and is a valid operand as it lies. So the
//     input is read three times per chunk from L2 instead of nine (a box per
//     tap, 243 MB per launch at stage 0), and no ldmatrix or unswizzled
//     layout is needed, which a full (tile_h + 2) x (tile_w + 2) halo would
//     require: its column shifts break the swizzle atom.
//   * B: per (chunk, tap) block_n / 64 boxes {64 outputs, 64 input
//     channels, 1 tap} of a 3-D tensor map over the HWIO weights (Cout, Cin,
//     9), read MN-major by wgmma, so the weights need no transposed copy.
//     Rows past Cin and columns past Cout are TMA's zeros.
//   * Two rings with "full" / "empty" mbarriers: A (a_stages slots, one per
//     column shift) and B (b_stages slots, one per tap). One producer warp
//     (its lane 0) walks (map group, chunk, dj, di) and keeps loads in
//     flight; WG consumer warpgroups each own MR m64 blocks: per tap they
//     start 4 x MR m64nNk16 wgmmas (K = 16 each) with f32 accumulators in
//     registers, keep that group in flight (wgmma.wait_group 1) and release
//     the slots the group before it read.
//   * The epilogue reads the accumulators straight from registers: f32
//     scale / bias / ReLU with _rn intrinsics, one bf16 rounding, bf16x2
//     stores masked at the ragged edge (H = 25 and W = 88 at stage 2) and
//     past Cout.
//   * K4a puts the maps on the grid (one map per block). K4b (allmaps) is
//     one launch in which each block computes every map of its spatial tile:
//     `maps` of them side by side in M, sharing each weight load, and the
//     next group after this one's epilogue, with the rings running on.
//   * The tile plan (ops/conv3x3.py:conv3x3_plan) picks the instantiation
//     (CONV3X3_PLANS), the tile, block_n and the ring depths per shape from
//     a time model (L2 bytes + tensor-core work), and mirrors the block ->
//     tile mapping below; it is tested on the CPU.
// What holds it back (measured, PERF.md): about 35-40% of the bound at the
// flagship stages. Per tap, SS wgmma reads A and B from shared memory: at
// N = 64 (stage 0) that alone is the SM's whole shared-memory bandwidth at
// the tensor cores' peak, and every block pulls its A boxes three times and
// all its weights once per map from L2 (about 5.5 TB/s).
// f32 keeps the FMA design (the full-precision parity path, no TF32): a
// block of 256 threads owns an 8 x 16 pixel tile and 64 output channels,
// stages the (8 + 2) x (16 + 2) input halo of 8 channels at a time in shared
// memory with predicated 16-byte loads and reuses it for the nine taps;
// each thread accumulates 8 pixels x 4 outputs.
// Channels must be multiples of 8 (16-byte loads, 16-byte TMA strides),
// which the callers' support gate already requires.

#include <cuda.h>  // CUtensorMap, cuTensorMapEncodeTiled (libcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float epilogue(float acc, float sc, float bi,
                                          int relu) {
  const float v = __fadd_rn(__fmul_rn(acc, sc), bi);
  return relu ? fmaxf(v, 0.0f) : v;
}

// ---------------------------------------------------------------- f32 ----

constexpr int kTH = 8;        // output rows per block tile
constexpr int kTW = 16;       // output columns per block tile
constexpr int kTN = 64;       // output channels per block tile
constexpr int kHH = kTH + 2;  // halo rows
constexpr int kHW = kTW + 2;  // halo columns
constexpr int kKC = 8;        // input channels staged per pass
constexpr int kThreads = 256;
constexpr int kF32SmemBytes = (kHH * kHW + 9 * kTN) * kKC * 4;

struct Shape {
  int H, W, Cin, Cout;
};
struct Tile {
  int b, y0, x0, n0;
};

// Stage the input halo [kHH][kHW][kKC] and the weights [9][kKC][kTN] of
// input channels [c0, c0 + kKC), zero outside the map and past Cin / Cout.
__device__ __forceinline__ void load_chunk(const float* __restrict__ x,
                                           const float* __restrict__ w,
                                           float* xs, float* ws,
                                           const Shape& s, const Tile& t,
                                           int c0) {
  constexpr int V = 4;  // floats per 16-byte load
  constexpr int VPP = kKC / V;
  for (int i = threadIdx.x; i < kHH * kHW * VPP; i += kThreads) {
    const int v = i % VPP, pix = i / VPP;
    const int hy = pix / kHW, hx = pix - hy * kHW;
    const int gy = t.y0 + hy - 1, gx = t.x0 + hx - 1, c = c0 + v * V;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gy >= 0 && gy < s.H && gx >= 0 && gx < s.W && c < s.Cin) {
      val = __ldg(reinterpret_cast<const float4*>(
          x + ((static_cast<long long>(t.b) * s.H + gy) * s.W + gx) * s.Cin +
          c));
    }
    *reinterpret_cast<float4*>(xs + pix * kKC + v * V) = val;
  }
  constexpr int VN = kTN / V;
  for (int i = threadIdx.x; i < 9 * kKC * VN; i += kThreads) {
    const int v = i % VN, row = i / VN;  // row = tap * kKC + k
    const int k = row % kKC, tap = row / kKC;
    const int ci = c0 + k, co = t.n0 + v * V;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ci < s.Cin && co < s.Cout) {
      val = __ldg(reinterpret_cast<const float4*>(
          w + (static_cast<long long>(tap) * s.Cin + ci) * s.Cout + co));
    }
    *reinterpret_cast<float4*>(ws + row * kTN + v * V) = val;
  }
}

__device__ void conv_tile_f32(const float* __restrict__ x,
                              const float* __restrict__ w,
                              const float* __restrict__ scale,
                              const float* __restrict__ bias,
                              float* __restrict__ out, const Shape& s,
                              const Tile& t, int relu, float* smem) {
  float* xs = smem;
  float* ws = xs + kHH * kHW * kKC;
  const int q = threadIdx.x % 16;   // output channels 4q .. 4q + 3
  const int pg = threadIdx.x / 16;  // tile row pg / 2, columns cb .. cb + 7
  const int r = pg >> 1, cb = (pg & 1) * 8;

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  }

  for (int c0 = 0; c0 < s.Cin; c0 += kKC) {
    __syncthreads();
    load_chunk(x, w, xs, ws, s, t, c0);
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int di = tap / 3, dj = tap % 3;
      const float* xr = xs + ((r + di) * kHW + cb + dj) * kKC;
#pragma unroll
      for (int k = 0; k < kKC; ++k) {
        const float4 wv = *reinterpret_cast<const float4*>(
            ws + (tap * kKC + k) * kTN + 4 * q);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float xv = xr[j * kKC + k];
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
__global__ void __launch_bounds__(kThreads)
    conv3x3_f32_kernel(const float* __restrict__ x,
                       const float* __restrict__ w,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias,
                       float* __restrict__ out, int B, Shape s,
                       int maps_per_block, int relu) {
  __shared__ __align__(16) float smem[kF32SmemBytes / 4];
  const int ntn = (s.Cout + kTN - 1) / kTN;
  Tile t;
  t.x0 = blockIdx.x * kTW;
  t.y0 = blockIdx.y * kTH;
  t.n0 = (blockIdx.z % ntn) * kTN;
  const int b0 = (blockIdx.z / ntn) * maps_per_block;
  const int b1 = min(B, b0 + maps_per_block);
  for (t.b = b0; t.b < b1; ++t.b) {
    conv_tile_f32(x, w, scale, bias, out, s, t, relu, smem);
  }
}

// --------------------------------------------------------------- bf16 ----

constexpr int kChunk = 64;      // input channels per step: one 128-byte row
constexpr int kRowBytes = 128;  // one pixel (A) or one weight row (B)
constexpr int kBoxB = kChunk * kRowBytes;  // one 64 x 64 weight box
constexpr int kMaxStages = 16;

struct ConvArgs {
  int B, H, W, Cin, Cout;
  int tile_h, tile_w, tiles_x, ntn, maps, groups, a_stages, b_stages, relu;
  const float* scale;
  const float* bias;
  bf16* out;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait until the phase of `bar` with this parity has completed. A phase
// that never completes is a fault of the pipeline's bookkeeping: after two
// seconds the kernel traps, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(bar, parity)) {
    if (global_ns() - t0 > 2000000000ull) __trap();
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma (the registers change when the group completes).
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x N] += A[64 x 16] (K-major, 128-byte swizzle) x B[16 x N]
// (MN-major, 128-byte swizzle); f32 accumulators, bf16 operands.
template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t da,
                                      uint64_t db);

template <>
__device__ __forceinline__ void wgmma<64>(float (&d)[32], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<128>(float (&d)[64], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// Ring bookkeeping: a slot index and the parity of its current round.
struct Ring {
  int slot = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next(int depth) {
    if (++slot == depth) {
      slot = 0;
      phase ^= 1;
    }
  }
};

// One block: a tile of tile_h x tile_w pixels of `maps` consecutive maps
// (M = maps x tile_h x tile_w rows, the map outermost) x BN outputs, for
// `groups` consecutive groups of maps. Warpgroups 0 .. WG - 1 compute, each
// MR x 64 rows; the warp after them loads. Two rings in shared memory, each
// slot 1024-byte aligned (the swizzle atom):
//   * A, a_stages slots: per (map group, 64-channel chunk, column shift dj)
//     one box of `maps` x (tile_h + 2) x tile_w pixels, the tile's rows
//     with the halo row above and below, shifted by dj - 1 columns. The
//     window of row shift di starts di x tile_w pixels in: a multiple of 8
//     pixels (1024 bytes), so every tap's A tile is an aligned, swizzled
//     K-major operand, and the input is read 3 times per chunk, not 9.
//   * B, b_stages slots: per (group, chunk, tap) the block_n / 64 weight
//     boxes of that tap and chunk.
// Then the mbarriers: a_full, a_empty, b_full, b_empty, one per slot.
template <int WG, int MR, int BN>
__global__ void __launch_bounds__(WG * 128 + 32, 1)
    conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap wmap,
                         const ConvArgs a) {
  constexpr int kBytesB = BN * kRowBytes;
  extern __shared__ unsigned char smem_raw[];
  const int pix = a.tile_h * a.tile_w;  // a multiple of 64
  const int bytes_a = a.maps * (a.tile_h + 2) * a.tile_w * kRowBytes;
  const uint32_t ring_a = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ring_b = ring_a + a.a_stages * bytes_a;
  const uint32_t a_full = ring_b + a.b_stages * kBytesB;
  const uint32_t a_empty = a_full + 8 * a.a_stages;
  const uint32_t b_full = a_empty + 8 * a.a_stages;
  const uint32_t b_empty = b_full + 8 * a.b_stages;

  if (threadIdx.x == 0) {
    for (int s = 0; s < a.a_stages; ++s) {
      mbar_init(a_full + 8 * s, 1);
      mbar_init(a_empty + 8 * s, WG * 128);
    }
    for (int s = 0; s < a.b_stages; ++s) {
      mbar_init(b_full + 8 * s, 1);
      mbar_init(b_empty + 8 * s, WG * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int nt = blockIdx.x % a.ntn, tile = blockIdx.x / a.ntn;
  const int y0 = (tile / a.tiles_x) * a.tile_h;
  const int x0 = (tile % a.tiles_x) * a.tile_w;
  const int n0 = nt * BN;
  const int bfirst = blockIdx.y * a.groups * a.maps;
  const int bend = min(a.B, bfirst + a.groups * a.maps);
  Ring ra, rb;

  if (threadIdx.x >= WG * 128) {  // the producer warp
    if (threadIdx.x == WG * 128) {
      for (int bg = bfirst; bg < bend; bg += a.maps) {
        for (int c0 = 0; c0 < a.Cin; c0 += kChunk) {
          for (int dj = 0; dj < 3; ++dj) {
            mbar_wait(a_empty + 8 * ra.slot, ra.phase ^ 1);
            const uint32_t fa = a_full + 8 * ra.slot;
            mbar_expect_tx(fa, bytes_a);
            tma_load_4d(ring_a + ra.slot * bytes_a, &xmap, fa, c0,
                        x0 + dj - 1, y0 - 1, bg);
            ra.next(a.a_stages);
            for (int di = 0; di < 3; ++di) {
              mbar_wait(b_empty + 8 * rb.slot, rb.phase ^ 1);
              const uint32_t fb = b_full + 8 * rb.slot;
              mbar_expect_tx(fb, kBytesB);
#pragma unroll
              for (int j = 0; j < BN / 64; ++j) {
                tma_load_3d(ring_b + rb.slot * kBytesB + j * kBoxB, &wmap, fb,
                            n0 + 64 * j, c0, 3 * di + dj);
              }
              rb.next(a.b_stages);
            }
          }
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  // byte offset of each of this warpgroup's m64 blocks in an A slot: map
  // g's window starts g x (tile_h + 2) x tile_w pixels in
  uint32_t off_a[MR];
#pragma unroll
  for (int r = 0; r < MR; ++r) {
    const int m = (wg * MR + r) * 64, g = m / pix;
    off_a[r] = ((g * (a.tile_h + 2)) * a.tile_w + (m - g * pix)) * kRowBytes;
  }
  float acc[MR][BN / 2];
  for (int bg = bfirst; bg < bend; bg += a.maps) {
#pragma unroll
    for (int r = 0; r < MR; ++r) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[r][i] = 0.0f;
    }
    // the slots read by the step still in flight, released once it is done
    int prev_b = -1, prev_a = -1;
    for (int c0 = 0; c0 < a.Cin; c0 += kChunk) {
      for (int dj = 0; dj < 3; ++dj) {
        mbar_wait(a_full + 8 * ra.slot, ra.phase);
        const uint32_t sa = ring_a + ra.slot * bytes_a;
        for (int di = 0; di < 3; ++di) {
          mbar_wait(b_full + 8 * rb.slot, rb.phase);
          const uint32_t sb = ring_b + rb.slot * kBytesB;
          const uint32_t row = di * a.tile_w * kRowBytes;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kChunk / 16; ++kk) {
            // B: 16 rows further down each 64-output box (2048 bytes);
            // boxes kBoxB apart, 8-row swizzle atoms 1024 bytes apart.
            const uint64_t db =
                smem_desc(sb + 16 * kRowBytes * kk, kBoxB, 1024);
#pragma unroll
            for (int r = 0; r < MR; ++r) {
              // A: 64 rows of 128 bytes; 16 channels = 32 bytes further
              // along each row; 8-row swizzle atoms 1024 bytes apart.
              wgmma<BN>(acc[r],
                        smem_desc(sa + off_a[r] + row + 32 * kk, 16, 1024),
                        db);
            }
          }
          wgmma_commit();
          wgmma_wait<1>();  // the previous step's products are done
          if (prev_b >= 0) mbar_arrive(b_empty + 8 * prev_b);
          if (prev_a >= 0) mbar_arrive(a_empty + 8 * prev_a);
          prev_b = rb.slot;
          prev_a = di == 2 ? ra.slot : -1;  // the A slot's last step
          rb.next(a.b_stages);
        }
        ra.next(a.a_stages);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int r = 0; r < MR; ++r) fence_acc(acc[r]);
    mbar_arrive(b_empty + 8 * prev_b);
    mbar_arrive(a_empty + 8 * prev_a);

    // accumulator layout of m64nN: warp w holds rows 16w .. 16w + 15;
    // acc[4j + 2h + e] is row 16w + lane / 4 + 8h, column 8j + 2 (lane % 4) + e
#pragma unroll
    for (int r = 0; r < MR; ++r) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = (wg * MR + r) * 64 + warp * 16 + lane / 4 + 8 * h;
        const int g = m / pix, p = m - g * pix;
        const int b = bg + g;
        const int gy = y0 + p / a.tile_w, gx = x0 + p % a.tile_w;
        if (b < bend && gy < a.H && gx < a.W) {
          bf16* orow =
              a.out + ((static_cast<long long>(b) * a.H + gy) * a.W + gx) *
                          a.Cout;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const int col = n0 + 8 * j + 2 * (lane % 4);
            if (col < a.Cout) {
              const float2 sc =
                  __ldg(reinterpret_cast<const float2*>(a.scale + col));
              const float2 bi =
                  __ldg(reinterpret_cast<const float2*>(a.bias + col));
              *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                  __floats2bfloat162_rn(
                      epilogue(acc[r][4 * j + 2 * h], sc.x, bi.x, a.relu),
                      epilogue(acc[r][4 * j + 2 * h + 1], sc.y, bi.y,
                               a.relu));
            }
          }
        }
      }
    }
  }
}

// A CUresult of the tensor-map encoder, returned past the CUDA runtime's
// error codes so that the wrapper can tell the two apart.
constexpr int kEncodeError = 10000;

int encode(CUtensorMap* map, const void* base, int rank,
           const cuuint64_t* dims, const cuuint64_t* strides,
           const cuuint32_t* box) {
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUresult r = cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
      dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);  // out of bounds: zeros
  return r == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(r);
}

template <int WG, int MR, int BN>
int launch_bf16(const CUtensorMap& xmap, const CUtensorMap& wmap,
                const ConvArgs& a, dim3 grid, cudaStream_t stream) {
  // raise the dynamic shared-memory limit once on each device (bit d)
  static unsigned long long attr_set = 0;
  auto* kernel = conv3x3_wgmma_kernel<WG, MR, BN>;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!(attr_set >> dev & 1ull)) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             232448);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set |= 1ull << dev;
  }
  const int smem =
      a.a_stages * a.maps * (a.tile_h + 2) * a.tile_w * kRowBytes +
      a.b_stages * BN * kRowBytes + 16 * (a.a_stages + a.b_stages) + 1024;
  kernel<<<grid, WG * 128 + 32, smem, stream>>>(xmap, wmap, a);
  return static_cast<int>(cudaGetLastError());
}

// The instantiations: warpgroups x m64 blocks per warpgroup x block_n, the
// ones the tile plan picks (ops/conv3x3.py:KERNELS).
#define CONV3X3_PLANS(X)                                            \
  X(1, 1, 64) X(1, 2, 64) X(2, 2, 64) X(2, 2, 128) X(3, 1, 64)       \
  X(3, 1, 128) X(3, 2, 64)

int conv3x3_bf16(const void* x, const void* w, const float* scale,
                 const float* bias, void* out, int B, int H, int W, int Cin,
                 int Cout, int relu, int allmaps, int tile_h, int tile_w,
                 int maps, int wgs, int mr, int block_n, int a_stages,
                 int b_stages, cudaStream_t stream) {
  if (tile_w < 8 || tile_w % 8 || tile_h < 1 || maps < 1 || tile_w > 256 ||
      tile_h > 254 || maps > 256 || tile_h * tile_w % 64 ||
      maps * tile_h * tile_w != wgs * mr * 64 || a_stages < 2 ||
      b_stages < 2 || a_stages > kMaxStages || b_stages > kMaxStages) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap xmap, wmap;
  const cuuint64_t xd[4] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H,
                            (cuuint64_t)B};
  const cuuint64_t xs[3] = {(cuuint64_t)Cin * 2, (cuuint64_t)W * Cin * 2,
                            (cuuint64_t)H * W * Cin * 2};
  const cuuint32_t xb[4] = {kChunk, (cuuint32_t)tile_w,
                            (cuuint32_t)tile_h + 2, (cuuint32_t)maps};
  int err = encode(&xmap, x, 4, xd, xs, xb);
  if (err) return err;
  const cuuint64_t wd[3] = {(cuuint64_t)Cout, (cuuint64_t)Cin, 9};
  const cuuint64_t ws[2] = {(cuuint64_t)Cout * 2, (cuuint64_t)Cin * Cout * 2};
  const cuuint32_t wb[3] = {64, kChunk, 1};
  err = encode(&wmap, w, 3, wd, ws, wb);
  if (err) return err;

  ConvArgs a;
  a.B = B;
  a.H = H;
  a.W = W;
  a.Cin = Cin;
  a.Cout = Cout;
  a.tile_h = tile_h;
  a.tile_w = tile_w;
  a.tiles_x = (W + tile_w - 1) / tile_w;
  a.ntn = (Cout + block_n - 1) / block_n;
  a.maps = maps;
  const int ngroups = (B + maps - 1) / maps;
  a.groups = allmaps ? ngroups : 1;  // K4b: a block walks every map
  a.a_stages = a_stages;
  a.b_stages = b_stages;
  a.relu = relu;
  a.scale = scale;
  a.bias = bias;
  a.out = static_cast<bf16*>(out);
  const int tiles = a.tiles_x * ((H + tile_h - 1) / tile_h);
  const dim3 grid(tiles * a.ntn, allmaps ? 1 : ngroups);
#define CONV3X3_LAUNCH(wg_, mr_, bn_)                                    \
  if (wgs == wg_ && mr == mr_ && block_n == bn_) {                       \
    return launch_bf16<wg_, mr_, bn_>(xmap, wmap, a, grid, stream);      \
  }
  CONV3X3_PLANS(CONV3X3_LAUNCH)
#undef CONV3X3_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// tile_h, tile_w, maps, wgs, mr, block_n, a_stages and b_stages are the
// bf16 tile plan (ops/conv3x3.py:conv3x3_plan); the f32 kernel has its
// fixed tiling.
extern "C" int conv3x3(const void* x, const void* w, const float* scale,
                       const float* bias, void* out, int B, int H, int W,
                       int Cin, int Cout, int relu, int allmaps, int is_bf16,
                       int tile_h, int tile_w, int maps, int wgs, int mr,
                       int block_n, int a_stages, int b_stages,
                       cudaStream_t stream) {
  if (Cin % 8 != 0 || Cout % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  if (is_bf16) {
    return conv3x3_bf16(x, w, scale, bias, out, B, H, W, Cin, Cout, relu,
                        allmaps, tile_h, tile_w, maps, wgs, mr, block_n,
                        a_stages, b_stages, stream);
  }
  const Shape s{H, W, Cin, Cout};
  const int ntn = (Cout + kTN - 1) / kTN;
  const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH,
                  allmaps ? ntn : ntn * B);
  conv3x3_f32_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), scale, bias,
      static_cast<float*>(out), B, s, allmaps ? B : 1, relu);
  return static_cast<int>(cudaGetLastError());
}
