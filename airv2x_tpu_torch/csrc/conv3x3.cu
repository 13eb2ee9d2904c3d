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
// 0. In f32 the three tf32 products below are 46.7 GFLOP, ~94 us at the
// TF32 tensor-core peak (the FMA units alone would need ~232 us).
//
// One implicit GEMM on Hopper's wgmma for both types, fed by TMA through
// rings of shared-memory slots (the shape of a fast Hopper GEMM):
//   * M = `maps` maps x a tile of tile_h x tile_w output pixels (64 to 384
//     rows, whole m64 blocks of one map each), N = block_n output channels
//     (64 or 128), K = 9 taps x Cin in chunks of one 128-byte row: 64 bf16
//     or 32 f32 channels.
//   * A: per (chunk, column shift dj) one TMA box of a 4-D tensor map over x
//     (C, W, H, B): {one row of channels, tile_w, tile_h + 2, maps} at
//     (x0 + dj - 1, y0 - 1), i.e. the tile's rows with one halo row above
//     and below. TMA fills what lies outside the map with zeros: the SAME
//     padding, and the channels past Cin. Each pixel's 128 bytes land in the
//     128-byte swizzle that wgmma reads K-major. The A tile of tap (di, dj)
//     is the box's window that starts di x tile_w pixels in; tile_w is a
//     multiple of 8, so the window starts on a 1024-byte swizzle atom and is
//     a valid operand as it lies. So the input is read three times per
//     chunk from L2 instead of nine, and no ldmatrix or unswizzled layout is
//     needed, which a full (tile_h + 2) x (tile_w + 2) halo would require:
//     its column shifts break the swizzle atom.
//   * B, bf16: per (chunk, tap) block_n / 64 boxes {64 outputs, 64 input
//     channels, 1 tap} of a 3-D tensor map over the HWIO weights (Cout,
//     Cin, 9), read MN-major by wgmma, so the weights need no transposed
//     copy. Rows past Cin and columns past Cout are TMA's zeros.
//   * Two rings with "full" / "empty" mbarriers: A (a_stages slots, one per
//     column shift) and B (b_stages slots, one per tap). One producer warp
//     (its lane 0) walks (map group, chunk, dj, di) and keeps loads in
//     flight; WG consumer warpgroups each own MR m64 blocks: per tap they
//     start 4 x MR wgmmas (32 bytes of K each) with f32 accumulators in
//     registers, keep that group in flight (wgmma.wait_group 1) and release
//     the slots the group before it read.
//   * The epilogue reads the accumulators straight from registers: f32
//     scale / bias / ReLU with _rn intrinsics, one rounding to the output
//     type, stores masked at the ragged edge (H = 25 and W = 88 at stage 2)
//     and past Cout: bf16x2 in bf16; in f32 neighbouring lanes swap half
//     their accumulators (one shuffle) so each stores 4 outputs of one pixel
//     with a 16-byte store.
//   * K4a puts the maps on the grid (one map per block). K4b (allmaps) is
//     one launch in which each block computes every map of its spatial tile:
//     `maps` of them side by side in M, sharing each weight load, and the
//     next group after this one's epilogue, with the rings running on.
//   * The tile plan (ops/conv3x3.py:conv3x3_plan) picks the instantiation
//     (CONV3X3_PLANS, CONV3X3_F32_PLANS), the tile, block_n and the ring
//     depths per shape from a time model (L2 bytes + shared-memory bytes +
//     tensor-core work), and mirrors the block -> tile mapping below; it is
//     tested on the CPU.
// f32 is 3xTF32 (the full-precision parity path): tf32 wgmma keeps only 10
// mantissa bits of each operand, so each operand v is split into
// big = tf32(v) and small = tf32(v - big) (cvt.rna, ties away from zero),
// and per k8 step the kernel runs A_small B_big + A_big B_small +
// A_big B_big into the same f32 accumulators: each product is kept to
// about 2^-21 relative. Both parts are rounded to tf32 here, so what the
// tensor cores do with the low 13 bits of an operand never matters.
//   * B: tf32 wgmma has no transposed operands, so B must be K-major. The
//     wrapper repacks the weights once per weight version to (2, Cout, 9,
//     Cin), big then small, Cin innermost; per (chunk, tap) a B slot holds
//     block_n / 64 big boxes {32 input channels, 1 tap, 64 outputs} and as
//     many small ones behind them.
//   * A: TMA loads x into the slot; once it has landed, the consumer
//     warpgroups round it to big in place and write small to the slot's
//     sister, then fence the generic-proxy stores for the async proxy
//     (fence.proxy.async) and meet at a named barrier of the consumers
//     only, before any wgmma reads either; the pair is released together.
//   * The sum: the tensor cores add each product into the f32 accumulator
//     without rounding to nearest (measured on an H100: the error grew with
//     K to 2.7e-4 at Cin = 256, a bias that the backbone's 16 layers carry
//     on). So each tap's 12 products go to a partial of their own (the
//     first with D ignored), and once the tap's group is done (wait_group
//     0; the slots are released then) the partial is added into the sum
//     with one f32 rounding to nearest: a run of 12 truncated additions,
//     of partials that are 1 / sqrt(9 Cin / 32) of the sum, instead of
//     27 Cin / 8 of them.
// What holds it back (measured, PERF.md): bf16 reaches about 35-46% of the
// bound at the flagship stages. Per tap, SS wgmma reads A and B from shared
// memory: at N = 64 (stage 0) that alone is the SM's whole shared-memory
// bandwidth at the tensor cores' peak, and every block pulls its A boxes
// three times and all its weights once per map from L2 (about 5.5 TB/s).
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

constexpr int kRowBytes = 128;  // one pixel (A) or one weight row (B)
constexpr int kBoxB = 64 * kRowBytes;  // one box of 64 weight rows
constexpr int kMaxStages = 16;

struct ConvArgs {
  int B, H, W, Cin, Cout;
  int tile_h, tile_w, tiles_x, ntn, maps, groups, a_stages, b_stages, relu;
  const float* scale;
  const float* bias;
  void* out;
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

#define WGMMA_ACC32                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])
#define WGMMA_ACC64                                                          \
  WGMMA_ACC32, "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),          \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),      \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),      \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),      \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),      \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),      \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define WGMMA_REGS32                                                         \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31"
#define WGMMA_REGS64                                                         \
  WGMMA_REGS32                                                               \
  ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, " \
  "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "   \
  "%60, %61, %62, %63"

// D[64 x N] += A[64 x K] (K-major, 128-byte swizzle) x B[K x N] with f32
// accumulators. bf16 (K = 16): B MN-major, as the HWIO weights lie. tf32
// (K = 8): B K-major (tf32 operands have no transpose).
template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t da,
                                      uint64_t db);

template <>
__device__ __forceinline__ void wgmma<64>(float (&d)[32], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WGMMA_REGS32
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : WGMMA_ACC32
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<128>(float (&d)[64], uint64_t da,
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WGMMA_REGS64
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : WGMMA_ACC64
      : "l"(da), "l"(db), "r"(1));
}

// tf32: D = A x B + (add ? D : 0).
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], uint64_t da,
                                           uint64_t db, int add);

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], uint64_t da,
                                               uint64_t db, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {" WGMMA_REGS32
      "}, %32, %33, p, 1, 1;\n}\n"
      : WGMMA_ACC32
      : "l"(da), "l"(db), "r"(add));
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64], uint64_t da,
                                                uint64_t db, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {" WGMMA_REGS64
      "}, %64, %65, p, 1, 1;\n}\n"
      : WGMMA_ACC64
      : "l"(da), "l"(db), "r"(add));
}

// v rounded to tf32 (10 mantissa bits; to nearest, ties away from zero),
// as f32 bits with the low 13 bits zero.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// Split the f32 A slot at `big` (`bytes` of it) into tf32 big, in place,
// and small = tf32(v - big) at `small`, shared by `threads` threads; then
// make the stores visible to wgmma's async proxy. The swizzle does not
// matter: each 16-byte piece stays where it lies.
__device__ __forceinline__ void split_tf32(uint32_t big, uint32_t small,
                                           int bytes, int tid, int threads) {
  for (int off = 16 * tid; off < bytes; off += 16 * threads) {
    float v[4];
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
                 : "r"(big + off));
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      hi[e] = tf32_rna(v[e]);
      lo[e] = tf32_rna(__fsub_rn(v[e], __uint_as_float(hi[e])));
    }
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(big + off),
                 "r"(hi[0]), "r"(hi[1]), "r"(hi[2]), "r"(hi[3])
                 : "memory");
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(small + off),
                 "r"(lo[0]), "r"(lo[1]), "r"(lo[2]), "r"(lo[3])
                 : "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
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
//   * A, a_stages slots: per (map group, chunk, column shift dj) one box of
//     `maps` x (tile_h + 2) x tile_w pixels, the tile's rows with the halo
//     row above and below, shifted by dj - 1 columns. The window of row
//     shift di starts di x tile_w pixels in: a multiple of 8 pixels (1024
//     bytes), so every tap's A tile is an aligned, swizzled K-major operand,
//     and the input is read 3 times per chunk, not 9. In f32 each slot is a
//     pair: the box (rounded to tf32 big in place) and its small sister.
//   * B, b_stages slots: per (group, chunk, tap) the block_n / 64 weight
//     boxes of that tap and chunk (f32: the big boxes, then the small).
// Then the mbarriers: a_full, a_empty, b_full, b_empty, one per slot.
template <bool F32, int WG, int MR, int BN>
__global__ void __launch_bounds__(WG * 128 + 32, 1)
    conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap wmap,
                         const ConvArgs a) {
  constexpr int kChunk = F32 ? 32 : 64;  // input channels per 128-byte row
  constexpr int kBytesB = BN * kRowBytes;  // one operand's B boxes
  constexpr int kParts = F32 ? 2 : 1;      // big and small in f32
  extern __shared__ unsigned char smem_raw[];
  const int pix = a.tile_h * a.tile_w;  // a multiple of 64
  const int bytes_a = a.maps * (a.tile_h + 2) * a.tile_w * kRowBytes;
  const uint32_t ring_a = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ring_b = ring_a + a.a_stages * kParts * bytes_a;
  const uint32_t a_full = ring_b + a.b_stages * kParts * kBytesB;
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
            tma_load_4d(ring_a + ra.slot * kParts * bytes_a, &xmap, fa, c0,
                        x0 + dj - 1, y0 - 1, bg);
            ra.next(a.a_stages);
            for (int di = 0; di < 3; ++di) {
              mbar_wait(b_empty + 8 * rb.slot, rb.phase ^ 1);
              const uint32_t fb = b_full + 8 * rb.slot;
              const uint32_t sb = ring_b + rb.slot * kParts * kBytesB;
              mbar_expect_tx(fb, kParts * kBytesB);
#pragma unroll
              for (int j = 0; j < BN / 64; ++j) {
                if constexpr (F32) {  // (2, Cout, 9, Cin): big, then small
                  tma_load_4d(sb + j * kBoxB, &wmap, fb, c0, 3 * di + dj,
                              n0 + 64 * j, 0);
                  tma_load_4d(sb + kBytesB + j * kBoxB, &wmap, fb, c0,
                              3 * di + dj, n0 + 64 * j, 1);
                } else {
                  tma_load_3d(sb + j * kBoxB, &wmap, fb, n0 + 64 * j, c0,
                              3 * di + dj);
                }
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
  // f32: the tap's products, summed by the tensor cores (F32 only)
  float tap[F32 ? MR : 1][F32 ? BN / 2 : 1];
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
        const uint32_t sa = ring_a + ra.slot * kParts * bytes_a;
        if constexpr (F32) {
          split_tf32(sa, sa + bytes_a, bytes_a, threadIdx.x, WG * 128);
          // every consumer's part of the pair is written and fenced
          asm volatile("bar.sync 1, %0;" ::"r"(WG * 128) : "memory");
        }
        for (int di = 0; di < 3; ++di) {
          mbar_wait(b_full + 8 * rb.slot, rb.phase);
          const uint32_t sb = ring_b + rb.slot * kParts * kBytesB;
          const uint32_t row = di * a.tile_w * kRowBytes;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            if constexpr (F32) {
              // A and B K-major: 8 channels = 32 bytes further along each
              // 128-byte row; 8-row swizzle atoms 1024 bytes apart.
              const uint64_t db_big = smem_desc(sb + 32 * kk, 16, 1024);
              const uint64_t db_small =
                  smem_desc(sb + kBytesB + 32 * kk, 16, 1024);
#pragma unroll
              for (int r = 0; r < MR; ++r) {
                const uint32_t pa = sa + off_a[r] + row + 32 * kk;
                const uint64_t da_big = smem_desc(pa, 16, 1024);
                const uint64_t da_small = smem_desc(pa + bytes_a, 16, 1024);
                wgmma_tf32<BN>(tap[r], da_small, db_big, kk > 0);
                wgmma_tf32<BN>(tap[r], da_big, db_small, 1);
                wgmma_tf32<BN>(tap[r], da_big, db_big, 1);
              }
            } else {
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
          }
          wgmma_commit();
          if constexpr (F32) {
            // the tap's partial, rounded once into the sum (see above)
            wgmma_wait<0>();
#pragma unroll
            for (int r = 0; r < MR; ++r) {
              fence_acc(tap[r]);
#pragma unroll
              for (int i = 0; i < BN / 2; ++i) {
                acc[r][i] = __fadd_rn(acc[r][i], tap[r][i]);
              }
            }
            mbar_arrive(b_empty + 8 * rb.slot);
            if (di == 2) mbar_arrive(a_empty + 8 * ra.slot);
          } else {
            wgmma_wait<1>();  // the previous step's products are done
            if (prev_b >= 0) mbar_arrive(b_empty + 8 * prev_b);
            if (prev_a >= 0) mbar_arrive(a_empty + 8 * prev_a);
            prev_b = rb.slot;
            prev_a = di == 2 ? ra.slot : -1;  // the A slot's last step
          }
          rb.next(a.b_stages);
        }
        ra.next(a.a_stages);
      }
    }
    if constexpr (!F32) {
      wgmma_wait<0>();
#pragma unroll
      for (int r = 0; r < MR; ++r) fence_acc(acc[r]);
      mbar_arrive(b_empty + 8 * prev_b);
      mbar_arrive(a_empty + 8 * prev_a);
    }

    // accumulator layout of m64nN: warp w holds rows 16w .. 16w + 15;
    // acc[4j + 2h + e] is row 16w + lane / 4 + 8h, column 8j + 2 (lane % 4) + e
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      if constexpr (F32) {
        // lanes 2k and 2k + 1 swap halves: the even lane takes row h = 0,
        // the odd one row h = 1, each 4 consecutive columns of it
        const int odd = lane & 1;
        const int m = (wg * MR + r) * 64 + warp * 16 + lane / 4 + 8 * odd;
        const int g = m / pix, p = m - g * pix;
        const int b = bg + g;
        const int gy = y0 + p / a.tile_w, gx = x0 + p % a.tile_w;
        const bool live = b < bend && gy < a.H && gx < a.W;
        float* orow = static_cast<float*>(a.out) +
                      ((static_cast<long long>(b) * a.H + gy) * a.W + gx) *
                          a.Cout;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const float* v = &acc[r][4 * j];  // v[2h + e]
          const float s0 = odd ? v[0] : v[2], s1 = odd ? v[1] : v[3];
          const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
          const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
          const int col = n0 + 8 * j + 4 * ((lane % 4) >> 1);
          if (live && col < a.Cout) {  // Cout % 8 == 0: all 4 or none
            const float4 sc = __ldg(reinterpret_cast<const float4*>(a.scale + col));
            const float4 bi = __ldg(reinterpret_cast<const float4*>(a.bias + col));
            float4 o;
            o.x = epilogue(odd ? r0 : v[0], sc.x, bi.x, a.relu);
            o.y = epilogue(odd ? r1 : v[1], sc.y, bi.y, a.relu);
            o.z = epilogue(odd ? v[2] : r0, sc.z, bi.z, a.relu);
            o.w = epilogue(odd ? v[3] : r1, sc.w, bi.w, a.relu);
            *reinterpret_cast<float4*>(orow + col) = o;
          }
        }
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = (wg * MR + r) * 64 + warp * 16 + lane / 4 + 8 * h;
          const int g = m / pix, p = m - g * pix;
          const int b = bg + g;
          const int gy = y0 + p / a.tile_w, gx = x0 + p % a.tile_w;
          if (b < bend && gy < a.H && gx < a.W) {
            bf16* orow = static_cast<bf16*>(a.out) +
                         ((static_cast<long long>(b) * a.H + gy) * a.W + gx) *
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
}

// A CUresult of the tensor-map encoder, returned past the CUDA runtime's
// error codes so that the wrapper can tell the two apart.
constexpr int kEncodeError = 10000;

int encode(CUtensorMap* map, CUtensorMapDataType type, const void* base,
           int rank, const cuuint64_t* dims, const cuuint64_t* strides,
           const cuuint32_t* box) {
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUresult r = cuTensorMapEncodeTiled(
      map, type, rank, const_cast<void*>(base), dims, strides, box, ones,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);  // out of bounds: zeros
  return r == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(r);
}

template <bool F32, int WG, int MR, int BN>
int launch(const CUtensorMap& xmap, const CUtensorMap& wmap,
           const ConvArgs& a, dim3 grid, cudaStream_t stream) {
  // raise the dynamic shared-memory limit once on each device (bit d)
  static unsigned long long attr_set = 0;
  auto* kernel = conv3x3_wgmma_kernel<F32, WG, MR, BN>;
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
  constexpr int parts = F32 ? 2 : 1;
  const int smem =
      parts * (a.a_stages * a.maps * (a.tile_h + 2) * a.tile_w * kRowBytes +
               a.b_stages * BN * kRowBytes) +
      16 * (a.a_stages + a.b_stages) + 1024;
  kernel<<<grid, WG * 128 + 32, smem, stream>>>(xmap, wmap, a);
  return static_cast<int>(cudaGetLastError());
}

// The instantiations: warpgroups x m64 blocks per warpgroup x block_n, the
// ones the tile plan picks (ops/conv3x3.py:KERNELS and F32_KERNELS).
#define CONV3X3_PLANS(X)                                            \
  X(1, 1, 64) X(1, 2, 64) X(2, 2, 64) X(2, 2, 128) X(3, 1, 64)       \
  X(3, 1, 128) X(3, 2, 64)

#define CONV3X3_F32_PLANS(X)                                        \
  X(1, 1, 64) X(1, 2, 64) X(2, 1, 128) X(2, 2, 64)

}  // namespace

// x (B, H, W, Cin) and out (B, H, W, Cout) NHWC in x's type; w in bf16 the
// HWIO weights (3, 3, Cin, Cout), in f32 the tf32 split (2, Cout, 9, Cin):
// big = tf32(w), small = tf32(w - big) (ops/conv3x3.py:tf32_split).
// tile_h, tile_w, maps, wgs, mr, block_n, a_stages and b_stages are the tile
// plan (ops/conv3x3.py:conv3x3_plan).
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
  if (tile_w < 8 || tile_w % 8 || tile_h < 1 || maps < 1 || tile_w > 256 ||
      tile_h > 254 || maps > 256 || tile_h * tile_w % 64 ||
      maps * tile_h * tile_w != wgs * mr * 64 || a_stages < 2 ||
      b_stages < 2 || a_stages > kMaxStages || b_stages > kMaxStages) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cuuint64_t item = is_bf16 ? 2 : 4;
  const cuuint32_t chunk = kRowBytes / item;  // channels per 128-byte row
  const CUtensorMapDataType type = is_bf16
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap xmap, wmap;
  const cuuint64_t xd[4] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H,
                            (cuuint64_t)B};
  const cuuint64_t xs[3] = {Cin * item, W * Cin * item, H * W * Cin * item};
  const cuuint32_t xb[4] = {chunk, (cuuint32_t)tile_w,
                            (cuuint32_t)tile_h + 2, (cuuint32_t)maps};
  int err = encode(&xmap, type, x, 4, xd, xs, xb);
  if (err) return err;
  if (is_bf16) {  // HWIO as (Cout, Cin, 9), innermost first
    const cuuint64_t wd[3] = {(cuuint64_t)Cout, (cuuint64_t)Cin, 9};
    const cuuint64_t ws[2] = {Cout * item, Cin * Cout * item};
    const cuuint32_t wb[3] = {64, chunk, 1};
    err = encode(&wmap, type, w, 3, wd, ws, wb);
  } else {  // (2, Cout, 9, Cin) as (Cin, 9, Cout, 2), innermost first
    const cuuint64_t wd[4] = {(cuuint64_t)Cin, 9, (cuuint64_t)Cout, 2};
    const cuuint64_t ws[3] = {Cin * item, 9 * Cin * item,
                              9 * Cin * Cout * item};
    const cuuint32_t wb[4] = {chunk, 1, 64, 1};
    err = encode(&wmap, type, w, 4, wd, ws, wb);
  }
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
  a.out = out;
  const int tiles = a.tiles_x * ((H + tile_h - 1) / tile_h);
  const dim3 grid(tiles * a.ntn, allmaps ? 1 : ngroups);
#define CONV3X3_LAUNCH(f32_, wg_, mr_, bn_)                                 \
  if (is_bf16 != f32_ && wgs == wg_ && mr == mr_ && block_n == bn_) {       \
    return launch<f32_, wg_, mr_, bn_>(xmap, wmap, a, grid, stream);        \
  }
#define CONV3X3_BF16(wg_, mr_, bn_) CONV3X3_LAUNCH(false, wg_, mr_, bn_)
#define CONV3X3_F32(wg_, mr_, bn_) CONV3X3_LAUNCH(true, wg_, mr_, bn_)
  CONV3X3_PLANS(CONV3X3_BF16)
  CONV3X3_F32_PLANS(CONV3X3_F32)
#undef CONV3X3_F32
#undef CONV3X3_BF16
#undef CONV3X3_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
