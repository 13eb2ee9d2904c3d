// Device helpers shared by the scatter kernels (pillar_encode.cu,
// pillar_reduce.cu). kernels.py hashes this header into every library's
// file name, so an edit here rebuilds each source.

#pragma once

#include <cuda_runtime.h>

namespace airv2x {

// Float atomicMax from the integer trick: for x >= 0 the float order is the
// signed-int order of the bits, for x < 0 the reversed unsigned order.
// -0.0 is folded to +0.0 first (its bits 0x80000000 would lose against any
// negative stored value). Stored values only grow, so a stale read that
// already wins makes the atomic unnecessary.
__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
  int bits = __float_as_int(v);
  if (bits == static_cast<int>(0x80000000u)) bits = 0;  // -0.0 -> +0.0
  v = __int_as_float(bits);
  if (*addr >= v) return;
  if (bits >= 0) {
    atomicMax(reinterpret_cast<int*>(addr), bits);
  } else {
    atomicMin(reinterpret_cast<unsigned int*>(addr),
              static_cast<unsigned int>(bits));
  }
}

// Blocks of `threads` for a grid-stride loop over `total` items, capped at
// ~64 blocks per SM of an H100 (132 SMs).
inline int grid_stride_blocks(long long total, int threads) {
  long long b = (total + threads - 1) / threads;
  const long long cap = 132LL * 64;
  return static_cast<int>(b < cap ? b : cap);
}

}  // namespace airv2x
