// The 64-row x 128-column bf16 tiles that the tensor-core flash kernels
// (flash_fwd.cu and flash_bwd.cu) stream from [B, S, heads, 128] arrays:
// their wgmma descriptors, their TMA load, the masks and the register hold
// that the register-A products need. Built on sm90.cuh.
//
// A tile is two 64-column halves, each 64 rows of 128 bytes in the
// 128-byte swizzle that TMA writes (sm90::bshd_map), 1024-byte aligned.
#pragma once

#include "sm90.cuh"

namespace tiles {

constexpr int HALF = 64 * 64 * 2;  // bytes of 64 rows x 64 bf16 columns
constexpr int TILE = 2 * HALF;     // a 64 x 128 bf16 tile
constexpr float LOG2E = 1.4426950408889634f;

// k-step kk (16 columns of 128) of a 64 x 128 tile read K-major
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk) {
  return sm90::desc_sw128(tile + (kk >> 2) * HALF + (kk & 3) * 32, 16, 1024);
}

// column half h, k-step kk (16 rows) of a 64 x 128 tile read MN-major
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int h, int kk) {
  return sm90::desc_sw128(tile + h * HALF + kk * 2048, HALF, 1024);
}

// rows s0 .. s0 + 63 of (b, head), both column halves
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* m,
                                          uint32_t bar, int head, int s0,
                                          int b) {
  sm90::tma_load_4d(dst, m, bar, 0, head, s0, b);
  sm90::tma_load_4d(dst + HALF, m, bar, 64, head, s0, b);
}

// the forward's mask: key kpos is visible to query qpos
__device__ __forceinline__ bool visible(int qpos, int kpos, int Sq, int Skv,
                                        int off, int causal, int window) {
  bool ok = kpos < Skv && qpos < Sq;
  if (causal) {
    ok = ok && kpos <= qpos + off;
    if (window > 0) ok = ok && kpos > qpos + off - window;
  }
  return ok;
}

// some pair of a q tile at q0 and a kv tile at k0 is masked
__device__ __forceinline__ bool edge_tile(int q0, int k0, int Sq, int Skv,
                                          int off, int causal, int window) {
  return q0 + 64 > Sq || k0 + 64 > Skv ||
         (causal && (k0 + 63 > q0 + off ||
                     (window > 0 && k0 <= q0 + 63 + off - window)));
}

// Hold A operands live, unchanged, until after the wait: a register-A
// wgmma reads them after the issuing instruction has retired, so they must
// not be reused for other values before then.
template <int N>
__device__ __forceinline__ void keep(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[i][r])::"memory");
}

}  // namespace tiles
