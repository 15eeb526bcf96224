// Coordinate-wise median over a replica stack for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel `_median_kernel` built by
// `median_pallas_call` (src/repro/kernels/cwise_median/kernel.py), with its
// bitonic network `_sorted_rows` / `bitonic_pairs` and the `_tile` contract
// of ops.py: rows padded to a power of two with _BIG = 3.4e38, NaN mapped
// to _BIG, so pads and NaN payloads sort last.
//
// What bounds it on the card: memory. Each column's n <= 64 values are read
// once and one value is written; the compare-exchange network is O(n log^2 n)
// min/max per column with no reuse across columns. What the design does
// about it: one thread per column, the column's values in registers (the
// network is unrolled at compile time for each power-of-two row count, so
// every index is static and nothing spills to local memory), and each
// row's load is one coalesced stream of consecutive columns across a warp.
// The _tile padding happens in registers, so no padded copy of the stack is
// ever written to device memory.
//
// The result: row n/2 for odd n (returned directly — the TPU kernel's
// 0.5 * (row + row) overflows to inf when that row is _BIG, while
// repro.agg.rules.median_stack, the serving read's reference, returns _BIG),
// and 0.5 * (row[n/2 - 1] + row[n/2]) for even n, as median_stack.
//
// Layout: x [n, d] float32 row-major, out [d] float32.

#include <cuda_runtime.h>

namespace {

constexpr float BIG = 3.4e38f;
constexpr int NT = 256;

template <int NP>
__global__ void __launch_bounds__(NT)
median_kernel(const float* __restrict__ x, float* __restrict__ out, int n,
              long long d) {
  const long long col = (long long)blockIdx.x * NT + threadIdx.x;
  if (col >= d) return;
  float r[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    float val = BIG;
    if (i < n) {
      val = x[(long long)i * d + col];
      if (isnan(val)) val = BIG;
    }
    r[i] = val;
  }
  // bitonic sorting network, ascending (kernel.py `bitonic_pairs`)
#pragma unroll
  for (int kk = 2; kk <= NP; kk <<= 1) {
#pragma unroll
    for (int j = kk >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const int p = i ^ j;
        if (p > i) {
          const float a = r[i], b = r[p];
          const float lo = fminf(a, b), hi = fmaxf(a, b);
          if ((i & kk) == 0) {
            r[i] = lo;
            r[p] = hi;
          } else {
            r[i] = hi;
            r[p] = lo;
          }
        }
      }
    }
  }
  const int lo_i = (n - 1) / 2, hi_i = n / 2;
  float a = 0.f, b = 0.f;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    if (i == lo_i) a = r[i];
    if (i == hi_i) b = r[i];
  }
  out[col] = (n & 1) ? b : 0.5f * (a + b);
}

template <int NP>
int launch(const float* x, float* out, int n, long long d, cudaStream_t s) {
  const long long blocks = (d + NT - 1) / NT;
  median_kernel<NP><<<(unsigned)blocks, NT, 0, s>>>(x, out, n, d);
  return (int)cudaGetLastError();
}

}  // namespace

// x [n, d] float32, 1 <= n <= 64. Returns cudaGetLastError() (0 = ok).
extern "C" int cwise_median_f32(const float* x, float* out, int n,
                                long long d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int np = 1;
  while (np < n) np <<= 1;
  switch (np) {
    case 1: return launch<1>(x, out, n, d, s);
    case 2: return launch<2>(x, out, n, d, s);
    case 4: return launch<4>(x, out, n, d, s);
    case 8: return launch<8>(x, out, n, d, s);
    case 16: return launch<16>(x, out, n, d, s);
    case 32: return launch<32>(x, out, n, d, s);
    case 64: return launch<64>(x, out, n, d, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
