// Exact MDA selection on Hopper (sm_90a), CUDA C++: the subset diameters,
// their first argmin and the averaging weights, in one launch.
//
// Replaces the Pallas TPU kernel `_diam_kernel` built by `diam_pallas_call`
// (src/repro/kernels/mda_diameter/kernel.py): for every size-(n-f) subset of
// the n inputs, the largest squared distance between two of its members,
// -3.4e38 for an empty subset, NaN propagating; and the selection the JAX
// package then makes from it (src/repro/agg/rules.py `mda_select_exact`):
// the first minimum in enumeration order, as jnp.argmin / torch.argmin take
// it (the first NaN wins; otherwise the lowest index among equal minima,
// -0.0 equal to +0.0), and weights sel / (n - f).
//
// What bounds it on the card: neither bytes nor operations at the training
// path's shapes — S = C(7, 5) = 21 subsets of n = 7 over a 7 x 7 matrix per
// receiver is a few hundred bytes and a few thousand compares — but the
// launch, and the launches a selection would add after it (argmin, the mask
// gather, the cast, the division, and a host-to-device copy of the mask
// table). What the design does about it: it takes that work in, so a
// selection is one launch. One block per receiver
// (blockIdx.x) stages max(d2[i][j], d2[j][i]) in shared memory, so a subset
// needs its members' upper triangle only; its threads (one a subset, in
// whole warps, up to 1024) stride over the subsets, each keeping its best
// (diameter, index); a fixed block reduction
// (warp shuffles, then one warp) on a total order — NaN first, then the
// value, then the index — picks the first minimum, and the block writes the
// receiver's weights. Deterministic, no scratch, no atomics. The subset
// masks arrive as uint64 bitmasks (n <= 64), built once per mask table on
// the host in itertools.combinations order and cached on the device. A max
// does not depend on its order, so the diameters are exact.
//
// Layout: d2 [B, n, n] float32, masks [S] uint64, diam [B, S] float32,
// weights [B, n] float32 (or null: diameters only).

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int MAX_NT = 1024;
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG = -3.4e38f;

// true when candidate a precedes b in argmin order
__device__ __forceinline__ bool precedes(float av, int ai, float bv, int bi) {
  const bool an = av != av, bn = bv != bv;
  if (an != bn) return an;
  if (!an && av != bv) return av < bv;
  return ai < bi;
}

__device__ __forceinline__ void warp_min(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(FULL, v, o);
    const int oi = __shfl_xor_sync(FULL, i, o);
    if (precedes(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

__global__ void __launch_bounds__(MAX_NT)
mda_select_kernel(const float* __restrict__ d2,
                  const unsigned long long* __restrict__ masks,
                  float* __restrict__ diam, float* __restrict__ weights,
                  int n, int S) {
  extern __shared__ float sym[];          // [n * n]
  __shared__ float warp_v[MAX_NT / 32];
  __shared__ int warp_i[MAX_NT / 32];
  __shared__ unsigned long long sel_mask;
  const int b = blockIdx.x, nt = blockDim.x;
  const float* src = d2 + (long long)b * n * n;
  // the first subset's mask is read beside the distances, each later one
  // an iteration ahead
  unsigned long long m_next = threadIdx.x < S ? masks[threadIdx.x] : 0ull;
  for (int e = threadIdx.x; e < n * n; e += nt) {
    const float u = src[e], v = src[(e % n) * n + e / n];
    sym[e] = (u > v || u != u) ? u : v;   // the larger; NaN, if either
  }
  __syncthreads();
  float best_v = __int_as_float(0x7f800000);   // +inf at index INT_MAX:
  int best_i = INT_MAX;                        // after every subset
  unsigned long long best_m = 0ull;
  for (int s = threadIdx.x; s < S; s += nt) {
    const unsigned long long m = m_next;
    if (s + nt < S) m_next = masks[s + nt];
    float dm = NEG;
    for (unsigned long long mi = m; mi; mi &= mi - 1) {
      const int i = __ffsll((long long)mi) - 1;
      const float* row = sym + i * n;
      // members j >= i: the diagonal and the upper triangle
      for (unsigned long long mj = m & (~0ull << i); mj; mj &= mj - 1) {
        const float v = row[__ffsll((long long)mj) - 1];
        if (v > dm || v != v) dm = v;     // NaN, once seen, stays
      }
    }
    diam[(long long)b * S + s] = dm;
    if (precedes(dm, s, best_v, best_i)) {
      best_v = dm;
      best_i = s;
      best_m = m;
    }
  }
  if (weights == nullptr) return;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int own_i = best_i;
  warp_min(best_v, best_i);
  if (lane == 0) {
    warp_v[warp] = best_v;
    warp_i[warp] = best_i;
  }
  __syncthreads();
  if (warp == 0) {
    best_v = lane < nt / 32 ? warp_v[lane] : __int_as_float(0x7f800000);
    best_i = lane < nt / 32 ? warp_i[lane] : INT_MAX;
    warp_min(best_v, best_i);
    if (lane == 0) warp_i[0] = best_i;
  }
  __syncthreads();
  // the thread whose own best is the block's holds its mask
  if (own_i == warp_i[0]) sel_mask = best_m;
  __syncthreads();
  const unsigned long long sel = sel_mask;
  const float w = 1.0f / (float)__popcll(sel);   // 1 / (n - f), IEEE
  for (int j = threadIdx.x; j < n; j += nt)
    weights[(long long)b * n + j] = ((sel >> j) & 1ull) ? w : 0.0f;
}

}  // namespace

// d2 [B, n, n] float32, 1 <= n <= 64, 1 <= B <= 65535; masks [S] uint64,
// S >= 1; weights may be null. Returns cudaGetLastError() (0 = ok).
extern "C" int mda_select_f32(const float* d2,
                              const unsigned long long* masks, float* diam,
                              float* weights, int B, int n, int S,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 1 || n > 64 || B < 1 || B > 65535 || S < 1)
    return (int)cudaErrorInvalidValue;
  // a thread per subset, in whole warps, up to MAX_NT
  const int nt = S >= MAX_NT ? MAX_NT : (S + 31) / 32 * 32;
  mda_select_kernel<<<B, nt, (size_t)n * n * sizeof(float), st>>>(
      d2, masks, diam, weights, n, S);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
